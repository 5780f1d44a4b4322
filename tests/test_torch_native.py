"""The port's host-side click distance maps (pvpuformer_tpu_torch/native:
its C++ BFS behind ctypes and its numpy twin) against the JAX package's
(pvpuformer_tpu/native), bit for bit.

Both of the port's functions equal JAX's numpy BFS at every delimiter. JAX's
C++ keeps f32 arithmetic (contracted into FMAs by its -march=native build),
so it equals the rest only where the distances are exact (delimiters 1 and
2); at 5 it parts from its own numpy BFS, and from the port, by an ulp, and
where an ulp changes which click a pixel's BFS reaches first, by more.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from pvpuformer_tpu import native as jnative
from pvpuformer_tpu_torch import native

REPO = Path(__file__).resolve().parents[1]


def _clicks(seed, n, h, w, k, off_canvas=0):
    """(2n, 3) clicks, k of them set (row, col, order), the rest padding
    rows of -1; `off_canvas` of the set ones outside the canvas."""
    r = np.random.default_rng(seed)
    pts = np.full((2 * n, 3), -1.0, np.float32)
    for j, i in enumerate(r.choice(2 * n, size=k, replace=False)):
        if j < off_canvas:
            pts[i, :2] = (r.choice([-2, h + 1]), r.integers(0, w))
        else:
            pts[i, :2] = (r.integers(0, h), r.integers(0, w))
        pts[i, 2] = j
    return pts


CASES = [  # (seed, n, h, w, k, off_canvas)
    (0, 6, 40, 52, 5, 0), (1, 6, 40, 52, 12, 0), (2, 3, 17, 9, 3, 1),
    (3, 12, 97, 61, 9, 2), (4, 5, 64, 64, 1, 0), (5, 24, 128, 96, 24, 3)]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("delimiter", [1.0, 2.0, 5.0])
def test_port_equals_jax_numpy_bfs_bit_for_bit(case, delimiter):
    seed, n, h, w, k, off = case
    pts = _clicks(seed, n, h, w, k, off)
    want = jnative.get_dist_maps_numpy(pts, h, w, delimiter)
    got = native.get_dist_maps(pts, h, w, delimiter)
    assert got.dtype == np.float32 and got.shape == (2, h, w)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        native.get_dist_maps_numpy(pts, h, w, delimiter), want)
    jc = jnative.get_dist_maps(pts, h, w, delimiter)
    if delimiter in (1.0, 2.0):
        np.testing.assert_array_equal(got, jc)
    else:       # where the port parts from JAX's C++, so does JAX's numpy
        parted = got != jc
        assert (jc[parted] != want[parted]).all()


def test_odd_click_counts_split_layers_as_jax():
    """An odd number of rows: rows i >= n / 2 are negative (layer 1)."""
    pts = np.full((5, 3), -1.0, np.float32)
    pts[1, :2] = (3, 4)                     # 1 < 2.5: positive
    pts[3, :2] = (10, 2)                    # 3 >= 2.5: negative
    got = native.get_dist_maps(pts, 16, 12, 1.0)
    np.testing.assert_array_equal(
        got, jnative.get_dist_maps_numpy(pts, 16, 12, 1.0))
    assert got[0, 3, 4] == 0.0 and got[1, 10, 2] == 0.0
    assert got[1, 3, 4] > 0 and got[0, 10, 2] > 0


def test_padding_and_off_canvas_only_give_the_far_field():
    pts = np.full((6, 3), -1.0, np.float32)
    pts[0, :2] = (-3, 4)
    pts[4, :2] = (2, 30)
    got = native.get_dist_maps(pts, 8, 8)
    assert (got == 1e6).all()
    np.testing.assert_array_equal(got,
                                  jnative.get_dist_maps_numpy(pts, 8, 8, 1.0))


def test_the_library_builds_under_build_and_import_builds_nothing(tmp_path):
    """`build()` puts the .so under the repository's build/native/<hash>/
    (nothing beside the source), and a fresh interpreter that imports the
    package compiles nothing: its library is built at the first call."""
    lib = native.build()
    assert lib.is_file() and lib.suffix == ".so"
    assert lib.parent.parent == REPO / "build" / "native"
    assert not list((REPO / "pvpuformer_tpu_torch" / "native").glob("*.so"))
    code = ("import subprocess\n"
            "calls = []\n"
            "real = subprocess.run\n"
            "subprocess.run = lambda *a, **k: calls.append(a) or real(*a, **k)\n"
            "import pvpuformer_tpu_torch.native as n\n"
            "assert not calls, calls\n"
            "assert n.library.cache_info().currsize == 0\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=tmp_path,
                   env={"PYTHONPATH": str(REPO)}, timeout=120)


def test_a_failed_build_raises(tmp_path, monkeypatch):
    """No silent numpy fallback: a compiler that fails raises."""
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "b")
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="dist_maps.cc"):
        native.build()
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="dist_maps.cc"):
        native.build()
