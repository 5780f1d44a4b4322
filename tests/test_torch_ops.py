"""Port ops vs the JAX package on identical numpy inputs: nn primitives (f32
and bf16), resize / zoom-in crop and paste-back, disk maps, PPuE click
encoding, the exact EDT (both pass-1 forms, vs JAX and cv2) and the oracle
next click.

Tolerances: f32 1e-5 (same ops, different summation order); bf16 compared
after casting to f32 at 2e-2 relative + absolute (one bf16 rounding, 2^-8,
may fall either side in each of two chained ops); EDT and click positions
exact (integer-valued f32)."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvpuformer_tpu import nn as jnn
from pvpuformer_tpu.ops import edt as jedt
from pvpuformer_tpu.ops.distmaps import dist_maps as jdist_maps
from pvpuformer_tpu.ops.ppue import PPuEConfig as JPPuEConfig
from pvpuformer_tpu.ops.ppue import ppue_click as jppue_click
from pvpuformer_tpu.ops.resize import (bilinear_resize as jbilinear,
                                       roi_crop_resize as jcrop,
                                       roi_paste_back as jpaste)
from pvpuformer_tpu_torch import nn
from pvpuformer_tpu_torch.ops import edt
from pvpuformer_tpu_torch.ops.distmaps import dist_maps
from pvpuformer_tpu_torch.ops.ppue import PPuEConfig, ppue_click
from pvpuformer_tpu_torch.ops.resize import (bilinear_resize, roi_crop_resize,
                                             roi_paste_back)

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _both(tree, dtype):
    """numpy tree -> (JAX dict tree, port attribute tree) in `dtype`."""
    jdt, tdt, _ = DTYPES[dtype]
    if isinstance(tree, dict):
        pairs = {k: _both(v, dtype) for k, v in tree.items()}
        return ({k: a for k, (a, _) in pairs.items()},
                types.SimpleNamespace(**{"b": None, **{
                    k: b for k, (_, b) in pairs.items()}}))
    a = np.asarray(tree, np.float32)
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol, rtol=tol)


R = np.random.default_rng(0)
LIN = {"w": R.normal(0, 0.2, (24, 40)), "b": R.normal(0, 0.2, 40)}
MLP = {"fc1": LIN, "fc2": {"w": R.normal(0, 0.2, (40, 24)),
                           "b": R.normal(0, 0.2, 24)}}
NORM = {"scale": R.normal(1, 0.1, 24), "bias": R.normal(0, 0.1, 24)}
CONV2 = {"w": R.normal(0, 0.2, (2, 2, 24, 16)), "b": R.normal(0, 0.2, 16)}
CONV3 = {"w": R.normal(0, 0.2, (3, 3, 24, 16)), "b": R.normal(0, 0.2, 16)}
CONV1 = {"w": R.normal(0, 0.2, (1, 1, 24, 16)), "b": R.normal(0, 0.2, 16)}
DECONV = {"w": R.normal(0, 0.2, (24, 2, 2, 16)), "b": R.normal(0, 0.2, 16)}
PATCH = {"w": R.normal(0, 0.2, (4 * 4 * 3, 24)), "b": R.normal(0, 0.2, 24)}
X_TOK = R.normal(size=(2, 7, 24))
X_MAP = R.normal(size=(2, 6, 8, 24))
X_IMG = R.normal(size=(2, 8, 12, 3))

PRIMITIVES = {
    "linear": (lambda m, p, x: m.linear(p, x), LIN, X_TOK),
    "mlp": (lambda m, p, x: m.mlp(p, x), MLP, X_TOK),
    "gelu": (lambda m, p, x: m.gelu(x), None, X_TOK),
    "layer_norm": (lambda m, p, x: m.layer_norm(p, x, 1e-6), NORM, X_TOK),
    "layer_norm_nof32": (lambda m, p, x: m.layer_norm(p, x, 1e-6, f32=False),
                         NORM, X_TOK),
    "group_norm1": (lambda m, p, x: m.group_norm1(p, x), NORM, X_MAP),
    "conv2d_s2_valid": (lambda m, p, x: m.conv2d(p, x, stride=2,
                                                 padding="VALID"), CONV2, X_MAP),
    "conv2d_k3_torch": (lambda m, p, x: m.conv2d(p, x), CONV3, X_MAP),
    "conv1x1": (lambda m, p, x: m.conv1x1(p, x), CONV1, X_MAP),
    "deconv2x2": (lambda m, p, x: m.deconv2x2(p, x), DECONV, X_MAP),
    "patch_embed": (lambda m, p, x: m.patch_embed(p, x, (4, 4)), PATCH, X_IMG),
}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(PRIMITIVES))
def test_nn_primitive_matches_jax(name, dtype):
    fn, params, x = PRIMITIVES[name]
    jdt, tdt, tol = DTYPES[dtype]
    jp, tp = _both(params, dtype) if params is not None else (None, None)
    if name in ("layer_norm", "group_norm1"):      # f32 affine, as in JAX
        jp, tp = _both(params, "float32")
    with jax.default_matmul_precision("highest"):
        want = fn(jnn, jp, jnp.asarray(x, jdt))
    got = fn(nn, tp, torch.from_numpy(np.asarray(x, np.float32)).to(tdt))
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    _close(got, want, tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", [(2, 52, 3, 16), (2, 2, 49, 2, 8)])
def test_sdpa_matches_jax(shape, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    q, k, v = (R.normal(size=shape).astype(np.float32) for _ in range(3))
    with jax.default_matmul_precision("highest"):
        want = jnn.sdpa(*(jnp.asarray(a, jdt) for a in (q, k, v)))
    got = nn.sdpa(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)))
    _close(got, want, tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("shapes", [((7, 9), (14, 18)), ((28, 28), (112, 112)),
                                    ((13, 5), (7, 11)), ((1, 6), (4, 1))])
def test_bilinear_resize_matches_jax(shapes, align, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    (h, w), (oh, ow) = shapes
    x = np.random.default_rng(4).normal(size=(2, h, w, 3)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = jbilinear(jnp.asarray(x, jdt), oh, ow, align_corners=align)
    got = bilinear_resize(torch.from_numpy(x).to(tdt), oh, ow,
                          align_corners=align)
    _close(got, want, tol)


def _random_roi(r, h, w):
    r0, r1 = sorted(r.integers(0, h, 2))
    c0, c1 = sorted(r.integers(0, w, 2))
    return np.array([r0, r1, c0, c1], np.int32)


@pytest.mark.parametrize("seed", range(4))
def test_roi_crop_and_paste_back_match_jax(seed):
    r = np.random.default_rng(seed)
    img = r.normal(size=(1, 60, 80, 4)).astype(np.float32)
    probs = r.random((2, 32, 32, 1)).astype(np.float32)
    roi = _random_roi(r, 60, 80)
    jroi = tuple(jnp.int32(v) for v in roi)
    troi = torch.from_numpy(roi)
    _close(roi_crop_resize(torch.from_numpy(img), troi, 48, 40),
           jcrop(jnp.asarray(img), jroi, 48, 40), 1e-5)
    _close(roi_paste_back(torch.from_numpy(probs), troi, 70, 90),
           jpaste(jnp.asarray(probs), jroi, 70, 90), 1e-5)


def _points(r, n, hw, n_valid):
    pts = np.full((2, 2 * n, 3), -1.0, np.float32)
    for b in range(2):
        for i in range(n_valid):
            slot = i // 2 if i % 2 == 0 else n + i // 2
            pts[b, slot] = [r.uniform(-5, hw[0] + 5), r.uniform(-5, hw[1] + 5),
                            i]
    return pts


@pytest.mark.parametrize("use_disks", [True, False])
def test_dist_maps_match_jax(use_disks):
    pts = _points(np.random.default_rng(1), 4, (40, 56), 5)
    want = jdist_maps(jnp.asarray(pts), 40, 56, norm_radius=5.0,
                      use_disks=use_disks)
    got = dist_maps(torch.from_numpy(pts), 40, 56, norm_radius=5.0,
                    use_disks=use_disks)
    _close(got, want, 1e-6)


@pytest.mark.parametrize("nmax", [None, 6])
def test_ppue_click_matches_jax(nmax):
    """Clicks inside, on the edge of and outside the 64^2 crop."""
    pts = _points(np.random.default_rng(2), 4, (64, 64), 6)
    pts[0, 0, :2] = [0.0, 63.0]
    want = jppue_click(jnp.asarray(pts), JPPuEConfig(input_h=64, input_w=64),
                       num_max_points=nmax)
    got = ppue_click(torch.from_numpy(pts), PPuEConfig(input_h=64, input_w=64),
                     num_max_points=nmax)
    assert tuple(got.shape) == want.shape
    _close(got, want, 1e-6)


def _cv2_edt(mask):
    import cv2
    return np.square(cv2.distanceTransform(
        np.pad(mask.astype(np.uint8), 1), cv2.DIST_L2, 0)[1:-1, 1:-1])


@pytest.mark.parametrize("rows", ["scan", "dense"])
@pytest.mark.parametrize("shape", [(37, 53), (64, 64), (16, 200)])
def test_squared_edt_matches_jax_and_cv2(shape, rows):
    r = np.random.default_rng(11)
    m = r.uniform(size=shape) > 0.3
    want = np.asarray(jedt.squared_edt(jnp.asarray(m), rows=rows))
    got = edt.squared_edt(torch.from_numpy(m), rows=rows).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, _cv2_edt(m), rtol=1e-5)
    fp = ~m
    fp[: shape[0] // 2] = False
    d_fn, d_fp = edt.squared_edt_pair(torch.from_numpy(m), torch.from_numpy(fp),
                                      chunk=None, rows=rows)
    np.testing.assert_array_equal(d_fn.numpy(), want)
    np.testing.assert_array_equal(
        d_fp.numpy(), np.asarray(jedt.squared_edt(jnp.asarray(fp))))


def test_col_dist_matches_jax():
    m = np.random.default_rng(3).uniform(size=(33, 21)) > 0.4
    m[:, 0] = True                                   # an all-ones column
    np.testing.assert_array_equal(edt._col_dist(torch.from_numpy(m)).numpy(),
                                  np.asarray(jedt._col_dist(jnp.asarray(m))))


TIE_CASES = {
    # two equal squares: the tie is broken to the first in row-major order
    "twin_blobs": lambda m: (m.__setitem__((slice(4, 10), slice(4, 10)), True),
                             m.__setitem__((slice(4, 10), slice(20, 26)), True)),
    # a full-width band: every pixel of its middle row is a maximum
    "band": lambda m: m.__setitem__((slice(10, 15), slice(None)), True),
    # empty error masks: every distance is 0, the click goes to (0, 0)
    "empty": lambda m: None,
}


@pytest.mark.parametrize("case", sorted(TIE_CASES))
def test_next_click_tie_breaks_first_row_major(case):
    fn = np.zeros((30, 32), bool)
    TIE_CASES[case](fn)
    fp = np.zeros_like(fn)
    fp[25:28, 2:5] = True
    nc = np.ones_like(fn)
    nc[7, 7] = False                                 # an already-clicked pixel
    want = jedt.next_click_from_error(jnp.asarray(fn), jnp.asarray(fp),
                                      jnp.asarray(nc))
    got = edt.next_click_from_error(torch.from_numpy(fn), torch.from_numpy(fp),
                                    torch.from_numpy(nc))
    assert [bool(got[0]), int(got[1]), int(got[2]), float(got[3])] == \
        [bool(want[0]), int(want[1]), int(want[2]), float(want[3])]
    d = _cv2_edt(fn) * nc
    if d.max() > _cv2_edt(fp).max():
        ys, xs = np.where(d == d.max())
        assert (int(got[1]), int(got[2])) == (ys[0], xs[0])
