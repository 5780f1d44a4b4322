"""Host-side click distance maps in C++ behind ctypes
(pvpuformer_tpu/native, itself the reference's one compiled component,
`isegm/utils/cython/_get_dist_maps.pyx:17-63`).

`get_dist_maps(points, height, width, norm_delimiter)` runs
`dist_maps.cc`: a 4-neighbour BFS from every click that relaxes each
layer's normalized squared distance, a frontier pixel keeping its parent's
origin click. `get_dist_maps_numpy` is the same BFS in Python (slow; the
tests' oracle, and what a caller who wants no compiled code calls). Both
take a distance in double and round it to f32 once, the comparison too in
f32 (NumPy 2's rule for the JAX function's `out[...] > nd`, written out so
that every NumPy gives it): they agree bit for bit with each other and with
the JAX package's numpy BFS. The JAX package's C++ keeps f32 arithmetic,
which a -march=native build contracts into FMAs: where a delimiter makes
the distances inexact (5) it parts from its own numpy BFS by an ulp.

The library is built with `g++ -O3 -shared -fPIC -ffp-contract=off` at the
first call, into `build/native/<hash>/` at the repository root (listed in
.gitignore), the hash covering the source and the flags, as ops/_build.py
does for the CUDA kernels; importing the package builds nothing. A failed build raises: the
JAX package's silent fallback to numpy and its PVPUFORMER_NO_NATIVE switch
are not carried over.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "dist_maps.cc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "native"
FLAGS = ["-O3", "-shared", "-fPIC", "-ffp-contract=off"]


def build() -> Path:
    """Compile dist_maps.cc (if not cached) and return the library path;
    raises with g++'s output when the build fails."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SOURCE.read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    lib = out_dir / "libpvpu_dist_maps.so"
    if lib.is_file():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=out_dir))   # private to this process
    try:
        tmp = work / lib.name
        cmd = [os.environ.get("CXX", "g++"), *FLAGS, str(SOURCE), "-o",
               str(tmp)]
        try:
            p = subprocess.run(cmd, stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True,
                               timeout=120)
        except (OSError, subprocess.SubprocessError) as e:
            raise RuntimeError(f"building {SOURCE.name} failed: "
                               f"{' '.join(cmd)}: {e}") from e
        if p.returncode != 0:
            raise RuntimeError(f"building {SOURCE.name} failed "
                               f"({p.returncode}): {' '.join(cmd)}\n"
                               f"{p.stdout[-4000:]}")
        os.replace(tmp, lib)               # atomic: concurrent builds agree
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.get_dist_maps.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.POINTER(ctypes.c_float)]
    lib.get_dist_maps.restype = None
    return lib


def get_dist_maps_numpy(points: np.ndarray, height: int, width: int,
                        norm_delimiter: float) -> np.ndarray:
    """The BFS in Python with the C++ kernel's semantics."""
    out = np.full((2, height, width), 1e6, np.float32)
    queue = []
    n = len(points)
    for i, p in enumerate(points):
        x, y = int(round(p[0])), int(round(p[1]))
        if x < 0 or y < 0 or x >= height or y >= width:
            continue
        layer = 1 if i >= n / 2 else 0
        queue.append((x, y, layer, x, y))
        out[layer, x, y] = 0.0
    head = 0
    while head < len(queue):
        x0, y0, layer, ox, oy = queue[head]
        head += 1
        for dx, dy in ((-1, 0), (0, -1), (0, 1), (1, 0)):
            x, y = x0 + dx, y0 + dy
            if not (0 <= x < height and 0 <= y < width):
                continue
            nd = np.float32(((x - ox) / norm_delimiter) ** 2
                            + ((y - oy) / norm_delimiter) ** 2)
            if out[layer, x, y] > nd:
                out[layer, x, y] = nd
                queue.append((x, y, layer, ox, oy))
    return out


def get_dist_maps(points: np.ndarray, height: int, width: int,
                  norm_delimiter: float = 1.0) -> np.ndarray:
    """(2N, >=2) clicks of (row, col), the first half positive, rows with a
    negative row index padding -> (2, H, W) f32 normalized squared-distance
    maps (_get_dist_maps.pyx:17's signature)."""
    points = np.ascontiguousarray(points, np.float32)
    if points.ndim != 2:
        points = points.reshape(-1, points.shape[-1])
    if points.shape[1] < 2 or height < 0 or width < 0:
        raise ValueError(f"get_dist_maps: points {points.shape} need (row, "
                         f"col) columns, canvas {height} x {width}")
    out = np.empty((2, height, width), np.float32)
    library().get_dist_maps(
        points.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        points.shape[0], points.shape[1], height, width,
        ctypes.c_float(norm_delimiter),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out
