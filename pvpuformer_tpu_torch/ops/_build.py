"""Build the package's CUDA kernels with nvcc and load them with ctypes.

`library()` compiles every `csrc/*.cu` into one shared library with a plain C
interface, on first use, into `build/kernels/<hash>/` at the repository root
(listed in .gitignore): one nvcc per source, all started together, then one
link. The hash covers the sources and the flags, so an edited source builds
anew and an unchanged one loads the cached library.
Each C entry point launches on the stream it is given and returns
`cudaGetLastError()`; `check` raises when that is not 0.
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

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


class Ten(ctypes.Structure):
    """csrc/attention_tiles.cuh `Ten`, passed by value: a strided
    (B, N, H, D) tensor, element (b, n, h, d) at ptr + b*sb + n*sn + h*sh + d
    (strides in elements)."""
    _fields_ = [("ptr", ctypes.c_void_p), ("sb", ctypes.c_longlong),
                ("sn", ctypes.c_longlong), ("sh", ctypes.c_longlong)]


# C entry point -> argument types; every function returns cudaError_t (int)
SIGNATURES = {
    "pvpu_attention_fwd": [Ten] * 4 + [_P, _I, _I, _I, _I, _F, _I, _I, _P],
    "pvpu_attention_bwd": [Ten] * 7 + [_P, _P, _I, _I, _I, _I, _F, _I, _P],
    "pvpu_minplus_rows": [_P, _P, _I, _I, _P],
    "pvpu_ln_fc1_gelu": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
    "pvpu_fc2_residual": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    "pvpu_fc2_partial": [_P, _P, _P, _I, _I, _I, _P],
    "pvpu_cc_barriers": [],
    "pvpu_cc_labels": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "pvpu_component_max": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
}


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), "/usr/local/cuda/bin/nvcc",
                 shutil.which("nvcc")):
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set NVCC or install /usr/local/cuda)")


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def build() -> Path:
    """Compile csrc/ (if not cached) and return the library path."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    lib = out_dir / "libpvpu_kernels.so"
    if lib.is_file():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=out_dir))   # private to this builder
    try:
        srcs = sorted(CSRC.glob("*.cu"))
        objs = [str(work / (src.stem + ".o")) for src in srcs]
        cmds = [[_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", obj,
                 str(src)] for src, obj in zip(srcs, objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in cmds]                # all compile at once
        runs = [(cmd, p.communicate()[0], p.returncode)
                for cmd, p in zip(cmds, procs)]
        tmp = str(work / lib.name)
        if all(rc == 0 for _, _, rc in runs):
            link = [_nvcc(), *ARCH_FLAGS, "-shared", "-o", tmp, *objs]
            p = subprocess.run(link, stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True)
            runs.append((link, p.stdout, p.returncode))
        (out_dir / "nvcc.log").write_text(
            "\n".join(f"$ {' '.join(cmd)}\n{out}" for cmd, out, _ in runs))
        for cmd, out, rc in runs:
            if rc != 0:
                raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n"
                                   f"{out[-4000:]}")
        os.replace(tmp, lib)               # atomic: concurrent builders agree
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


def stream_of(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
