"""EDT min-plus row pass: kernel wrapper and plain version.

Counterpart of pvpuformer_tpu/ops/edt_pallas.py (`minplus_rows`). The CUDA
kernel (csrc/edt_minplus.cu) stages rows of f in shared memory, so W is
bounded by MAX_W; a wider input raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build

MAX_W = 8192          # csrc/edt_minplus.cu: ROWS x MAX_W f32 of shared memory
_BIG = 3.4e38


def minplus_rows_plain(f: torch.Tensor, chunk: Optional[int] = 32
                       ) -> torch.Tensor:
    """(..., W) f32 -> D[..., c] = min_c' f[..., c'] + (c - c')^2, as a
    broadcast-min over `chunk` output columns at a time (None: all of W)."""
    w = f.shape[-1]
    chunk = w if chunk is None else chunk
    cols = torch.arange(w, dtype=torch.float32, device=f.device)
    outs = []
    for c0 in range(0, w, chunk):
        c_out = cols[c0:c0 + chunk]
        off = (c_out[:, None] - cols[None, :]).square()            # (C, W)
        outs.append((f[..., None, :] + off).amin(-1))
    return torch.cat(outs, -1)


def minplus_rows(f: torch.Tensor, chunk: Optional[int] = 32) -> torch.Tensor:
    """(..., H, W) f32 -> per-row min-plus with the squared-offset kernel.

    A CPU tensor takes the plain version (`chunk` sizes its blocks); a CUDA
    tensor launches the kernel, whose result is bit-identical (exact
    integer-valued f32)."""
    if f.device.type != "cuda":
        return minplus_rows_plain(f, chunk)
    if f.dtype != torch.float32:
        raise TypeError(f"minplus_rows: float32 input required, got {f.dtype}")
    w = f.shape[-1]
    if not 0 < w <= MAX_W:
        raise ValueError(f"minplus_rows: W={w} outside the kernel's (0, "
                         f"{MAX_W}] shared-memory tile, shape {tuple(f.shape)}")
    x = f.contiguous()
    out = torch.empty_like(x)
    rows = x.numel() // w
    lib = _build.library()
    _build.check(lib.pvpu_minplus_rows(x.data_ptr(), out.data_ptr(), rows, w,
                                       _build.stream_of(x)),
                 "minplus_rows")
    minplus_rows.launches += 1
    return out


minplus_rows.launches = 0
