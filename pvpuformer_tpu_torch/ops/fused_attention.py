"""Attention forward, fused entry: kernel wrapper and plain version.

Counterpart of pvpuformer_tpu/ops/fused_attention.py (`fused_attention`,
TPU kernel `_fwd_kernel`). Per (b*h) slice: S = QK^T * scale in f32, a row
softmax in f32, P normalized THEN cast to the input dtype, O = P.V with f32
accumulation. The CUDA kernel is csrc/attention.cu (shared with the flash
entry, ops/attention.py). This is the port's attention on CUDA for every
`ViTConfig.attn_impl` other than "flash".
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from . import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _to_bhnd(x: torch.Tensor) -> torch.Tensor:
    """(..., N, H, D) -> contiguous (BH, N, D)."""
    *lead, n, h, d = x.shape
    return x.reshape(-1, n, h, d).transpose(1, 2).reshape(-1, n, d).contiguous()


def _from_bhnd(x: torch.Tensor, lead: Tuple[int, ...], h: int) -> torch.Tensor:
    bh, n, d = x.shape
    return x.reshape(bh // h, h, n, d).transpose(1, 2).reshape(*lead, n, h, d)


def launch_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float, flash: bool) -> torch.Tensor:
    """Launch csrc/attention.cu on CUDA (..., N, H, D) tensors."""
    if not (q.shape == k.shape == v.shape):
        raise ValueError(f"attention: q/k/v shapes differ: {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise TypeError(f"attention: float32 or bfloat16 q/k/v required, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("attention: q/k/v on different devices")
    *lead, n, h, d = q.shape
    if d % 16 or not 16 <= d <= 128:
        raise ValueError(f"attention kernel: head dim {d} must be a multiple "
                         f"of 16 in [16, 128], shape {tuple(q.shape)}")
    qf, kf, vf = _to_bhnd(q), _to_bhnd(k), _to_bhnd(v)
    out = torch.empty_like(qf)
    lib = _build.library()
    _build.check(lib.pvpu_attention_fwd(
        qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), out.data_ptr(),
        qf.shape[0], n, d, float(scale), _DTYPE_CODE[q.dtype], int(flash),
        _build.stream_of(qf)), "attention_fwd")
    return _from_bhnd(out, tuple(lead), h)


def fused_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float) -> torch.Tensor:
    """The `_fwd_kernel` math over (..., N, H, D)."""
    *lead, n, h, d = q.shape
    qf, kf, vf = _to_bhnd(q), _to_bhnd(k), _to_bhnd(v)
    s = (qf.float() @ kf.float().transpose(1, 2)) * scale
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = (e / e.sum(-1, keepdim=True)).to(q.dtype)
    o = (p.float() @ vf.float()).to(q.dtype)
    return _from_bhnd(o, tuple(lead), h)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Attention over (..., N, H, Dh). A CPU tensor takes the plain version;
    a CUDA tensor launches the kernel (head dim a multiple of 16, <= 128,
    else ValueError)."""
    s = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    if q.device.type != "cuda":
        return fused_attention_plain(q, k, v, s)
    out = launch_attention(q, k, v, s, flash=False)
    fused_attention.launches += 1
    return out


fused_attention.launches = 0
