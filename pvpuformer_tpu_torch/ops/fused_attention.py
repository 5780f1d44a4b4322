"""Attention, fused entry: kernel wrappers, plain versions and autograd.

Counterpart of pvpuformer_tpu/ops/fused_attention.py (`fused_attention`,
TPU kernels `_fwd_kernel` and `_bwd_kernel`).

Forward, per (b*h) slice: S = QK^T * scale in f32, a row softmax in f32, P
normalized THEN cast to the input dtype, O = P.V with f32 accumulation.
Backward (the `_bwd_kernel` math): S and p32 recomputed from q and k,
dv = p^T.dO, dp = dO.v^T in f32, ds = p32 * (dp - sum_k p32*dp) cast to the
input dtype, dq = ds.k*scale and dk = ds^T.q*scale. The CUDA kernels are
csrc/attention.cu (forward, shared with the flash entry, ops/attention.py)
and csrc/attention_bwd.cu (backward).

`fused_attention` is a `torch.autograd.Function`: a CPU tensor takes the
plain forward and backward, a CUDA tensor the kernels. Like `_vjp_fwd`, it
saves q, k, v as the residuals (on CUDA in the kernels' (BH, N, D) layout)
and recomputes the scores in the backward. This is the port's attention on
CUDA for every `ViTConfig.attn_impl` other than "flash".
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


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """The kernels' envelope; raises on what they do not take."""
    if not (q.shape == k.shape == v.shape):
        raise ValueError(f"attention: q/k/v shapes differ: {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise TypeError(f"attention: float32 or bfloat16 q/k/v required, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("attention: q/k/v on different devices")
    d = q.shape[-1]
    if d % 16 or not 16 <= d <= 128:
        raise ValueError(f"attention kernel: head dim {d} must be a multiple "
                         f"of 16 in [16, 128], shape {tuple(q.shape)}")


def _kernel_fwd(qf: torch.Tensor, kf: torch.Tensor, vf: torch.Tensor,
                scale: float, flash: bool) -> torch.Tensor:
    """csrc/attention.cu on contiguous (BH, N, D) CUDA tensors."""
    bh, n, d = qf.shape
    out = torch.empty_like(qf)
    _build.check(_build.library().pvpu_attention_fwd(
        qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), out.data_ptr(),
        bh, n, d, float(scale), _DTYPE_CODE[qf.dtype], int(flash),
        _build.stream_of(qf)), "attention_fwd")
    return out


def _kernel_bwd(qf, kf, vf, gf, scale: float):
    """csrc/attention_bwd.cu on contiguous (BH, N, D) CUDA tensors: two
    launches (query side, key side) through an f32 (BH, N, 3) scratch of
    per-row (max, sum, srow). Counted in `fused_attention.bwd_launches`."""
    bh, n, d = qf.shape
    dq, dk, dv = (torch.empty_like(qf) for _ in range(3))
    stats = torch.empty((bh, n, 3), dtype=torch.float32, device=qf.device)
    _build.check(_build.library().pvpu_attention_bwd(
        qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), gf.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
        bh, n, d, float(scale), _DTYPE_CODE[qf.dtype], _build.stream_of(qf)),
        "attention_bwd")
    fused_attention.bwd_launches += 1
    return dq, dk, dv


def launch_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float, flash: bool) -> torch.Tensor:
    """Launch csrc/attention.cu on CUDA (..., N, H, D) tensors."""
    _check(q, k, v)
    *lead, n, h, d = q.shape
    out = _kernel_fwd(_to_bhnd(q), _to_bhnd(k), _to_bhnd(v), scale, flash)
    return _from_bhnd(out, tuple(lead), h)


def launch_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         g: torch.Tensor, scale: float):
    """Launch csrc/attention_bwd.cu on CUDA (..., N, H, D) tensors; returns
    (dq, dk, dv) in that layout."""
    _check(q, k, v)
    if g.shape != q.shape or g.dtype != q.dtype:
        raise ValueError(f"attention backward: dO {tuple(g.shape)} {g.dtype} "
                         f"does not match q {tuple(q.shape)} {q.dtype}")
    *lead, n, h, d = q.shape
    grads = _kernel_bwd(_to_bhnd(q), _to_bhnd(k), _to_bhnd(v), _to_bhnd(g),
                        scale)
    return tuple(_from_bhnd(x, tuple(lead), h) for x in grads)


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


def fused_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, do: torch.Tensor, scale: float):
    """The `_bwd_kernel` math over (..., N, H, D), step by step; returns
    (dq, dk, dv) in the input dtype."""
    *lead, n, h, d = q.shape
    dt = q.dtype
    qf, kf, vf, gf = (_to_bhnd(x).float() for x in (q, k, v, do))
    s = (qf @ kf.transpose(1, 2)) * scale
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p32 = e / e.sum(-1, keepdim=True)
    p = p32.to(dt)
    dv = (p.float().transpose(1, 2) @ gf).to(dt)
    dp = gf @ vf.transpose(1, 2)
    srow = (p32 * dp).sum(-1, keepdim=True)
    ds = (p32 * (dp - srow)).to(dt).float()
    dq = ((ds @ kf) * scale).to(dt)
    dk = ((ds.transpose(1, 2) @ qf) * scale).to(dt)
    return tuple(_from_bhnd(x, tuple(lead), h) for x in (dq, dk, dv))


class _FusedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale: float):
        ctx.scale = scale
        if q.device.type != "cuda":
            ctx.save_for_backward(q, k, v)
            ctx.layout = None
            return fused_attention_plain(q, k, v, scale)
        _check(q, k, v)
        *lead, n, h, d = q.shape
        qf, kf, vf = _to_bhnd(q), _to_bhnd(k), _to_bhnd(v)
        out = _kernel_fwd(qf, kf, vf, scale, flash=False)
        fused_attention.launches += 1
        ctx.save_for_backward(qf, kf, vf)
        ctx.layout = (tuple(lead), h)
        return _from_bhnd(out, tuple(lead), h)

    @staticmethod
    def backward(ctx, g):
        res = ctx.saved_tensors
        if ctx.layout is None:
            return (*fused_attention_bwd_plain(*res, g, ctx.scale), None)
        lead, h = ctx.layout
        gf = _to_bhnd(g.to(res[0].dtype))
        grads = _kernel_bwd(*res, gf, ctx.scale)
        return (*(_from_bhnd(x, lead, h) for x in grads), None)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Attention over (..., N, H, Dh), differentiable. A CPU tensor takes the
    plain versions; a CUDA tensor launches the kernels, forward and backward
    (head dim a multiple of 16, <= 128, else ValueError)."""
    s = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    return _FusedAttention.apply(q, k, v, s)


fused_attention.launches = 0        # forward kernel launches
fused_attention.bwd_launches = 0    # backward kernel calls (two launches each)
