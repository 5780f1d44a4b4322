"""Attention, fused entry: kernel wrappers, plain versions and autograd.

Counterpart of pvpuformer_tpu/ops/fused_attention.py (`fused_attention`,
TPU kernels `_fwd_kernel` and `_bwd_kernel`).

Forward, per (b*h) slice: S = QK^T * scale in f32, a row softmax in f32, P
normalized THEN cast to the input dtype, O = P.V with f32 accumulation; the
row statistics m = max(S*scale) and l = sum exp(S*scale - m), (BH, N, 2) in
f32, are the backward's residual. Backward (the `_bwd_kernel` math): p32 =
exp(S*scale - m) / l from q, k and the statistics, dv = p^T.dO, dp = dO.v^T
in f32, ds = p32 * (dp - sum_k p32*dp) cast to the input dtype, dq =
ds.k*scale and dk = ds^T.q*scale. The CUDA kernels are csrc/attention.cu
(forward, shared with the flash entry, ops/attention.py) and
csrc/attention_bwd.cu (backward).

The kernels read q, k, v (and dO) as strided (..., N, H, D) views, so the
`qkv[:, :, i]` slices of models/vit.py go in without a copy, and write
contiguous (..., N, H, D) outputs. A tensor whose last dimension is not
unit-stride, whose lead dimensions do not collapse to one stride or whose
rows are not 16-byte aligned is first made contiguous: a layout step, not a
fallback.

`fused_attention` is a `torch.autograd.Function`: a CPU tensor takes the
plain forward and backward, a CUDA tensor the kernels. Like `_vjp_fwd`, it
saves q, k, v (the views the kernel read) and, beside them, the forward's
row statistics, and recomputes the scores in the backward. The forward
writes the statistics only when an input needs a gradient. This is the
port's attention on CUDA for every `ViTConfig.attn_impl` other than "flash".
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from . import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_BH = 65535          # the kernels' grid.y is one (b*h) slice each


def _to_bhnd(x: torch.Tensor) -> torch.Tensor:
    """(..., N, H, D) -> contiguous (BH, N, D), for the plain versions."""
    *lead, n, h, d = x.shape
    return x.reshape(-1, n, h, d).transpose(1, 2).reshape(-1, n, d).contiguous()


def _from_bhnd(x: torch.Tensor, lead: Tuple[int, ...], h: int) -> torch.Tensor:
    bh, n, d = x.shape
    return x.reshape(bh // h, h, n, d).transpose(1, 2).reshape(*lead, n, h, d)


def bnhd_strides(x: torch.Tensor) -> Optional[Tuple[int, int, int]]:
    """The batch, row and head strides (elements) under which the kernels
    address a (..., N, H, D) tensor in place: element (b, n, h, d), b the
    flat index over the lead dimensions, at x.data_ptr() + (b*sb + n*sn +
    h*sh + d) * itemsize. None where they cannot: the last dimension not
    unit-stride, the lead dimensions not one stride, or a row not 16-byte
    aligned (the kernels' cp.async and vector loads)."""
    *lead, n, h, d = x.shape
    st = x.stride()
    if d > 1 and st[-1] != 1:
        return None
    sn = st[-3] if n > 1 else 0      # a size-1 dimension's stride is unused
    sh = st[-2] if h > 1 else 0
    sb, span = 0, None               # lead dims, innermost first
    for size, stride in zip(reversed(lead), reversed(st[:len(lead)])):
        if size == 1:
            continue
        if span is None:
            sb = stride
        elif stride != span:
            return None
        span = stride * size
    align = 16 // x.element_size()
    if x.data_ptr() % 16 or any(s % align for s in (sb, sn, sh)):
        return None
    return sb, sn, sh


def _ten(x: torch.Tensor):
    """(the kernels' `Ten` for x, the tensor it points into): x itself where
    its strides allow, else a contiguous copy (keep it alive until the
    launch is enqueued)."""
    st = bnhd_strides(x)
    if st is None:
        x = x.clone(memory_format=torch.contiguous_format)
        st = bnhd_strides(x)
    return _build.Ten(x.data_ptr(), *st), x


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
    if math.prod(q.shape[:-3]) * q.shape[-2] > _MAX_BH:
        raise ValueError(f"attention kernel: more than {_MAX_BH} (batch, "
                         f"head) slices, shape {tuple(q.shape)}")


def _kernel_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                scale: float, flash: bool, stats: bool):
    """csrc/attention.cu on CUDA (..., N, H, D) tensors. Returns (out, the
    (BH, N, 2) f32 statistics or None, the q, k, v the kernel read)."""
    *lead, n, h, d = q.shape
    batch = math.prod(lead)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    st = (torch.empty((batch * h, n, 2), dtype=torch.float32, device=q.device)
          if stats else None)
    args = [_ten(x) for x in (q, k, v, out)]
    _build.check(_build.library().pvpu_attention_fwd(
        *(a for a, _ in args), None if st is None else st.data_ptr(),
        batch, h, n, d, float(scale), _DTYPE_CODE[q.dtype], int(flash),
        _build.stream_of(q)), "attention_fwd")
    return out, st, tuple(x for _, x in args[:3])


def _kernel_bwd(q, k, v, g, stats: torch.Tensor, scale: float):
    """csrc/attention_bwd.cu on CUDA (..., N, H, D) tensors and the
    forward's statistics: two launches (query side, key side) through an
    f32 (BH, N, 4) scratch of row terms. Counted in
    `fused_attention.bwd_launches`."""
    *lead, n, h, d = q.shape
    batch = math.prod(lead)
    if stats.shape != (batch * h, n, 2) or stats.dtype != torch.float32 \
            or not stats.is_contiguous():
        raise ValueError(f"attention backward: statistics {tuple(stats.shape)}"
                         f" {stats.dtype}, want contiguous ({batch * h}, {n}, "
                         f"2) float32")
    grads = [torch.empty(q.shape, dtype=q.dtype, device=q.device)
             for _ in range(3)]
    rows = torch.empty((batch * h, n, 4), dtype=torch.float32, device=q.device)
    args = [_ten(x) for x in (q, k, v, g, *grads)]
    _build.check(_build.library().pvpu_attention_bwd(
        *(a for a, _ in args), stats.data_ptr(), rows.data_ptr(), batch, h, n,
        d, float(scale), _DTYPE_CODE[q.dtype], _build.stream_of(q)),
        "attention_bwd")
    fused_attention.bwd_launches += 1
    return tuple(grads)


def launch_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float, flash: bool) -> torch.Tensor:
    """Launch csrc/attention.cu on CUDA (..., N, H, D) tensors (no
    statistics); returns a contiguous (..., N, H, D) tensor."""
    _check(q, k, v)
    return _kernel_fwd(q, k, v, scale, flash, stats=False)[0]


def launch_attention_stats(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           scale: float):
    """The fused entry on CUDA (..., N, H, D) tensors with its statistics
    write, as the training path runs it: (out, (BH, N, 2) f32 (m, l))."""
    _check(q, k, v)
    out, st, _ = _kernel_fwd(q, k, v, scale, flash=False, stats=True)
    fused_attention.launches += 1
    return out, st


def launch_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         g: torch.Tensor, scale: float,
                         stats: Optional[torch.Tensor] = None):
    """Launch csrc/attention_bwd.cu on CUDA (..., N, H, D) tensors; returns
    (dq, dk, dv), contiguous in that layout. Without `stats` the fused
    forward kernel computes them first (one more forward launch)."""
    _check(q, k, v)
    if g.shape != q.shape or g.dtype != q.dtype:
        raise ValueError(f"attention backward: dO {tuple(g.shape)} {g.dtype} "
                         f"does not match q {tuple(q.shape)} {q.dtype}")
    if stats is None:
        stats = launch_attention_stats(q, k, v, scale)[1]
    return _kernel_bwd(q, k, v, g, stats, scale)


def fused_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float, return_stats: bool = False):
    """The `_fwd_kernel` math over (..., N, H, D); with `return_stats`
    also the (BH, N, 2) f32 row statistics (m, l) the kernel writes."""
    *lead, n, h, d = q.shape
    qf, kf, vf = _to_bhnd(q), _to_bhnd(k), _to_bhnd(v)
    s = (qf.float() @ kf.float().transpose(1, 2)) * scale
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(-1, keepdim=True)
    p = (e / l).to(q.dtype)
    o = _from_bhnd((p.float() @ vf.float()).to(q.dtype), tuple(lead), h)
    return (o, torch.cat([m, l], -1)) if return_stats else o


def fused_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, do: torch.Tensor, scale: float,
                              stats: Optional[torch.Tensor] = None):
    """The `_bwd_kernel` math over (..., N, H, D), step by step; returns
    (dq, dk, dv) in the input dtype. p32 comes from the forward's (BH, N, 2)
    statistics where given, else from the scores' own max and sum (the same
    values: exp(s - m) / l is e / sum e)."""
    *lead, n, h, d = q.shape
    dt = q.dtype
    qf, kf, vf, gf = (_to_bhnd(x).float() for x in (q, k, v, do))
    s = (qf @ kf.transpose(1, 2)) * scale
    if stats is None:
        e = torch.exp(s - s.amax(-1, keepdim=True))
        p32 = e / e.sum(-1, keepdim=True)
    else:
        p32 = torch.exp(s - stats[..., :1]) / stats[..., 1:]
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
            out, stats = fused_attention_plain(q, k, v, scale,
                                               return_stats=True)
            ctx.save_for_backward(q, k, v, stats)
            return out
        _check(q, k, v)
        need = any(ctx.needs_input_grad[:3])
        out, stats, used = _kernel_fwd(q, k, v, scale, flash=False,
                                       stats=need)
        fused_attention.launches += 1
        if need:
            ctx.save_for_backward(*used, stats)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, stats = ctx.saved_tensors
        g = g.to(q.dtype)
        if q.device.type != "cuda":
            return (*fused_attention_bwd_plain(q, k, v, g, ctx.scale, stats),
                    None)
        return (*_kernel_bwd(q, k, v, g, stats, ctx.scale), None)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Attention over (..., N, H, Dh), differentiable. A CPU tensor takes the
    plain versions; a CUDA tensor launches the kernels, forward and backward
    (head dim a multiple of 16, <= 128, else ValueError)."""
    s = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    return _FusedAttention.apply(q, k, v, s)


fused_attention.launches = 0        # forward kernel launches
fused_attention.bwd_launches = 0    # backward kernel calls (two launches each)
