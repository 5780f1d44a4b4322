"""Fused LayerNorm + MLP + residual: kernel wrapper and plain version.

Counterpart of pvpuformer_tpu/ops/fused_mlp.py (`fused_ln_mlp`, TPU kernel
`_kernel`): out = x + fc2(gelu(fc1(LN(x)))) with f32 LN statistics and f32
bias / GELU math. The kernel (csrc/fused_mlp.cu, two launches) serves bf16
only, with tanh GELU, as on the TPU. An f32 input takes the plain ops with
exact-erf GELU: that is the JAX function's own contract by dtype
(fused_mlp.py:132-138), a semantic route and not a failure fallback.

`fused_ln_mlp` is a `torch.autograd.Function`. Its backward is autograd
through a recompute of the plain version, as `_fused_bwd` (fused_mlp.py:
102-107): the recompute rounds where `_xla_ref` rounds (y and h in the input
dtype, products of those values accumulated in f32), so bf16 gradients get
JAX's rounding points.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build

_SMEM_LIMIT = 232448          # H100 shared memory per block, bytes


def fused_ln_mlp_plain(x2d: torch.Tensor, gamma, beta, w1, b1, w2, b2,
                       eps: float) -> torch.Tensor:
    """The `_xla_ref` math (fused_mlp.py:55-63); GELU is tanh iff bf16."""
    xf = x2d.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps) * gamma.float()
         + beta.float()).to(x2d.dtype)
    h = y.float() @ w1.to(x2d.dtype).float() + b1.float()
    approx = "tanh" if x2d.dtype == torch.bfloat16 else "none"
    h = F.gelu(h, approximate=approx).to(x2d.dtype)
    o = h.float() @ w2.to(x2d.dtype).float() + b2.float()
    return (o + xf).to(x2d.dtype)


def _launch(x2d, gamma, beta, w1, b1, w2, b2, eps: float) -> torch.Tensor:
    m, d = x2d.shape
    hidden = w1.shape[1]
    if w1.shape != (d, hidden) or w2.shape != (hidden, d):
        raise ValueError(f"fused_ln_mlp: weight shapes {tuple(w1.shape)}, "
                         f"{tuple(w2.shape)} do not fit x {tuple(x2d.shape)}")
    smem = 2 * (64 * d + 32 * 128) + 4 * 64 * 128
    if d % 128 or hidden % 128 or smem > _SMEM_LIMIT:
        raise ValueError(f"fused_ln_mlp kernel: D={d}, hidden={hidden} must be "
                         f"multiples of 128 with D <= 1496 (shared memory)")
    x = x2d.contiguous()
    w1 = w1.to(torch.bfloat16).contiguous()
    w2 = w2.to(torch.bfloat16).contiguous()
    vecs = [t.float().contiguous() for t in (gamma, beta, b1, b2)]
    h = torch.empty((m, hidden), dtype=torch.bfloat16, device=x.device)
    out = torch.empty_like(x)
    lib = _build.library()
    stream = _build.stream_of(x)
    _build.check(lib.pvpu_ln_fc1_gelu(
        x.data_ptr(), vecs[0].data_ptr(), vecs[1].data_ptr(), w1.data_ptr(),
        vecs[2].data_ptr(), h.data_ptr(), m, d, hidden, float(eps), stream),
        "ln_fc1_gelu")
    _build.check(lib.pvpu_fc2_residual(
        h.data_ptr(), w2.data_ptr(), vecs[3].data_ptr(), x.data_ptr(),
        out.data_ptr(), m, d, hidden, stream), "fc2_residual")
    return out


class _FusedLnMlp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2d, gamma, beta, w1, b1, w2, b2, eps: float):
        ctx.eps = eps
        ctx.save_for_backward(x2d, gamma, beta, w1, b1, w2, b2)
        if x2d.dtype != torch.bfloat16 or x2d.device.type != "cuda":
            return fused_ln_mlp_plain(x2d, gamma, beta, w1, b1, w2, b2, eps)
        out = _launch(x2d, gamma, beta, w1, b1, w2, b2, eps)
        fused_ln_mlp.launches += 1
        return out

    @staticmethod
    def backward(ctx, g):
        need = ctx.needs_input_grad[:7]
        res = [x.detach().requires_grad_(n)
               for x, n in zip(ctx.saved_tensors, need)]
        with torch.enable_grad():
            out = fused_ln_mlp_plain(*res, ctx.eps)
        got = iter(torch.autograd.grad(
            out, [x for x, n in zip(res, need) if n], g))
        if g.is_cuda and g.dtype == torch.bfloat16:
            fused_ln_mlp.bwd_launches += 1
        return (*(next(got) if n else None for n in need), None)


def fused_ln_mlp(x: torch.Tensor, ln, mlp, eps: float = 1e-6) -> torch.Tensor:
    """x (..., D) -> x + mlp(layer_norm(x)), differentiable. `ln` has
    scale/bias, `mlp` has fc1/fc2 with (in, out) weights. bf16 on CUDA
    launches the kernel; bf16 on the CPU, and f32 anywhere, take the plain
    version. The backward recomputes through the plain version."""
    d = x.shape[-1]
    out = _FusedLnMlp.apply(x.reshape(-1, d), ln.scale, ln.bias, mlp.fc1.w,
                            mlp.fc1.b, mlp.fc2.w, mlp.fc2.b, eps)
    return out.reshape(x.shape)


fused_ln_mlp.launches = 0        # forward kernel calls (two launches each)
fused_ln_mlp.bwd_launches = 0    # bf16 CUDA backward recomputes (plain ops)
