"""Fused LayerNorm + MLP + residual: kernel wrapper, plain version, backward.

Counterpart of pvpuformer_tpu/ops/fused_mlp.py (`fused_ln_mlp`, TPU kernel
`_kernel`): out = x + fc2(gelu(fc1(LN(x)))) with f32 LN statistics and f32
bias / GELU math. The kernel (csrc/fused_mlp.cu, two launches) serves bf16
only, with tanh GELU, as on the TPU. An f32 input takes the plain ops with
exact-erf GELU: that is the JAX function's own contract by dtype
(fused_mlp.py:132-138), a semantic route and not a failure fallback.

`fused_ln_mlp` is a `torch.autograd.Function`. The JAX backward (`_fused_bwd`,
fused_mlp.py:102-107) is `jax.vjp` of the XLA reference `_xla_ref`, not a
kernel. For bf16 the port writes that VJP out (`fused_ln_mlp_bwd`), rounding
where JAX's jaxpr rounds, with every product on bf16 operands and an f32
result (on the card cuBLAS's bf16 tensor-core products, `aten::mm.dtype`);
f32 inputs keep autograd through a recompute of the plain version.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build

_SMEM_LIMIT = 232448          # H100 shared memory per block, bytes
# csrc/fused_mlp.cu launch (a) at its widest: two 4-stage rings of 8 KB W1
# tiles, the block's 64 LayerNorm rows resident as bf16 (128 * D bytes),
# alignment and barriers
_SMEM_FIXED = 2 * 4 * 8192 + 1024 + 256


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


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of bf16 matrices as f32: on the card one tensor-core product
    with an f32 result; on the CPU the f32 product of the same values, which
    is the same sum (a product of two bf16 values is exact in f32)."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def split_bf16(a32: torch.Tensor):
    """An f32 tensor as hi + lo, both bf16: hi = bf16(a32), lo =
    bf16(a32 - hi); |a32 - hi - lo| <= 2**-17 |a32| (two bf16 roundings).
    `a32` is overwritten with a32 - hi."""
    hi = a32.to(torch.bfloat16)
    lo = a32.sub_(hi).to(torch.bfloat16)
    return hi, lo


def fused_ln_mlp_bwd(x2d, gamma, beta, w1, b1, w2, b2, eps: float, g):
    """The VJP of `_xla_ref` for bf16 x2d: (dx, dgamma, dbeta, dw1, db1, dw2,
    db2), each in its input's dtype. The rounding points of JAX's jaxpr:
    y, h, dh, dy and the weight gradients rounded to bf16; LayerNorm,
    GELU and the bias sums in f32. The products whose operand is a true f32
    value (dh_pre) take it as hi + lo (`split_bf16`): two bf16 products
    summed in f32, within 2**-17 of the f32 product, far below the bf16
    rounding of the result."""
    bf = torch.bfloat16
    w1b, w2b = w1.to(bf), w2.to(bf)
    xf = x2d.float()
    mean = xf.mean(-1, keepdim=True)
    xc = xf - mean
    rstd = torch.rsqrt(xc.square().mean(-1, keepdim=True) + eps)
    xhat = xc.mul_(rstd)
    del xc, xf
    gam = gamma.float()
    y = (xhat * gam + beta.float()).to(bf)
    h_pre = mm_f32(y, w1b).add_(b1.float())
    h = F.gelu(h_pre, approximate="tanh").to(bf)
    gb = g.to(bf)
    dw2 = mm_f32(h.t(), gb).to(bf)
    del h
    db2 = gb.sum(0, dtype=torch.float32)
    dh = mm_f32(gb, w2b.t())
    dh.copy_(dh.to(bf))                       # dh rounds to bf16, as h did
    dh_pre = torch.ops.aten.gelu_backward(dh, h_pre, approximate="tanh")
    del dh, h_pre
    db1 = dh_pre.sum(0)
    hi, lo = split_bf16(dh_pre)
    del dh_pre
    dy = mm_f32(hi, w1b.t()).add_(mm_f32(lo, w1b.t())).to(bf)
    dw1 = mm_f32(y.t(), hi).add_(mm_f32(y.t(), lo)).to(bf)
    del hi, lo, y
    dyf = dy.float()
    dgamma = (dyf * xhat).sum(0)
    dbeta = dyf.sum(0)
    dxhat = dyf.mul_(gam)
    dx = rstd * (dxhat - dxhat.mean(-1, keepdim=True)
                 - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    dx = dx.add_(gb.float()).to(x2d.dtype)
    return (dx, dgamma.to(gamma.dtype), dbeta.to(beta.dtype),
            dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype),
            db2.to(b2.dtype))


def _launch(x2d, gamma, beta, w1, b1, w2, b2, eps: float) -> torch.Tensor:
    m, d = x2d.shape
    hidden = w1.shape[1]
    vec_shapes = [tuple(t.shape) for t in (gamma, beta, b1, b2)]
    if (w1.shape != (d, hidden) or w2.shape != (hidden, d)
            or vec_shapes != [(d,), (d,), (hidden,), (d,)]):
        raise ValueError(f"fused_ln_mlp: weight shapes {tuple(w1.shape)}, "
                         f"{tuple(w2.shape)}, vectors {vec_shapes} do not "
                         f"fit x {tuple(x2d.shape)}")
    if d % 128 or hidden % 128 or _SMEM_FIXED + 128 * d > _SMEM_LIMIT:
        raise ValueError(f"fused_ln_mlp kernel: D={d}, hidden={hidden} must be "
                         f"multiples of 128 with D <= 1280 (shared memory)")
    x = x2d.contiguous()
    if x.data_ptr() % 16:                   # the kernel reads 16-byte rows
        x = x.clone()
    out = torch.empty_like(x)
    w1 = w1.to(torch.bfloat16).contiguous()
    w2 = w2.to(torch.bfloat16).contiguous()
    vecs = [t.float().contiguous() for t in (gamma, beta, b1, b2)]
    h = torch.empty((m, hidden), dtype=torch.bfloat16, device=x.device)
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
        saved = ctx.saved_tensors
        if saved[0].dtype == torch.bfloat16:
            got = fused_ln_mlp_bwd(*saved, ctx.eps, g)
            if g.is_cuda:
                fused_ln_mlp.bwd_launches += 1
            return (*(t if n else None for t, n in zip(got, need)), None)
        res = [x.detach().requires_grad_(n) for x, n in zip(saved, need)]
        with torch.enable_grad():
            out = fused_ln_mlp_plain(*res, ctx.eps)
        got = iter(torch.autograd.grad(
            out, [x for x, n in zip(res, need) if n], g))
        return (*(next(got) if n else None for n in need), None)


def fused_ln_mlp(x: torch.Tensor, ln, mlp, eps: float = 1e-6) -> torch.Tensor:
    """x (..., D) -> x + mlp(layer_norm(x)), differentiable. `ln` has
    scale/bias, `mlp` has fc1/fc2 with (in, out) weights. bf16 on CUDA
    launches the kernel; bf16 on the CPU, and f32 anywhere, take the plain
    version. The bf16 backward is `fused_ln_mlp_bwd`; the f32 backward
    recomputes through the plain version."""
    d = x.shape[-1]
    out = _FusedLnMlp.apply(x.reshape(-1, d), ln.scale, ln.bias, mlp.fc1.w,
                            mlp.fc1.b, mlp.fc2.w, mlp.fc2.b, eps)
    return out.reshape(x.shape)


fused_ln_mlp.launches = 0        # forward kernel calls (two launches each)
fused_ln_mlp.bwd_launches = 0    # bf16 CUDA backward calls (cuBLAS products)
