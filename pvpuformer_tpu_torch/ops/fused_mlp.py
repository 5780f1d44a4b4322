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

Under tensor parallelism (`fused_ln_mlp_tp`) each rank holds its columns of
fc1 and rows of fc2: launch (a) runs unchanged on the local hidden width and
launch (b') (`launch_fc2_partial`, the same fc2 main loop, `fc2_partial_plain`
its plain version) writes the f32 partial sum, which is all-reduced before
fc2's bias, the residual and the one rounding.
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


def _ln_plain(x2d, gamma, beta, eps: float):
    xf = x2d.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps) * gamma.float()
            + beta.float()).to(x2d.dtype)


def _fc1_gelu_plain(y, w1, b1):
    h = y.float() @ w1.to(y.dtype).float() + b1.float()
    approx = "tanh" if y.dtype == torch.bfloat16 else "none"
    return F.gelu(h, approximate=approx).to(y.dtype)


def fc2_partial_plain(h: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """Launch (b')'s function: h @ w2 in f32 (no bias, no residual, no
    rounding)."""
    return h.float() @ w2.to(h.dtype).float()


def fused_ln_mlp_plain(x2d: torch.Tensor, gamma, beta, w1, b1, w2, b2,
                       eps: float) -> torch.Tensor:
    """The `_xla_ref` math (fused_mlp.py:55-63); GELU is tanh iff bf16."""
    h = _fc1_gelu_plain(_ln_plain(x2d, gamma, beta, eps), w1, b1)
    o = fc2_partial_plain(h, w2) + b2.float()
    return (o + x2d.float()).to(x2d.dtype)


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


def _ln_stats(x2d, eps: float):
    """(xhat, rstd) of the LayerNorm in f32."""
    xf = x2d.float()
    mean = xf.mean(-1, keepdim=True)
    xc = xf - mean
    rstd = torch.rsqrt(xc.square().mean(-1, keepdim=True) + eps)
    return xc.mul_(rstd), rstd


def fused_ln_mlp_bwd_local(y, w1, b1, w2, g):
    """The MLP part of the bf16 VJP, on y = LN(x) in bf16 and the weights
    this rank holds: (dy32, dw1, db1, dw2), dy32 the f32 gradient of y
    before its bf16 rounding (under tensor parallelism a partial sum, to be
    reduced over the model ranks first), the weight gradients in bf16, db1
    in f32. The products whose operand is a true f32 value (dh_pre) take it
    as hi + lo (`split_bf16`): two bf16 products summed in f32, within
    2**-17 of the f32 product, far below the bf16 rounding of the result."""
    bf = torch.bfloat16
    w1b, w2b = w1.to(bf), w2.to(bf)
    h_pre = mm_f32(y, w1b).add_(b1.float())
    h = F.gelu(h_pre, approximate="tanh").to(bf)
    gb = g.to(bf)
    dw2 = mm_f32(h.t(), gb).to(bf)
    del h
    dh = mm_f32(gb, w2b.t())
    dh.copy_(dh.to(bf))                       # dh rounds to bf16, as h did
    dh_pre = torch.ops.aten.gelu_backward(dh, h_pre, approximate="tanh")
    del dh, h_pre
    db1 = dh_pre.sum(0)
    hi, lo = split_bf16(dh_pre)
    del dh_pre
    dy32 = mm_f32(hi, w1b.t()).add_(mm_f32(lo, w1b.t()))
    dw1 = mm_f32(y.t(), hi).add_(mm_f32(y.t(), lo)).to(bf)
    return dy32, dw1, db1, dw2


def fused_ln_mlp_bwd_ln(xhat, rstd, gamma, dy32, g):
    """The LayerNorm part of the bf16 VJP, on the whole dy (rounded to bf16
    here, where JAX's jaxpr rounds it): (dx, dgamma, dbeta, db2) in f32,
    dx with the residual's gradient g added."""
    bf = torch.bfloat16
    gb = g.to(bf)
    db2 = gb.sum(0, dtype=torch.float32)
    dyf = dy32.to(bf).float()
    dgamma = (dyf * xhat).sum(0)
    dbeta = dyf.sum(0)
    dxhat = dyf.mul_(gamma.float())
    dx = rstd * (dxhat - dxhat.mean(-1, keepdim=True)
                 - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    return dx.add_(gb.float()), dgamma, dbeta, db2


def fused_ln_mlp_bwd(x2d, gamma, beta, w1, b1, w2, b2, eps: float, g,
                     group=None):
    """The VJP of `_xla_ref` for bf16 x2d: (dx, dgamma, dbeta, dw1, db1, dw2,
    db2), each in its input's dtype. The rounding points of JAX's jaxpr:
    y, h, dh, dy and the weight gradients rounded to bf16; LayerNorm,
    GELU and the bias sums in f32. Two parts: `fused_ln_mlp_bwd_local` (the
    products) and `fused_ln_mlp_bwd_ln` (the LayerNorm); with a `group`
    (tensor parallelism: w1, b1, w2 this rank's parts) the f32 dy between
    them is all-reduced over it, once."""
    xhat, rstd = _ln_stats(x2d, eps)
    y = (xhat * gamma.float() + beta.float()).to(torch.bfloat16)
    dy32, dw1, db1, dw2 = fused_ln_mlp_bwd_local(y, w1, b1, w2, g)
    del y
    if group is not None:
        torch.distributed.all_reduce(dy32, group=group)
    dx, dgamma, dbeta, db2 = fused_ln_mlp_bwd_ln(xhat, rstd, gamma, dy32, g)
    return (dx.to(x2d.dtype), dgamma.to(gamma.dtype), dbeta.to(beta.dtype),
            dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype),
            db2.to(b2.dtype))


def _check(x2d, w1, w2, vecs, what: str) -> None:
    """Raise unless the shapes fit each other and the kernel's widths."""
    m, d = x2d.shape
    hidden = w1.shape[1]
    vec_shapes = [tuple(t.shape) for t in vecs]
    want = [(d,), (d,), (hidden,), (d,)][:len(vecs)]
    if (w1.shape != (d, hidden) or w2.shape != (hidden, d)
            or vec_shapes != want):
        raise ValueError(f"{what}: weight shapes {tuple(w1.shape)}, "
                         f"{tuple(w2.shape)}, vectors {vec_shapes} do not "
                         f"fit x {tuple(x2d.shape)}")
    if d % 128 or hidden % 128 or _SMEM_FIXED + 128 * d > _SMEM_LIMIT:
        raise ValueError(f"{what} kernel: D={d}, hidden={hidden} must be "
                         f"multiples of 128 with D <= 1280 (shared memory)")


def _bf16_rows(x2d):
    x = x2d.contiguous()
    if x.data_ptr() % 16:                   # the kernel reads 16-byte rows
        x = x.clone()
    return x


def _launch_fc1(x, gamma, beta, w1, b1, eps: float) -> torch.Tensor:
    """Launch (a): h = gelu_tanh(LN(x) @ w1 + b1) in bf16."""
    m, d = x.shape
    hidden = w1.shape[1]
    w1 = w1.to(torch.bfloat16).contiguous()
    vecs = [t.float().contiguous() for t in (gamma, beta, b1)]
    h = torch.empty((m, hidden), dtype=torch.bfloat16, device=x.device)
    _build.check(_build.library().pvpu_ln_fc1_gelu(
        x.data_ptr(), vecs[0].data_ptr(), vecs[1].data_ptr(), w1.data_ptr(),
        vecs[2].data_ptr(), h.data_ptr(), m, d, hidden, float(eps),
        _build.stream_of(x)), "ln_fc1_gelu")
    return h


def _launch(x2d, gamma, beta, w1, b1, w2, b2, eps: float) -> torch.Tensor:
    _check(x2d, w1, w2, (gamma, beta, b1, b2), "fused_ln_mlp")
    x = _bf16_rows(x2d)
    h = _launch_fc1(x, gamma, beta, w1, b1, eps)
    out = torch.empty_like(x)
    m, d = x.shape
    w2 = w2.to(torch.bfloat16).contiguous()
    b2 = b2.float().contiguous()
    _build.check(_build.library().pvpu_fc2_residual(
        h.data_ptr(), w2.data_ptr(), b2.data_ptr(), x.data_ptr(),
        out.data_ptr(), m, d, h.shape[1], _build.stream_of(x)),
        "fc2_residual")
    return out


def launch_fc2_partial(h: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """Launch (b'), `pvpu_fc2_partial`: h (M, Hd) bf16 @ w2 (Hd, D) as f32
    (M, D), the same tiles and sums as launch (b) before its bias and
    residual."""
    m, hidden = h.shape
    d = w2.shape[1]
    if (h.dtype != torch.bfloat16 or w2.shape[0] != hidden or d % 128
            or hidden % 128):
        raise ValueError(f"fc2_partial kernel: h {tuple(h.shape)} "
                         f"{h.dtype}, w2 {tuple(w2.shape)}: bf16 h, widths "
                         f"multiples of 128")
    h = _bf16_rows(h)
    w2 = w2.to(torch.bfloat16).contiguous()
    out = torch.empty((m, d), dtype=torch.float32, device=h.device)
    _build.check(_build.library().pvpu_fc2_partial(
        h.data_ptr(), w2.data_ptr(), out.data_ptr(), m, d, hidden,
        _build.stream_of(h)), "fc2_partial")
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


def _launch_partial(x2d, gamma, beta, w1, b1, w2, eps: float) -> torch.Tensor:
    """Launches (a) and (b'): this rank's f32 partial sum of fc2."""
    _check(x2d, w1, w2, (gamma, beta, b1), "fused_ln_mlp_tp")
    x = _bf16_rows(x2d)
    return launch_fc2_partial(_launch_fc1(x, gamma, beta, w1, b1, eps), w2)


class _FusedLnMlpTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2d, gamma, beta, w1, b1, w2, b2, eps: float, group):
        ctx.eps, ctx.group = eps, group
        ctx.save_for_backward(x2d, gamma, beta, w1, b1, w2, b2)
        if x2d.dtype != torch.bfloat16 or x2d.device.type != "cuda":
            part = fc2_partial_plain(_fc1_gelu_plain(
                _ln_plain(x2d, gamma, beta, eps), w1, b1), w2)
        else:
            part = _launch_partial(x2d, gamma, beta, w1, b1, w2, eps)
            fused_ln_mlp_tp.launches += 1
        torch.distributed.all_reduce(part, group=group)
        # the one rounding of the unsharded kernel's epilogue
        out = part.add_(b2.float()).add_(x2d.float()).to(x2d.dtype)
        if x2d.is_cuda:
            fused_ln_mlp_tp.epilogues += 1
        return out

    @staticmethod
    def backward(ctx, g):
        need = ctx.needs_input_grad[:7]
        saved = ctx.saved_tensors
        if saved[0].dtype == torch.bfloat16:
            got = fused_ln_mlp_bwd(*saved, ctx.eps, g, group=ctx.group)
            if g.is_cuda:
                fused_ln_mlp_tp.bwd_launches += 1
            return (*(t if n else None for t, n in zip(got, need)), None,
                    None)
        # f32: autograd through the plain parts, the same two parts
        x2d, gamma, beta, w1, b1, w2, b2 = saved
        leaves = [t.detach().requires_grad_() for t in (x2d, gamma, beta)]
        local = [t.detach().requires_grad_() for t in (w1, b1, w2)]
        with torch.enable_grad():
            y = _ln_plain(*leaves, ctx.eps)
            yl = y.detach().requires_grad_()
            part = fc2_partial_plain(_fc1_gelu_plain(yl, local[0], local[1]),
                                     local[2])
            dy, dw1, db1, dw2 = torch.autograd.grad(part, [yl, *local], g)
            torch.distributed.all_reduce(dy, group=ctx.group)
            dx, dgamma, dbeta = torch.autograd.grad(y, leaves, dy)
        got = (dx + g, dgamma, dbeta, dw1, db1, dw2, g.sum(0))
        return (*(t if n else None for t, n in zip(got, need)), None, None)


def fused_ln_mlp_tp(x: torch.Tensor, ln, mlp, group,
                    eps: float = 1e-6) -> torch.Tensor:
    """`fused_ln_mlp` of a block whose MLP is split over the model ranks of
    `group` (parallel/tp.py): fc1 (and its bias) by columns and fc2 by
    rows, this rank's parts in `mlp`, fc2's bias whole. The forward is
    launch (a) on the local hidden width and launch (b'), whose f32 partial
    sums are all-reduced over `group`; then + fc2's bias + x, rounded once
    (one torch expression: it follows the collective). The backward is
    `fused_ln_mlp_bwd`'s two parts with one f32 all-reduce of dy between
    them. bf16 on CUDA launches the kernels (widths that do not fit them
    raise); bf16 on the CPU and f32 take the plain versions."""
    d = x.shape[-1]
    out = _FusedLnMlpTP.apply(x.reshape(-1, d), ln.scale, ln.bias, mlp.fc1.w,
                              mlp.fc1.b, mlp.fc2.w, mlp.fc2.b, eps, group)
    return out.reshape(x.shape)


fused_ln_mlp_tp.launches = 0     # forward calls on CUDA: launches (a), (b')
fused_ln_mlp_tp.epilogues = 0    # their bias + residual epilogues (CUDA)
fused_ln_mlp_tp.bwd_launches = 0  # bf16 CUDA backward calls
