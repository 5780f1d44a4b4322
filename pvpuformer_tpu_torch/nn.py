"""NN primitives with the JAX package's layouts and dtype policy.

Parameters live in small `torch.nn.Module` containers whose attribute names
are the JAX pytree keys, so a module's `state_dict()` names map 1:1 onto the
JAX checkpoint names (`a/b/#3/w` -> `a.b.3.w`). The apply functions take the
container as their first argument, like the JAX `fn(params, x)` functions.

Layouts kept from the JAX package (pvpuformer_tpu/nn.py):
  * linear `w` is (in, out) and applied as `x @ w`;
  * activations are NHWC; conv weights are HWIO; 2x2 deconv weights are
    (in, 2, 2, out);
  * patch-embed weights are (ph*pw*c, D) over patches flattened (ph, pw, c).

Dtype policy: bf16 matmuls give bf16 outputs (f32 accumulation), GELU is
tanh in bf16 and exact erf otherwise, LayerNorm / GroupNorm statistics are
f32, and dense `sdpa` rounds its logits to the input dtype.
"""
from __future__ import annotations

import copy
import math
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# ---------------------------------------------------------------------------
# initializers (torch.Generator on the CPU; the module is moved afterwards)
# ---------------------------------------------------------------------------


def _uniform(shape, bound: float, g: Optional[torch.Generator]) -> torch.Tensor:
    if g is None:
        return torch.zeros(shape)
    return (torch.rand(shape, generator=g) * 2.0 - 1.0) * bound


def xavier_uniform(shape, g, fan_in=None, fan_out=None) -> torch.Tensor:
    fan_in = fan_in if fan_in is not None else math.prod(shape[:-1])
    fan_out = fan_out if fan_out is not None else shape[-1]
    return _uniform(shape, math.sqrt(6.0 / (fan_in + fan_out)), g)


def kaiming_uniform(shape, g, fan_in=None) -> torch.Tensor:
    """torch's default conv/linear init, kaiming_uniform(a=sqrt(5))."""
    fan_in = fan_in if fan_in is not None else math.prod(shape[:-1])
    return _uniform(shape, math.sqrt(3.0) * math.sqrt(1.0 / fan_in), g)


def normal_init(shape, g, std: float = 0.02) -> torch.Tensor:
    if g is None:
        return torch.zeros(shape)
    return std * torch.randn(shape, generator=g)


def param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


# ---------------------------------------------------------------------------
# parameter containers
# ---------------------------------------------------------------------------


class Node(nn.Module):
    """A named group of sub-containers (a dict node of the JAX tree)."""

    def __init__(self, **children: nn.Module):
        super().__init__()
        for name, child in children.items():
            self.add_module(name, child)


class Linear(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, bias: bool = True,
                 init: str = "torch", g: Optional[torch.Generator] = None):
        super().__init__()
        if init == "xavier":
            w = xavier_uniform((in_dim, out_dim), g)
        else:
            w = kaiming_uniform((in_dim, out_dim), g, fan_in=in_dim)
        self.w = param(w)
        b = (_uniform((out_dim,), math.sqrt(1.0 / in_dim), g)
             if init == "torch" else torch.zeros(out_dim))
        self.b = param(b) if bias else None


class Mlp(nn.Module):
    def __init__(self, in_dim: int, hidden: int, out_dim: Optional[int] = None,
                 init: str = "torch", g: Optional[torch.Generator] = None):
        super().__init__()
        self.fc1 = Linear(in_dim, hidden, init=init, g=g)
        self.fc2 = Linear(hidden, out_dim or in_dim, init=init, g=g)


class Norm(nn.Module):
    """LayerNorm / GroupNorm(1, C) affine parameters."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = param(torch.ones(dim))
        self.bias = param(torch.zeros(dim))


class Conv(nn.Module):
    """HWIO conv weights (torch Conv2d init); with `groups` the weight is
    (kh, kw, in_ch // groups, out_ch), as in JAX `init_conv`."""

    def __init__(self, kh: int, kw: int, in_ch: int, out_ch: int,
                 g: Optional[torch.Generator] = None, bias: bool = True,
                 groups: int = 1):
        super().__init__()
        fan_in = kh * kw * (in_ch // groups)
        self.w = param(kaiming_uniform((kh, kw, in_ch // groups, out_ch), g,
                                       fan_in))
        self.b = (param(_uniform((out_ch,), math.sqrt(1.0 / fan_in), g))
                  if bias else None)


class Deconv2x2(nn.Module):
    """ConvTranspose2d(k=2, s=2) stored (in, 2, 2, out); torch's fan-in."""

    def __init__(self, in_ch: int, out_ch: int,
                 g: Optional[torch.Generator] = None):
        super().__init__()
        fan_in = out_ch * 4
        self.w = param(kaiming_uniform((in_ch, 2, 2, out_ch), g, fan_in))
        self.b = param(_uniform((out_ch,), math.sqrt(1.0 / fan_in), g))


class PatchEmbed(nn.Module):
    def __init__(self, patch: Tuple[int, int], in_ch: int, embed_dim: int,
                 init: str = "xavier", g: Optional[torch.Generator] = None):
        super().__init__()
        fan_in = patch[0] * patch[1] * in_ch
        if init == "xavier":
            w = xavier_uniform((fan_in, embed_dim), g, fan_in, embed_dim)
        else:
            w = kaiming_uniform((fan_in, embed_dim), g, fan_in)
        self.w = param(w)
        self.b = param(_uniform((embed_dim,), math.sqrt(1.0 / fan_in), g))


# ---------------------------------------------------------------------------
# apply functions
# ---------------------------------------------------------------------------


def linear(p, x: torch.Tensor) -> torch.Tensor:
    if isinstance(p, QuantLinear):
        return linear_int8(p, x)
    y = x @ p.w.to(x.dtype)
    if p.b is not None:
        y = y + p.b.to(x.dtype)
    return y


# ---------------------------------------------------------------------------
# int8 PTQ serving path (pvpuformer_tpu/nn.py:98-176)
#
# Per-output-channel symmetric weight scales, computed offline, and per-row
# dynamic symmetric activation scales; int8 x int8 -> int32 products.
# `quantize_params` returns a quantized copy of a module tree in which every
# linear-shaped node is a `QuantLinear`, and `linear` / `patch_embed`
# dispatch on it. The quantized copy is a serving-time transform: configs
# and checkpoints keep the float weights.
# ---------------------------------------------------------------------------


class QuantLinear(nn.Module):
    """An int8 linear: `w_q` int8 (in, out), `w_s` f32 (out,), `b` f32
    (out,) or None, all buffers. Device moves apply to them; dtype casts of
    the tree (`cast_params`) leave them as they are: w_q is int8, and the
    scales and bias stay f32, as JAX's quantized leaves do. w_q is stored
    column-major (its transpose is contiguous), the layout cuBLASLt's int8
    product takes as its second operand; its values are JAX's (in, out)."""

    def __init__(self, w_q: torch.Tensor, w_s: torch.Tensor,
                 b: Optional[torch.Tensor]):
        super().__init__()
        self.register_buffer("w_q", w_q.t().contiguous().t())
        self.register_buffer("w_s", w_s)
        self.register_buffer("b", b)

    def _apply(self, fn, recurse=True):
        self.w_q = fn(self.w_q)           # an int8 tensor: moves, never casts
        self.w_s = self.w_s.to(self.w_q.device)
        if self.b is not None:
            self.b = self.b.to(self.w_q.device)
        return self


def quantize_linear(p) -> QuantLinear:
    """PTQ of a linear container {w (in, out)[, b]} (JAX `quantize_linear`):
    symmetric per output channel, w ~= w_q * w_s."""
    w = p.w.detach().float()
    s = (w.abs().amax(0) / 127.0).clamp_min(1e-12)
    w_q = torch.round(w / s).clamp(-127, 127).to(torch.int8)
    b = getattr(p, "b", None)
    return QuantLinear(w_q, s, None if b is None else b.detach().float())


def _pad_to(t: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    if t.shape[dim] == size:
        return t
    pad = [0, 0] * (t.dim() - 1 - dim) + [0, size - t.shape[dim]]
    return F.pad(t, pad)


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(m, k) int8 @ (k, n) int8 -> (m, n) int32, exact: `torch._int_mm`,
    through `int_mm_padded` on the card."""
    return int_mm_padded(a, b) if a.is_cuda else torch._int_mm(a, b)


def int_mm_padded(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`torch._int_mm` at the shapes and layout cuBLASLt's int8 product
    takes on the H100 (m > 16; k, n multiples of 8; b column-major, which
    it takes at every m, where a row-major b is refused unless m is a
    multiple of 32): the operands are padded with zeros where needed (zero
    rows and columns add nothing to the kept sums) and the result sliced
    back. No shape falls back to a float product."""
    m, k = a.shape
    n = b.shape[1]
    mp, kp, np_ = max(m, 17), -(-k // 8) * 8, -(-n // 8) * 8
    if (mp, kp) != (m, k):
        a = _pad_to(_pad_to(a, 0, mp), 1, kp)
    if (kp, np_) != (k, n):
        b = _pad_to(_pad_to(b, 0, kp), 1, np_)
    if not b.t().is_contiguous():
        b = b.t().contiguous().t()
    return torch._int_mm(a.contiguous(), b)[:m, :n]


# f32(1 / 127): XLA compiles JAX's `max|x| / 127.0` into a product with it,
# so every jitted JAX int8 entry point scales by this constant
_INV127 = 1.0 / 127.0


def linear_int8(p: QuantLinear, x: torch.Tensor) -> torch.Tensor:
    """JAX `_linear_int8` as XLA compiles it: per-row scales sx =
    max(max|x| * f32(1/127), 1e-12) (the op-by-op division differs in the
    last bit of sx for some rows), x rounded half to even and clipped to
    int8, the int32 product, then acc * sx * w_s + b in f32, in that order,
    cast to x's dtype."""
    xf = x.float()
    sx = (xf.abs().amax(-1, keepdim=True) * _INV127).clamp_min(1e-12)
    xq = torch.round(xf / sx).clamp(-127, 127).to(torch.int8)
    acc = int_mm(xq.reshape(-1, xq.shape[-1]), p.w_q)
    y = acc.reshape(*x.shape[:-1], -1).float() * sx * p.w_s
    if p.b is not None:
        y = y + p.b
    return y.to(x.dtype)


def _is_linear_node(m: nn.Module, min_in_dim: int) -> bool:
    """JAX's shape test: nothing but a 2-D float `w` of fan-in at least
    `min_in_dim` and an optional `b` (LayerNorm, conv and deconv containers
    fail it: other names, or a 4-D `w`)."""
    if next(m.children(), None) is not None:
        return False
    names = ({n for n, _ in m.named_parameters(recurse=False)}
             | {n for n, _ in m.named_buffers(recurse=False)})
    w = getattr(m, "w", None)
    return (isinstance(w, torch.Tensor) and names <= {"w", "b"}
            and w.dim() == 2 and w.is_floating_point()
            and w.shape[0] >= min_in_dim)


def quantize_params(module: nn.Module, min_in_dim: int = 64,
                    dtype: Optional[torch.dtype] = None) -> nn.Module:
    """A quantized copy of `module` (JAX `quantize_params`): every
    linear-shaped node (`_is_linear_node`) becomes a `QuantLinear`; the
    caller's module is left as it is. With `dtype`, the copy is cast first,
    so the scales come from the rounded weights, as JAX's Predictor
    quantizes after `cast_params`."""
    out = copy.deepcopy(module)
    if dtype is not None:
        cast_params(out, dtype)
    if _is_linear_node(out, min_in_dim):
        return quantize_linear(out)

    def walk(m: nn.Module) -> None:
        for name, child in m.named_children():
            if _is_linear_node(child, min_in_dim):
                setattr(m, name, quantize_linear(child))
            else:
                walk(child)

    walk(out)
    return out


def is_quantized(module: nn.Module) -> bool:
    return any(isinstance(m, QuantLinear) for m in module.modules())


def inference_model(model: nn.Module, dtype: torch.dtype, device,
                    int8: bool = False) -> nn.Module:
    """The module an inference entry point runs: `model` moved to `device`
    and cast to `dtype` in place; with `int8`, a quantized copy of it
    instead (cast first, as JAX's predictor.py:667-676 quantizes after
    `cast_params`), leaving the caller's module as it is. The flag alone
    decides: with `int8` a module that `quantize_params` already made is
    used as it is (one copy shared by many sessions), and without it a
    quantized module is refused, so that no float path (BRS among them,
    whose gradients `round` would zero) runs int8 unasked."""
    if int8 and not is_quantized(model):
        model = quantize_params(model, dtype=dtype)
    elif not int8 and is_quantized(model):
        raise ValueError("a quantized module needs int8=True; pass the "
                         "float module for a float path")
    return cast_params(model.to(device), dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """tanh GELU in bf16, exact erf GELU otherwise (JAX `nn.gelu`)."""
    if x.dtype == torch.bfloat16:
        return F.gelu(x, approximate="tanh")
    return F.gelu(x)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's QuickGELU, x * sigmoid(1.702 x) (JAX `nn.quick_gelu`)."""
    return x * torch.sigmoid(1.702 * x)


def mlp(p, x: torch.Tensor, act: Callable = gelu) -> torch.Tensor:
    return linear(p.fc2, act(linear(p.fc1, x)))


def layer_norm(p, x: torch.Tensor, eps: float = 1e-6,
               f32: bool = True) -> torch.Tensor:
    """torch-parity LayerNorm; `f32=False` normalizes in the input dtype."""
    xf = x.float() if f32 else x
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if f32:
        y = y * p.scale.float() + p.bias.float()
    else:
        y = y * p.scale.to(x.dtype) + p.bias.to(x.dtype)
    return y.to(x.dtype)


def group_norm1(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm(1, C) over NHWC: statistics over all of (H, W, C), f32."""
    xf = x.float()
    dims = tuple(range(1, x.ndim))
    mean = xf.mean(dims, keepdim=True)
    var = (xf - mean).square().mean(dims, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * p.scale.float() + p.bias.float()).to(x.dtype)


def conv2d(p, x: torch.Tensor, stride: int = 1,
           padding: str | Sequence = "TORCH", groups: int = 1,
           dilation: int = 1) -> torch.Tensor:
    """NHWC/HWIO conv (JAX `nn.conv2d` / `conv_nhwc`). "TORCH" pads
    dilation * (k // 2) per side (torch Conv2d(padding=k//2), and the
    zoo's dilated convs' padding=dilation); "SAME" is the same at stride 1;
    "VALID" pads nothing. `groups` > 1 takes the (kh, kw, in/groups, out)
    weight of a grouped or depthwise conv. A container without `b` adds no
    bias.

    In f32, a VALID conv whose stride is its square kernel (the neck's
    2x2 / 2 down32 conv) is a patch matmul (PyTorch's matmul default is
    full f32); every other f32 conv on the card runs in cuDNN, with TF32
    off once an entry point has placed a model there (`resolve_device`)."""
    kh, kw = p.w.shape[0], p.w.shape[1]
    if (x.dtype == torch.float32 and padding == "VALID" and kh == kw == stride
            and groups == 1 and dilation == 1):
        b, h, w, c = x.shape
        x = x[:, :h // kh * kh, :w // kw * kw]
        return patch_embed(p, x, (kh, kw)).reshape(b, h // kh, w // kw, -1)
    if padding == "TORCH" or (padding == "SAME" and stride == 1):
        pad = (dilation * (kh // 2), dilation * (kw // 2))
    elif padding == "VALID":
        pad = (0, 0)
    else:
        raise ValueError(f"conv2d: unsupported padding {padding!r}")
    w = p.w.to(x.dtype).permute(3, 2, 0, 1)              # HWIO -> OIHW
    y = F.conv2d(x.permute(0, 3, 1, 2), w, stride=stride, padding=pad,
                 dilation=dilation, groups=groups)
    y = y.permute(0, 2, 3, 1)
    return y if p.b is None else y + p.b.to(x.dtype)


def conv1x1(p, x: torch.Tensor) -> torch.Tensor:
    y = x @ p.w.reshape(p.w.shape[-2], p.w.shape[-1]).to(x.dtype)
    return y if p.b is None else y + p.b.to(x.dtype)


def deconv2x2(p, x: torch.Tensor) -> torch.Tensor:
    """ConvTranspose2d(k=2, s=2) as matmul + pixel shuffle:
    out[2i+di, 2j+dj, o] = sum_c x[i, j, c] * w[c, di, dj, o]."""
    b, h, w, cin = x.shape
    y = x @ p.w.reshape(cin, -1).to(x.dtype)
    out = y.shape[-1] // 4
    y = y.reshape(b, h, w, 2, 2, out).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(b, 2 * h, 2 * w, out) + p.b.to(x.dtype)


def patch_embed(p, x: torch.Tensor, patch: Tuple[int, int]) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/ph * W/pw, D) via reshape + matmul."""
    ph, pw = patch
    b, h, w, c = x.shape
    gh, gw = h // ph, w // pw
    x = x.reshape(b, gh, ph, gw, pw, c).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(b, gh * gw, ph * pw * c)
    if isinstance(p, QuantLinear):         # an int8-quantized patch embed
        return linear_int8(p, x)
    w = p.w.reshape(ph * pw * c, -1)        # (ph*pw*c, D) or HWIO
    y = x @ w.to(x.dtype)
    return y if p.b is None else y + p.b.to(x.dtype)


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         scale: Optional[float] = None) -> torch.Tensor:
    """Dense attention over (..., N, H, Dh) -> (..., N, H, Dh).

    Logits are rounded to the input dtype before an f32 softmax, and the
    probabilities are rounded again before the PV product (JAX `nn.sdpa`).
    In bf16 the scale is itself a bf16 value, as in JAX's bf16 path."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.dtype == torch.bfloat16:
        scale = float(torch.tensor(scale, dtype=torch.bfloat16))
    logits = torch.einsum("...qhd,...khd->...hqk", q, k) * scale
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.einsum("...hqk,...khd->...qhd", probs, v)


def cast_params(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast every floating parameter (and buffer) to `dtype`, in place."""
    return module.to(dtype)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: None means the card ("cuda").
    Without a card this raises instead of running on the CPU unasked.

    On the card it pins the package's one precision flag: cuDNN's TF32 off
    (torch's `cudnn.allow_tf32` defaults to True), so that f32 convs run in
    full f32 as the JAX package's do. bf16 convs and f32 matmuls (torch's
    default is full f32) are not affected."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available: pass "
                               "device=\"cpu\" to run on the CPU")
        torch.backends.cudnn.allow_tf32 = False
    return dev
