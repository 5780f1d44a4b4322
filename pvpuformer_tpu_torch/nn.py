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
    """HWIO conv weights (torch Conv2d init)."""

    def __init__(self, kh: int, kw: int, in_ch: int, out_ch: int,
                 g: Optional[torch.Generator] = None):
        super().__init__()
        fan_in = kh * kw * in_ch
        self.w = param(kaiming_uniform((kh, kw, in_ch, out_ch), g, fan_in))
        self.b = param(_uniform((out_ch,), math.sqrt(1.0 / fan_in), g))


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
    y = x @ p.w.to(x.dtype)
    if p.b is not None:
        y = y + p.b.to(x.dtype)
    return y


def gelu(x: torch.Tensor) -> torch.Tensor:
    """tanh GELU in bf16, exact erf GELU otherwise (JAX `nn.gelu`)."""
    if x.dtype == torch.bfloat16:
        return F.gelu(x, approximate="tanh")
    return F.gelu(x)


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
           padding: str | Sequence = "TORCH") -> torch.Tensor:
    """NHWC/HWIO conv. "TORCH" pads k//2 per side (torch Conv2d(padding=k//2));
    "VALID" pads nothing."""
    kh, kw = p.w.shape[0], p.w.shape[1]
    if padding == "TORCH":
        pad = (kh // 2, kw // 2)
    elif padding == "VALID":
        pad = (0, 0)
    else:
        raise ValueError(f"conv2d: unsupported padding {padding!r}")
    w = p.w.to(x.dtype).permute(3, 2, 0, 1)              # HWIO -> OIHW
    y = F.conv2d(x.permute(0, 3, 1, 2), w, stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1) + p.b.to(x.dtype)


def conv1x1(p, x: torch.Tensor) -> torch.Tensor:
    y = x @ p.w.reshape(p.w.shape[-2], p.w.shape[-1]).to(x.dtype)
    return y + p.b.to(x.dtype)


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
    return x @ p.w.to(x.dtype) + p.b.to(x.dtype)


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
