"""Attention forward, flash entry: kernel wrapper and plain version.

Counterpart of pvpuformer_tpu/ops/attention.py (`flash_attention`, TPU
kernel `_flash_kernel`): online softmax over key tiles, P cast to the input
dtype UN-normalized, the output divided by the row sum at the end (with the
l == 0 guard), keys past the true sequence length masked. Selected by
`ViTConfig.attn_impl == "flash"`. The CUDA kernel is csrc/attention.cu.

`flash_attention` is a `torch.autograd.Function`. Its backward is a dense
recompute through `flash_attention_plain` on both devices, as JAX's `_bwd`
(attention.py:159-171), which is XLA code and not a Pallas kernel.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .fused_attention import launch_attention


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float) -> torch.Tensor:
    """The `_dense_sdpa` math (attention.py:121-126) over (B, N, H, D)."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs.float(),
                        v.float()).to(q.dtype)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale: float):
        ctx.scale = scale
        ctx.save_for_backward(q, k, v)
        if q.device.type != "cuda":
            return flash_attention_plain(q, k, v, scale)
        out = launch_attention(q, k, v, scale, flash=True)
        flash_attention.launches += 1
        return out

    @staticmethod
    def backward(ctx, g):
        res = [x.detach().requires_grad_() for x in ctx.saved_tensors]
        with torch.enable_grad():
            out = flash_attention_plain(*res, ctx.scale)
        if g.is_cuda:
            flash_attention.bwd_launches += 1
        return (*torch.autograd.grad(out, res, g), None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """(B, N, H, Dh) attention, differentiable. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel (head dim a multiple of 16,
    <= 128, else ValueError). The backward recomputes densely (plain ops)."""
    s = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    return _FlashAttention.apply(q, k, v, s)


flash_attention.launches = 0        # forward kernel launches
flash_attention.bwd_launches = 0    # dense recomputes on CUDA (plain ops)
