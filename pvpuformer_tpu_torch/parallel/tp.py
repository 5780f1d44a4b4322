"""Tensor parallelism of the ViT blocks over the mesh's "model" axis: the
cut of each split leaf, and Megatron's two operators.

JAX expresses the split as shardings of the backbone's weights
(pvpuformer_tpu/parallel/mesh.py:62-84, `_tp_spec`: qkv and fc1 by columns,
proj and fc2 by rows) and lets GSPMD insert the collectives. Here each
model rank m of M holds its part of a block as plain tensors (`mesh.shard_params`
cuts them) and the block's forward calls the collectives itself
(models/vit.py):
  * "qkv": the columns s*D + h*hd + j of qkv's weight and bias for the
    heads h in [m*H/M, (m+1)*H/M), for each of q, k and v (s = 0, 1, 2):
    three blocks of columns. JAX's contiguous column split holds other
    columns, but GSPMD re-lays qkv's output by heads at
    pvpuformer_tpu/models/vit.py:99, so the values computed are the same;
  * "cols": fc1's weight and bias, contiguous columns;
  * "rows": proj's and fc2's weights, contiguous rows; their biases stay
    whole and are added once, after the reduction.
`copy_to_model` is the identity forward and an all-reduce of the gradient
over the model group; `reduce_from_model` an all-reduce forward and the
identity backward. A leaf that is not cut gets the same gradient on every
model rank when both are placed right.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List

import torch
import torch.distributed as tdist

KINDS = ("qkv", "cols", "rows")


@dataclasses.dataclass(frozen=True)
class Split:
    """A block's place on the model axis: its group, this rank's index in
    it and its size; whether the attention half and the MLP half are split
    (a half whose heads or hidden width do not divide by the size stays
    whole, JAX's fallback)."""
    group: Any
    rank: int
    size: int
    attn: bool
    mlp: bool


@dataclasses.dataclass(frozen=True)
class Cut:
    """How a leaf is cut over the model axis (`KINDS`), and this rank's
    part of it; set as `tp_cut` on the parameter."""
    kind: str
    group: Any
    rank: int
    size: int


def _pieces(n: int, kind: str, rank: int, size: int) -> List[slice]:
    """The slices of a cut dimension of length n that rank `rank` holds."""
    if kind == "qkv":
        d = n // 3
        w = d // size
        return [slice(s * d + rank * w, s * d + (rank + 1) * w)
                for s in range(3)]
    w = n // size
    return [slice(rank * w, (rank + 1) * w)]


def local_part(full: torch.Tensor, kind: str, rank: int,
               size: int) -> torch.Tensor:
    """Rank `rank`'s part of a whole leaf: rows for "rows", the last dim's
    columns otherwise."""
    dim = 0 if kind == "rows" else full.ndim - 1
    parts = [full.narrow(dim, s.start, s.stop - s.start)
             for s in _pieces(full.shape[dim], kind, rank, size)]
    return (parts[0] if len(parts) == 1
            else torch.cat(parts, dim)).contiguous()


def gather(local: torch.Tensor, cut: Cut) -> torch.Tensor:
    """The whole leaf from every model rank's part (a collective over the
    cut's group): each rank writes its part into a zeroed whole buffer and
    one all-reduce sums them (gloo has no all_gather for CUDA tensors)."""
    dim = 0 if cut.kind == "rows" else local.ndim - 1
    shape = list(local.shape)
    shape[dim] *= cut.size
    buf = local.new_zeros(shape)
    off = 0
    for s in _pieces(shape[dim], cut.kind, cut.rank, cut.size):
        n = s.stop - s.start
        buf.narrow(dim, s.start, n).copy_(local.narrow(dim, off, n))
        off += n
    tdist.all_reduce(buf, group=cut.group)
    return buf


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        tdist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        if x.is_contiguous():
            ctx.mark_dirty(x)
        else:
            x = x.contiguous()
        tdist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the gradient all-reduced over `group`."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over `group` of every rank's x (in place on a contiguous x);
    the gradient passes as it is."""
    return _ReduceFromModel.apply(x, group)


class _LinearF32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, w):
        from ..ops.fused_mlp import mm_f32
        wl = w.to(a.dtype)
        ctx.save_for_backward(a, wl)
        ctx.w_dtype = w.dtype
        return mm_f32(a, wl)

    @staticmethod
    def backward(ctx, g):
        from ..ops.fused_mlp import mm_f32
        a, wl = ctx.saved_tensors
        gl = g.to(a.dtype)
        da = gl @ wl.t() if ctx.needs_input_grad[0] else None
        dw = (mm_f32(a.t(), gl).to(a.dtype).to(ctx.w_dtype)
              if ctx.needs_input_grad[1] else None)
        return da, dw


def linear_f32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a (M, K) @ w (K, N) with w cast to a's dtype and an f32 result (one
    tensor-core product with f32 output on the card for bf16); the
    backward rounds the gradient to a's dtype and takes its products as
    `nn.linear`'s autograd does."""
    return _LinearF32.apply(a, w)
