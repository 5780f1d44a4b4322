"""MAE-style plain ViT backbone with window patchify (pvpuformer_tpu/models/vit.py).

Pre-norm blocks `x + attn(ln(x))`, `x + mlp(ln(x))`; all blocks except every
`blocks_per_group`-th run on 224x224-pixel token windows, folded into the
batch axis by a pure reshape.

Attention and the LN+MLP half of every block go through the ported kernels'
wrappers: on a CUDA tensor they launch the hand-written Hopper kernels, on a
CPU tensor they run the plain versions. A block that `parallel.mesh.shard_params`
split over the mesh's "model" axis (`Block.tp`) runs Megatron's halves on its
part of the heads and of the hidden width (parallel/tp.py,
`ops.fused_mlp.fused_ln_mlp_tp`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn as tnn

from .. import nn
from ..ops.attention import flash_attention
from ..ops.fused_attention import fused_attention
from ..ops.fused_mlp import fused_ln_mlp, fused_ln_mlp_tp
from ..parallel.tp import copy_to_model, linear_f32, reduce_from_model


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """Field names match the JAX ViTConfig so a checkpoint header reads back.

    The port reads `attn_impl`, `ln_f32` and `mlp_impl` but honours only:
      * attn_impl == "flash" selects the flash attention entry point; every
        other value ("auto", "xla", "fused") selects the fused entry point;
      * ln_f32 keeps its numeric meaning for the pre-attention LayerNorm
        (False: JAX's bf16 rounding op by op; a jitted JAX model keeps
        excess precision inside XLA's fusion, ~1.4% of outputs a ulp off).
    The MLP half goes through `fused_ln_mlp`: JAX's
    `mlp_impl="fused"` numerics, whose LayerNorm keeps f32 statistics
    (held against JAX in bf16, one block deep and for the whole model, by
    tests/test_torch_bf16_parity.py). An int8-quantized MLP
    (`nn.quantize_params`) leaves the kernel, as JAX's does
    (pvpuformer_tpu/models/vit.py:136-145).
    Not ported: the TPU crossovers behind "auto" (dense below
    MIN_SCORE_WORK); JAX's default `mlp_impl="xla"` in bf16, which rounds
    fc1's output to bf16 before its bias and GELU; `ln_f32=False` for the
    LayerNorm before the MLP (bf16 statistics)."""
    img_size: Tuple[int, int] = (448, 448)
    patch_size: Tuple[int, int] = (16, 16)
    in_chans: int = 3
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    ln_eps: float = 1e-6
    window_pixels: int = 224
    attn_impl: str = "auto"
    ln_f32: bool = True
    mlp_impl: str = "xla"

    @property
    def grid_size(self) -> Tuple[int, int]:
        return (self.img_size[0] // self.patch_size[0],
                self.img_size[1] // self.patch_size[1])

    @property
    def num_patches(self) -> int:
        gh, gw = self.grid_size
        return gh * gw

    @property
    def blocks_per_group(self) -> int:
        return 6 if self.depth == 12 else self.depth // 4


class Block(tnn.Module):
    # its place on the mesh's "model" axis when `parallel.mesh.shard_params`
    # split it (parallel/tp.py `Split`); None: the whole block
    tp = None

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float,
                 qkv_bias: bool, g: Optional[torch.Generator] = None):
        super().__init__()
        self.num_heads = num_heads
        self.norm1 = nn.Norm(dim)
        self.attn = nn.Node(
            qkv=nn.Linear(dim, dim * 3, bias=qkv_bias, init="xavier", g=g),
            proj=nn.Linear(dim, dim, init="xavier", g=g))
        self.norm2 = nn.Norm(dim)
        self.mlp = nn.Mlp(dim, int(dim * mlp_ratio), init="xavier", g=g)

    def forward(self, x: torch.Tensor, num_heads: int, eps: float,
                attn_impl: str = "auto", ln_f32: bool = True) -> torch.Tensor:
        """`block_forward` (the definition) through the module's call, where
        FSDP gathers a sharded block's parameters."""
        return block_forward(self, x, num_heads, eps, attn_impl, ln_f32)


class ViT(tnn.Module):
    def __init__(self, cfg: ViTConfig, g: Optional[torch.Generator] = None):
        super().__init__()
        d = cfg.embed_dim
        self.patch_embed = nn.PatchEmbed(cfg.patch_size, cfg.in_chans, d,
                                         init="xavier", g=g)
        self.pos_embed = nn.param(nn.normal_init((1, cfg.num_patches + 1, d), g))
        self.cls_token = nn.param(nn.normal_init((1, 1, d), g))
        self.blocks = tnn.ModuleList(
            Block(d, cfg.num_heads, cfg.mlp_ratio, cfg.qkv_bias, g)
            for _ in range(cfg.depth))


def block_forward(p: Block, x: torch.Tensor, num_heads: int, eps: float,
                  attn_impl: str = "auto", ln_f32: bool = True) -> torch.Tensor:
    tp = p.tp
    b, n, d = x.shape
    hd = d // num_heads
    h = nn.layer_norm(p.norm1, x, eps, f32=ln_f32)
    attn_fn = flash_attention if attn_impl == "flash" else fused_attention
    if tp is not None and tp.attn:
        # Megatron's attention half: this rank's H / M heads, the f32
        # partial sums of proj reduced over "model", then + bias + x
        # rounded once
        heads = num_heads // tp.size
        h = copy_to_model(h, tp.group)
        qkv = nn.linear(p.attn.qkv, h).reshape(b, n, 3, heads, hd)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        attn = attn_fn(q, k, v).reshape(b * n, heads * hd)
        part = reduce_from_model(linear_f32(attn, p.attn.proj.w), tp.group)
        x = (part + p.attn.proj.b.float()).reshape(b, n, d).add(
            x.float()).to(x.dtype)
    else:
        qkv = nn.linear(p.attn.qkv, h).reshape(b, n, 3, num_heads, hd)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        attn = attn_fn(q, k, v).reshape(b, n, d)
        x = x + nn.linear(p.attn.proj, attn)
    if tp is not None and tp.mlp:
        return fused_ln_mlp_tp(x, p.norm2, p.mlp, tp.group, eps)
    if isinstance(p.mlp.fc1, nn.QuantLinear) or isinstance(p.mlp.fc2,
                                                          nn.QuantLinear):
        # the kernel reads float weights; JAX's XLA MLP runs the int8 one:
        # LayerNorm, int8 fc1, GELU in x's dtype, int8 fc2 + residual
        h = nn.layer_norm(p.norm2, x, eps, f32=ln_f32)
        return x + nn.linear(p.mlp.fc2, nn.gelu(nn.linear(p.mlp.fc1, h)))
    return fused_ln_mlp(x, p.norm2, p.mlp, eps)


def _window_counts(cfg: ViTConfig) -> Tuple[int, int]:
    gh, gw = cfg.grid_size
    wh = cfg.window_pixels // cfg.patch_size[0]
    ww = cfg.window_pixels // cfg.patch_size[1]
    if gh % max(wh, 1) or gw % max(ww, 1) or gh < wh:
        return 1, 1
    return gh // wh, gw // ww


def _patchify(x: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    """(B, N, C) -> (B*wh*ww, N/(wh*ww), C), models_vit.py:225-239."""
    wh, ww = _window_counts(cfg)
    if wh * ww == 1:
        return x
    b, n, c = x.shape
    gh, gw = cfg.grid_size
    x = x.reshape(b, wh, gh // wh, ww, gw // ww, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b * wh * ww, n // (wh * ww), c)


def _unpatchify(x: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    wh, ww = _window_counts(cfg)
    if wh * ww == 1:
        return x
    bw, n, c = x.shape
    gh, gw = cfg.grid_size
    x = x.reshape(bw // (wh * ww), wh, ww, gh // wh, gw // ww, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(bw // (wh * ww), wh * ww * n, c)


def shuffle_noise(cfg: ViTConfig, gen: torch.Generator,
                  b: int) -> torch.Tensor:
    """The token shuffle's draws, (depth, B, N) uniforms, on the host from
    the CPU generator `gen` (JAX draws block i's from the i-th split of its
    `shuffle_key`; torch cannot reproduce those, so a test hands the port
    JAX's own)."""
    return torch.rand((cfg.depth, b, cfg.num_patches), generator=gen)


def vit_backbone_forward(p: ViT, cfg: ViTConfig, x_patches: torch.Tensor,
                         additional: Optional[torch.Tensor] = None,
                         shuffle_noise: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """`forward_backbone` (models_vit.py:257-287): (B, H, W, C) image ->
    (B, N, D) tokens; `additional` (B, N, D) is added before pos_embed.

    With `shuffle_noise` ((depth, B, N) uniforms, `shuffle_noise()`), the
    random shuffle mode (models_vit.py:193-222): every block runs global
    attention over the tokens gathered by a stable argsort of its noise
    and scattered back by the inverse permutation; no block is windowed."""
    x = nn.patch_embed(p.patch_embed, x_patches, cfg.patch_size)
    if additional is not None:
        x = x + additional
    x = x + p.pos_embed[:, 1:].to(x.dtype)
    if cfg.depth % 4:
        raise ValueError(f"ViT depth must be a multiple of 4, got {cfg.depth}")
    if shuffle_noise is not None:
        b, n, c = x.shape
        for i in range(cfg.depth):
            ids = torch.argsort(shuffle_noise[i], dim=1, stable=True)
            xs = x.gather(1, ids[:, :, None].expand(b, n, c))
            xs = p.blocks[i](xs, cfg.num_heads, cfg.ln_eps, cfg.attn_impl,
                             cfg.ln_f32)
            x = torch.empty_like(xs).scatter_(
                1, ids[:, :, None].expand(b, n, c), xs)
        return x
    nbpg = cfg.blocks_per_group
    patched = False
    for i in range(1, cfg.depth + 1):
        if i % nbpg and not patched:
            x, patched = _patchify(x, cfg), True
        elif not i % nbpg and patched:
            x, patched = _unpatchify(x, cfg), False
        x = p.blocks[i - 1](x, cfg.num_heads, cfg.ln_eps, cfg.attn_impl,
                            cfg.ln_f32)
    return _unpatchify(x, cfg) if patched else x
