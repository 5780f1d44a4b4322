"""Swin-UNet segmentation model (pvpuformer_tpu/models/zoo/swin_unet.py;
the reference's swin_unet.py, SwinTransformerSys): a U-shaped Swin encoder
and decoder, patch merging down, patch expanding up (a linear, then a
pixel shuffle and LayerNorm), skips joined by a linear at each scale, and a
final 4x expand and 1x1 classifier. The coord channels join the image at
the patch embed.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn as tnn

from ... import nn
from ...ops.resize import bilinear_resize
from .common import is_inputs
from .swin import _block, block_params, merge_params, patch_merge


@dataclasses.dataclass(frozen=True)
class SwinUNetISConfig:
    embed_dim: int = 96
    depths: Tuple[int, ...] = (2, 2, 2, 2)
    num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    window: int = 7
    mlp_ratio: float = 4.0
    num_max_points: int = 24
    norm_radius: float = 5.0
    use_disks: bool = True
    with_prev_mask: bool = True
    dtype: Any = torch.float32

    @property
    def stage_dims(self) -> Tuple[int, ...]:
        return tuple(self.embed_dim * (2 ** i) for i in range(len(self.depths)))

    def replace(self, **kw) -> "SwinUNetISConfig":
        return dataclasses.replace(self, **kw)


def _expand_params(dim: int, factor: int = 2, g=None) -> nn.Node:
    """Patch expanding: linear dim -> factor^2 * (dim / 2) at factor 2,
    factor^2 * dim at 4."""
    out = (factor * factor) * (dim // factor) if factor == 2 else \
        (factor * factor) * dim
    return nn.Node(lin=nn.Linear(dim, out, bias=False, g=g),
                   norm=nn.Norm(out // (factor * factor)))


def _expand(p, x: torch.Tensor, h: int, w: int, factor: int = 2):
    b = x.shape[0]
    y = nn.linear(p.lin, x)
    c = y.shape[-1] // (factor * factor)
    y = y.reshape(b, h, w, factor, factor, c).permute(0, 1, 3, 2, 4, 5)
    y = y.reshape(b, h * factor * w * factor, c)
    return nn.layer_norm(p.norm, y, 1e-5), h * factor, w * factor


class SwinUNetISModel(tnn.Module):
    """The JAX `init_swin_unet_is` tree; `generator=None` leaves the
    weights zero, for loading."""

    def __init__(self, cfg: SwinUNetISConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.cfg = cfg
        coord_ch = 3 if cfg.with_prev_mask else 2
        dims, ns = cfg.stage_dims, len(cfg.depths)
        self.patch_embed = nn.PatchEmbed((4, 4), 3 + coord_ch, cfg.embed_dim,
                                         g=g)
        self.enc = tnn.ModuleList()
        for i in range(ns):
            kids = dict(blocks=tnn.ModuleList(
                block_params(dims[i], cfg.num_heads[i], cfg.mlp_ratio,
                             cfg.window, g) for _ in range(cfg.depths[i])))
            if i < ns - 1:
                kids["merge"] = merge_params(dims[i], g)
            self.enc.append(nn.Node(**kids))
        self.dec = tnn.ModuleList()
        for i in range(ns - 1):                        # deepest first
            di = dims[ns - 1 - i]
            self.dec.append(nn.Node(
                expand=_expand_params(di, 2, g),
                reduce=nn.Linear(di, di // 2, bias=False, g=g),
                blocks=tnn.ModuleList(
                    block_params(di // 2, cfg.num_heads[ns - 2 - i],
                                 cfg.mlp_ratio, cfg.window, g)
                    for _ in range(cfg.depths[ns - 2 - i]))))
        self.final_expand = _expand_params(dims[0], 4, g)
        self.cls = nn.Conv(1, 1, dims[0], 1, g)
        self.norm = nn.Norm(dims[0])

    def forward(self, image, points, **kw):
        return swin_unet_is_forward(self, self.cfg, image, points, **kw)


def init_swin_unet_is(cfg: SwinUNetISConfig, generator: torch.Generator,
                      device=None) -> SwinUNetISModel:
    return SwinUNetISModel(cfg, generator).to(nn.resolve_device(device))


def _blocks(blocks, x, hw, heads, window):
    for j, blk in enumerate(blocks):
        x = _block(blk, x, hw, heads, window, 0 if j % 2 == 0 else window // 2)
    return x


def swin_unet_is_forward(p: SwinUNetISModel, cfg: SwinUNetISConfig,
                         image: torch.Tensor, points: torch.Tensor,
                         coord_bias=None, **_) -> Dict[str, torch.Tensor]:
    rgb, coords = is_inputs(image, points, cfg.norm_radius, cfg.use_disks,
                            cfg.with_prev_mask, cfg.dtype,
                            coord_bias=coord_bias)
    x = nn.patch_embed(p.patch_embed, torch.cat([rgb, coords], -1), (4, 4))
    h, w = rgb.shape[1] // 4, rgb.shape[2] // 4
    b = x.shape[0]
    ns = len(cfg.depths)
    skips: List[Tuple[torch.Tensor, int, int]] = []
    for i, enc in enumerate(p.enc):
        x = _blocks(enc.blocks, x, (h, w), cfg.num_heads[i], cfg.window)
        skips.append((x, h, w))
        if hasattr(enc, "merge"):
            x, h, w = patch_merge(enc.merge, x, h, w, pad=False)
    for i, dec in enumerate(p.dec):
        x, h, w = _expand(dec.expand, x, h, w)
        x = nn.linear(dec.reduce, torch.cat([x, skips[ns - 2 - i][0]], -1))
        x = _blocks(dec.blocks, x, (h, w), cfg.num_heads[ns - 2 - i],
                    cfg.window)
    x = nn.layer_norm(p.norm, x, 1e-5)
    x, h, w = _expand(p.final_expand, x, h, w, factor=4)
    seg = nn.conv1x1(p.cls, x.reshape(b, h, w, -1))
    hh, ww = image.shape[1], image.shape[2]
    return {"instances": bilinear_resize(seg, hh, ww, align_corners=True),
            "instances_aux": None}
