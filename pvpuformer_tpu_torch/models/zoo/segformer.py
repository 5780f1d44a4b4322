"""SegFormer (MixVisionTransformer) interactive-segmentation model
(pvpuformer_tpu/models/zoo/segformer.py; the reference's mmseg-style
segformer.py).

Four stages of overlapping patch embeds (k7 s4, then k3 s2) and blocks of
spatial-reduction attention (through `nn.sdpa`, JAX's dense attention with
its logit rounding) and Mix-FFN (fc1, depthwise 3x3, GELU, fc2); the coord
channels enter as extra input channels of the first patch embed; the
SegFormer head joins the four stages at stride 4.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn as tnn

from ... import nn
from ...ops.resize import bilinear_resize
from .common import conv_bn, conv_bn_relu, is_inputs

MIT_PRESETS = {
    "b0": dict(embed_dims=(32, 64, 160, 256), depths=(2, 2, 2, 2)),
    "b1": dict(embed_dims=(64, 128, 320, 512), depths=(2, 2, 2, 2)),
    "b2": dict(embed_dims=(64, 128, 320, 512), depths=(3, 4, 6, 3)),
    "b3": dict(embed_dims=(64, 128, 320, 512), depths=(3, 4, 18, 3)),
    "b4": dict(embed_dims=(64, 128, 320, 512), depths=(3, 8, 27, 3)),
    "b5": dict(embed_dims=(64, 128, 320, 512), depths=(3, 6, 40, 3)),
}

PATCH = ((7, 4), (3, 2), (3, 2), (3, 2))      # (kernel, stride) per stage


@dataclasses.dataclass(frozen=True)
class SegformerISConfig:
    embed_dims: Tuple[int, ...] = (32, 64, 160, 256)
    depths: Tuple[int, ...] = (2, 2, 2, 2)
    num_heads: Tuple[int, ...] = (1, 2, 5, 8)
    sr_ratios: Tuple[int, ...] = (8, 4, 2, 1)
    mlp_ratio: float = 4.0
    head_channels: int = 256
    num_max_points: int = 24
    norm_radius: float = 5.0
    use_disks: bool = True
    with_prev_mask: bool = True
    use_leaky_relu: bool = True
    dtype: Any = torch.float32

    def replace(self, **kw) -> "SegformerISConfig":
        return dataclasses.replace(self, **kw)


def _block_params(dim: int, mlp_ratio: float, sr: int, g=None) -> nn.Node:
    hidden = int(dim * mlp_ratio)
    kids = dict(norm1=nn.Norm(dim), q=nn.Linear(dim, dim, g=g),
                kv=nn.Linear(dim, dim * 2, g=g), proj=nn.Linear(dim, dim, g=g),
                norm2=nn.Norm(dim), fc1=nn.Linear(dim, hidden, g=g),
                dw=nn.Conv(3, 3, hidden, hidden, g, groups=hidden),
                fc2=nn.Linear(hidden, dim, g=g))
    if sr > 1:
        kids["sr"] = nn.Conv(sr, sr, dim, dim, g)
        kids["sr_norm"] = nn.Norm(dim)
    return nn.Node(**kids)


def _block(p, x: torch.Tensor, hw: Tuple[int, int], heads: int,
           sr: int) -> torch.Tensor:
    b, n, d = x.shape
    h, w = hw
    res = x
    x = nn.layer_norm(p.norm1, x, 1e-6)
    q = nn.linear(p.q, x).reshape(b, n, heads, d // heads)
    kv_in = x
    if sr > 1:
        m = nn.conv2d(p.sr, x.reshape(b, h, w, d), stride=sr, padding="VALID")
        kv_in = nn.layer_norm(p.sr_norm, m.reshape(b, -1, d), 1e-6)
    kv = nn.linear(p.kv, kv_in).reshape(b, -1, 2, heads, d // heads)
    att = nn.sdpa(q, kv[:, :, 0], kv[:, :, 1]).reshape(b, n, d)
    x = res + nn.linear(p.proj, att)
    res = x
    y = nn.linear(p.fc1, nn.layer_norm(p.norm2, x, 1e-6))
    y = nn.conv2d(p.dw, y.reshape(b, h, w, -1), padding="SAME",
                  groups=y.shape[-1]).reshape(b, n, -1)
    return res + nn.linear(p.fc2, nn.gelu(y))


class SegformerISModel(tnn.Module):
    """The JAX `init_segformer_is` tree; `generator=None` leaves the
    weights zero, for loading."""

    def __init__(self, cfg: SegformerISConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.cfg = cfg
        in_ch = 3 + (3 if cfg.with_prev_mask else 2)
        self.stages = tnn.ModuleList()
        for i, dim in enumerate(cfg.embed_dims):
            k, _ = PATCH[i]
            self.stages.append(nn.Node(
                patch=nn.Conv(k, k, in_ch, dim, g), patch_norm=nn.Norm(dim),
                blocks=tnn.ModuleList(
                    _block_params(dim, cfg.mlp_ratio, cfg.sr_ratios[i], g)
                    for _ in range(cfg.depths[i])),
                norm=nn.Norm(dim)))
            in_ch = dim
        hc = cfg.head_channels
        self.head = nn.Node(
            linears=tnn.ModuleList(nn.Linear(dim, hc, g=g)
                                   for dim in cfg.embed_dims),
            fuse=conv_bn(1, 1, hc * 4, hc, g),
            cls=nn.Conv(1, 1, hc, 1, g))

    def forward(self, image, points, **kw):
        return segformer_is_forward(self, self.cfg, image, points, **kw)


def init_segformer_is(cfg: SegformerISConfig, generator: torch.Generator,
                      device=None) -> SegformerISModel:
    return SegformerISModel(cfg, generator).to(nn.resolve_device(device))


def segformer_backbone(p: SegformerISModel, cfg: SegformerISConfig,
                       x: torch.Tensor) -> List[torch.Tensor]:
    """x (B, H, W, 3 + coord channels) -> the four stage maps (NHWC)."""
    feats = []
    for i, stage in enumerate(p.stages):
        y = nn.conv2d(stage.patch, x, stride=PATCH[i][1])
        b, h, w, d = y.shape
        tokens = nn.layer_norm(stage.patch_norm, y.reshape(b, h * w, d), 1e-6)
        for blk in stage.blocks:
            tokens = _block(blk, tokens, (h, w), cfg.num_heads[i],
                            cfg.sr_ratios[i])
        tokens = nn.layer_norm(stage.norm, tokens, 1e-6)
        x = tokens.reshape(b, h, w, -1)
        feats.append(x)
    return feats


def segformer_is_forward(p: SegformerISModel, cfg: SegformerISConfig,
                         image: torch.Tensor, points: torch.Tensor,
                         coord_bias=None, **_) -> Dict[str, torch.Tensor]:
    rgb, coords = is_inputs(image, points, cfg.norm_radius, cfg.use_disks,
                            cfg.with_prev_mask, cfg.dtype,
                            coord_bias=coord_bias)
    feats = segformer_backbone(p, cfg, torch.cat([rgb, coords], -1))
    th, tw = feats[0].shape[1], feats[0].shape[2]
    outs = []
    for f, lin in zip(feats, p.head.linears):
        b, h, w, d = f.shape
        y = nn.linear(lin, f.reshape(b, h * w, d)).reshape(b, h, w, -1)
        outs.append(bilinear_resize(y, th, tw, align_corners=False))
    fused = conv_bn_relu(p.head.fuse, torch.cat(outs, -1))
    seg = nn.conv1x1(p.head.cls, fused)
    hh, ww = image.shape[1], image.shape[2]
    return {"instances": bilinear_resize(seg, hh, ww, align_corners=True),
            "instances_aux": None}
