"""PlainVit / SimpleClick: the VPU model without prompts and DMA
(pvpuformer_tpu/models/plainvit.py; reference is_plainvit_model.py).

The MAE ViT backbone with the coord patch embed, the SimpleFPN's four conv
branches all fed from the raw backbone map (no two-way transformer), and the
SegFormer head without P2CL; clicks enter only through the disk maps. The
backbone's blocks are the VPU model's: on CUDA every block runs the
hand-written attention kernel (fused, or flash under attn_impl="flash") and
the LN+MLP kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn as tnn

from .. import nn
from ..ops.distmaps import dist_maps
from ..ops.resize import bilinear_resize
from .fpn import Neck, NeckConfig, _down4, _down8, _down16, _down32
from .seg_head import Head, HeadConfig, head_forward
from .vit import ViT, ViTConfig, vit_backbone_forward
from .vpu import IMAGENET_MEAN, IMAGENET_STD, prepare_input


@dataclasses.dataclass(frozen=True)
class PlainVitConfig:
    backbone: ViTConfig = ViTConfig()
    neck: NeckConfig = NeckConfig()
    head: HeadConfig = dataclasses.field(
        default_factory=lambda: HeadConfig(ed_loss=False))
    num_max_points: int = 24
    norm_radius: float = 5.0
    use_disks: bool = True
    with_prev_mask: bool = True
    random_split: bool = False
    dtype: Any = torch.float32

    @property
    def crop_size(self) -> Tuple[int, int]:
        return self.backbone.img_size

    def replace(self, **kw) -> "PlainVitConfig":
        return dataclasses.replace(self, **kw)


class PlainVitModel(tnn.Module):
    """The JAX `init_plainvit` tree; `generator=None` leaves the weights
    zero, for loading."""

    def __init__(self, cfg: PlainVitConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.cfg = cfg
        self.backbone = ViT(cfg.backbone, g)
        self.patch_embed_coords = nn.PatchEmbed(
            cfg.backbone.patch_size, 3 if cfg.with_prev_mask else 2,
            cfg.backbone.embed_dim, init="torch", g=g)
        self.neck = Neck(cfg.neck, cfg.backbone.grid_size, g, prompts=False)
        self.head = Head(cfg.head, g)
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN),
                             persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD),
                             persistent=False)

    def forward(self, image, points, **kw):
        return plainvit_forward(self, self.cfg, image, points, **kw)


def init_plainvit(cfg: PlainVitConfig, generator: torch.Generator,
                  device=None) -> PlainVitModel:
    """Seeded random weights, built on the CPU and moved to `device` (None:
    the card)."""
    return PlainVitModel(cfg, generator).to(nn.resolve_device(device))


def plainvit_forward(p: PlainVitModel, cfg: PlainVitConfig,
                     image: torch.Tensor, points: torch.Tensor,
                     coord_bias: Optional[torch.Tensor] = None,
                     shuffle_noise: Optional[torch.Tensor] = None,
                     **_) -> Dict[str, Optional[torch.Tensor]]:
    """image (B, H, W, 3|4), points (B, 2N, 3) -> {"instances": (B, H, W, 1)
    logits, "instances_aux": None}. Prompt keywords (boxes, scribbles,
    prompt_type, ppue_points) are accepted and ignored, as in JAX.
    `shuffle_noise` (depth, B, N) runs the token shuffle mode
    (models/vit.py); `cfg.random_split` is read and otherwise inert, as in
    JAX."""
    image = image.to(cfg.dtype)
    rgb, prev_mask = prepare_input(p, cfg, image)
    h, w = rgb.shape[1], rgb.shape[2]
    disks = dist_maps(points, h, w, norm_radius=cfg.norm_radius,
                      use_disks=cfg.use_disks).to(cfg.dtype)
    if coord_bias is not None:                 # DistMap-BRS
        disks = disks + coord_bias.to(cfg.dtype)
    coords = torch.cat([prev_mask, disks], -1) if prev_mask is not None \
        else disks
    add = nn.patch_embed(p.patch_embed_coords, coords, cfg.backbone.patch_size)
    tokens = vit_backbone_forward(p.backbone, cfg.backbone, rgb,
                                  additional=add, shuffle_noise=shuffle_noise)
    b, _, c = tokens.shape
    gh, gw = cfg.backbone.grid_size
    fmap = tokens.reshape(b, gh, gw, c)
    ms = [_down4(p.neck.down4, fmap), _down8(p.neck.down8, fmap),
          _down16(p.neck.down16, fmap), _down32(p.neck.down32, fmap)]
    seg, _ = head_forward(p.head, cfg.head, ms, None)
    return {"instances": bilinear_resize(seg, h, w, align_corners=True),
            "instances_aux": None}
