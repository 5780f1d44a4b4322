"""The VPU model: ViT backbone + PPuE prompts + DMA neck + SegFormer head
(pvpuformer_tpu/models/vpu.py), click prompts (prompt_type 0).

forward(image (B, H, W, 4), points (B, 2N, 3)):
  1. split the prev-mask channel, ImageNet-normalize RGB;
  2. coord features = [prev_mask, pos-disk, neg-disk];
  3. patch-embed image + coord features, ViT blocks with window patchify;
  4. PPuE click vectors; DMA neck -> multi-scale features + q_out; head;
  5. bilinear align_corners=True upsample to the input size.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn as tnn

from .. import nn
from ..ops.distmaps import dist_maps
from ..ops.ppue import PPuEConfig, ppue_click
from ..ops.resize import bilinear_resize
from .fpn import Neck, NeckConfig, neck_forward
from .seg_head import Head, HeadConfig, head_forward
from .vit import ViT, ViTConfig, vit_backbone_forward

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class VPUConfig:
    backbone: ViTConfig = ViTConfig()
    neck: NeckConfig = NeckConfig()
    head: HeadConfig = HeadConfig()
    text: Optional[Any] = None           # caption tower: not ported
    num_max_points: int = 24
    norm_radius: float = 5.0
    use_disks: bool = True
    with_prev_mask: bool = True
    with_aux_output: bool = True
    random_split: bool = False
    dtype: Any = torch.float32           # activation / compute dtype

    @property
    def crop_size(self) -> Tuple[int, int]:
        return self.backbone.img_size

    @property
    def ppue(self) -> PPuEConfig:
        # pinned to the trained crop (neck.img_size), as in the JAX package
        return PPuEConfig(input_h=self.neck.img_size[0],
                          input_w=self.neck.img_size[1])

    def replace(self, **kw) -> "VPUConfig":
        return dataclasses.replace(self, **kw)


def vpu_base_config(crop: Tuple[int, int] = (448, 448), upsample: str = "x1",
                    dtype: Any = torch.float32) -> VPUConfig:
    """The shipped ViT-B training config (vpu_base448_cocolvis.py:11-61)."""
    channels = {"x1": 256, "x2": 128, "x4": 64}[upsample]
    return VPUConfig(
        backbone=ViTConfig(img_size=crop, patch_size=(16, 16), in_chans=3,
                           embed_dim=768, depth=12, num_heads=12),
        neck=NeckConfig(in_dim=768, out_dims=(128, 256, 512, 1024),
                        img_size=crop),
        head=HeadConfig(in_channels=(128, 256, 512, 1024), channels=channels,
                        upsample=upsample),
        dtype=dtype)


class VPUModel(tnn.Module):
    """Parameters with the JAX `init_vpu` tree (state_dict names map 1:1 onto
    the JAX checkpoint names), including the leaves the forward does not use
    (pe_gaussian, point_embeddings, not_a_point_embed, head_aux) so that a
    checkpoint loads strictly. `generator=None` leaves every weight zero (for
    loading)."""

    def __init__(self, cfg: VPUConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.text is not None:
            raise NotImplementedError("caption co-training (VPUConfig.text) is "
                                      "not ported")
        if cfg.random_split:
            raise NotImplementedError("random_split (token shuffle) is a "
                                      "training mode and is not ported")
        g = generator
        self.cfg = cfg
        d = cfg.backbone.embed_dim
        self.backbone = ViT(cfg.backbone, g)
        self.patch_embed_coords = nn.PatchEmbed(
            cfg.backbone.patch_size, 3 if cfg.with_prev_mask else 2, d,
            init="torch", g=g)
        self.neck = Neck(cfg.neck, cfg.backbone.grid_size, g)
        self.head = Head(cfg.head, g)
        self.pe_gaussian = nn.param(nn.normal_init((2, d // 2), g, std=1.0))
        self.point_embeddings = nn.param(nn.normal_init((4, d), g, std=1.0))
        self.not_a_point_embed = nn.param(nn.normal_init((1, d), g, std=1.0))
        if cfg.with_aux_output:
            self.head_aux = nn.Conv(1, 1, 128, 1, g)
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN),
                             persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD),
                             persistent=False)

    def forward(self, image: torch.Tensor, points: torch.Tensor,
                prompt_type: int = 0) -> Dict[str, Optional[torch.Tensor]]:
        return vpu_forward(self, self.cfg, image, points, prompt_type)


def init_vpu(cfg: VPUConfig, generator: torch.Generator,
             device=None) -> VPUModel:
    """Seeded random weights with the JAX init families (xavier, kaiming,
    normal); the numbers differ from JAX's by design."""
    model = VPUModel(cfg, generator)
    return model if device is None else model.to(device)


def prepare_input(p: VPUModel, cfg: VPUConfig, image: torch.Tensor):
    """(B, H, W, 3|4) -> normalized rgb, prev_mask (is_model.py:59-66)."""
    prev_mask = None
    if cfg.with_prev_mask:
        prev_mask = image[..., 3:4]
        image = image[..., :3]
    return (image - p.mean.to(image.dtype)) / p.std.to(image.dtype), prev_mask


def coord_features(cfg: VPUConfig, image: torch.Tensor, prev_mask,
                   points: torch.Tensor) -> torch.Tensor:
    """[prev_mask, pos, neg] channels (is_model.py:78-95)."""
    h, w = image.shape[1], image.shape[2]
    disks = dist_maps(points, h, w, norm_radius=cfg.norm_radius,
                      use_disks=cfg.use_disks).to(image.dtype)
    if prev_mask is not None:
        return torch.cat([prev_mask, disks], -1)
    return disks


def vpu_forward(p: VPUModel, cfg: VPUConfig, image: torch.Tensor,
                points: torch.Tensor, prompt_type: int = 0
                ) -> Dict[str, Optional[torch.Tensor]]:
    """Returns {"instances": (B, H, W, 1) logits, "instances_aux":
    (B, H, W, 2*num_max_points) P2CL maps}."""
    if prompt_type != 0:
        raise NotImplementedError("box / scribble prompts are not ported yet "
                                  "(ROADMAP Queue 1 item 9)")
    image = image.to(cfg.dtype)
    rgb, prev_mask = prepare_input(p, cfg, image)
    coords = coord_features(cfg, rgb, prev_mask, points)
    add = nn.patch_embed(p.patch_embed_coords, coords, cfg.backbone.patch_size)
    tokens = vit_backbone_forward(p.backbone, cfg.backbone, rgb, additional=add)
    pv = ppue_click(points, cfg.ppue, num_max_points=cfg.num_max_points)
    ms_feats, q_out = neck_forward(p.neck, cfg.neck, tokens, pv.to(cfg.dtype),
                                   cfg.backbone.grid_size)
    seg, pcl = head_forward(p.head, cfg.head, ms_feats, q_out)
    h, w = image.shape[1], image.shape[2]
    aux = None
    if cfg.with_aux_output and pcl is not None:
        aux = bilinear_resize(pcl, h, w, align_corners=True)
    return {"instances": bilinear_resize(seg, h, w, align_corners=True),
            "instances_aux": aux}
