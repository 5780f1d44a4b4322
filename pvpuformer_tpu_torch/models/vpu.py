"""The VPU model: ViT backbone + PPuE prompts + DMA neck + SegFormer head
(pvpuformer_tpu/models/vpu.py), click, box and scribble prompts, with the
optional CLIP text tower of caption co-training.

forward(image (B, H, W, 4), points (B, 2N, 3), [boxes / scribbles],
prompt_type):
  1. split the prev-mask channel, ImageNet-normalize RGB;
  2. coord features = [prev_mask, pos-disk, neg-disk], with the box outline
     or the scribble stroke drawn into the disks (prompt_type 1 / 2);
  3. patch-embed image + coord features, ViT blocks with window patchify;
  4. PPuE prompt vectors by type; DMA neck -> multi-scale features + q_out;
     head;
  5. bilinear align_corners=True upsample to the input size.

Caption co-training (`VPUConfig.text`, a `ClipTextConfig`): the model
carries `clip_text` and `caption_proj` (text embed_dim -> neck width), and
`captions` (B, context_length) token ids enter the neck as one extra DMA
query each (`caption_queries`). `random_split` is read and otherwise
inert, as in JAX: the token shuffle runs where a caller passes
`shuffle_noise` (models/vit.py).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn as tnn

from .. import nn
from ..utils import profiling
from ..ops.distmaps import dist_maps
from ..ops.ppue import PPuEConfig, ppue_box, ppue_click, ppue_scribble
from ..ops.rasterize import draw_box_into_coords, draw_scribble_into_coords
from ..ops.resize import bilinear_resize
from .fpn import Neck, NeckConfig, neck_forward
from .seg_head import Head, HeadConfig, head_forward
from .two_way import TwoWayConfig
from .vit import ViT, ViTConfig, vit_backbone_forward
from .zoo.clip_text import ClipText, encode_text

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class VPUConfig:
    backbone: ViTConfig = ViTConfig()
    neck: NeckConfig = NeckConfig()
    head: HeadConfig = HeadConfig()
    text: Optional[Any] = None           # zoo.clip_text.ClipTextConfig
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


def _vpu_config(crop, upsample, dtype, patch: int, dim: int, depth: int,
                heads: int) -> VPUConfig:
    channels = {"x1": 256, "x2": 128, "x4": 64}[upsample]
    return VPUConfig(
        backbone=ViTConfig(img_size=crop, patch_size=(patch, patch),
                           in_chans=3, embed_dim=dim, depth=depth,
                           num_heads=heads),
        neck=NeckConfig(in_dim=dim, out_dims=(128, 256, 512, 1024),
                        img_size=crop, two_way=TwoWayConfig(embedding_dim=dim)),
        head=HeadConfig(in_channels=(128, 256, 512, 1024), channels=channels,
                        upsample=upsample, d_model=dim),
        dtype=dtype)


def vpu_base_config(crop: Tuple[int, int] = (448, 448), upsample: str = "x1",
                    dtype: Any = torch.float32) -> VPUConfig:
    """The shipped ViT-B training config (vpu_base448_cocolvis.py:11-61)."""
    return _vpu_config(crop, upsample, dtype, 16, 768, 12, 12)


def vpu_large_config(crop: Tuple[int, int] = (448, 448), upsample: str = "x1",
                     dtype: Any = torch.float32) -> VPUConfig:
    """ViT-L (pvpuformer_tpu/models/vpu.py:90-103): D 1024, 24 blocks, 16
    heads, 16x16 patches."""
    return _vpu_config(crop, upsample, dtype, 16, 1024, 24, 16)


def vpu_huge_config(crop: Tuple[int, int] = (448, 448), upsample: str = "x1",
                    dtype: Any = torch.float32) -> VPUConfig:
    """ViT-H (pvpuformer_tpu/models/vpu.py:106-120): D 1280, 32 blocks, 16
    heads (head dim 80), 14x14 patches: a 448 crop is a 32x32 token grid in
    2x2 windows of 16x16 tokens."""
    return _vpu_config(crop, upsample, dtype, 14, 1280, 32, 16)


class VPUModel(tnn.Module):
    """Parameters with the JAX `init_vpu` tree (state_dict names map 1:1 onto
    the JAX checkpoint names), including the leaves the forward does not use
    (pe_gaussian, point_embeddings, not_a_point_embed, head_aux) so that a
    checkpoint loads strictly, and, with `cfg.text`, the text tower
    `clip_text` and `caption_proj`. `generator=None` leaves every weight
    zero (for loading)."""

    def __init__(self, cfg: VPUConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
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
        if cfg.text is not None:
            self.clip_text = ClipText(cfg.text, g)
            self.caption_proj = nn.Linear(cfg.text.embed_dim,
                                          cfg.neck.in_dim, g=g)
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN),
                             persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD),
                             persistent=False)

    def forward(self, image: torch.Tensor, points: torch.Tensor,
                boxes: Optional[torch.Tensor] = None,
                scribbles: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                prompt_type: int = 0,
                ppue_points: Optional[torch.Tensor] = None,
                cfg: Optional[VPUConfig] = None,
                captions: Optional[torch.Tensor] = None,
                shuffle_noise: Optional[torch.Tensor] = None
                ) -> Dict[str, Optional[torch.Tensor]]:
        """`vpu_forward` (the definition) through the module's call, where
        FSDP gathers the root's sharded parameters; `cfg` (default: the
        model's) may change the compute dtype, as the training config's
        does."""
        return vpu_forward(self, self.cfg if cfg is None else cfg, image,
                           points, boxes, scribbles, prompt_type, ppue_points,
                           captions=captions, shuffle_noise=shuffle_noise)


def init_vpu(cfg: VPUConfig, generator: torch.Generator,
             device=None) -> VPUModel:
    """Seeded random weights with the JAX init families (xavier, kaiming,
    normal); the numbers differ from JAX's by design. The model is built on
    the CPU from the CPU `generator` and moved to `device` (None: the card;
    pass device="cpu" to stay on the CPU)."""
    dev = nn.resolve_device(device)
    return VPUModel(cfg, generator).to(dev)


def prepare_input(p: VPUModel, cfg: VPUConfig, image: torch.Tensor):
    """(B, H, W, 3|4) -> normalized rgb, prev_mask (is_model.py:59-66).
    The division by the constant std is an f32 product with its reciprocal,
    rounded once to the image dtype: XLA compiles JAX's so, and the int8
    path's per-row rounding turns a last-bit difference here into whole
    quanta."""
    prev_mask = None
    if cfg.with_prev_mask:
        prev_mask = image[..., 3:4]
        image = image[..., :3]
    inv_std = 1.0 / p.std.to(image.dtype).float()
    rgb = (image - p.mean.to(image.dtype)).float() * inv_std
    return rgb.to(image.dtype), prev_mask


def coord_features(cfg: VPUConfig, image: torch.Tensor, prev_mask,
                   points: torch.Tensor, boxes=None, scribbles=None,
                   prompt_type: int = 0, coord_bias=None) -> torch.Tensor:
    """[prev_mask, pos, neg] channels (is_model.py:78-95), with the box
    outline (prompt_type 1) or the scribble stroke (2) drawn into the disks.
    `scribbles` = ((B, 1, S, 2), (B, 1, 4)) in the trainer layout.
    `coord_bias` (B, H, W, 2), when given, is added to the two disk channels
    only: DistMap-BRS's optimization target (reference brs.py:272-276)."""
    h, w = image.shape[1], image.shape[2]
    disks = dist_maps(points, h, w, norm_radius=cfg.norm_radius,
                      use_disks=cfg.use_disks).to(image.dtype)
    if coord_bias is not None:
        disks = disks + coord_bias.to(image.dtype)
    if prompt_type == 1 and boxes is not None:
        disks = draw_box_into_coords(disks, boxes, points.shape[1] // 2)
    elif prompt_type == 2 and scribbles is not None:
        disks = draw_scribble_into_coords(disks, scribbles[0][:, 0])
    if prev_mask is not None:
        return torch.cat([prev_mask, disks], -1)
    return disks


def caption_queries(p: VPUModel, cfg: VPUConfig,
                    captions: Optional[torch.Tensor]
                    ) -> Optional[torch.Tensor]:
    """(B, context_length) caption token ids -> (B, 1, neck width) extra DMA
    queries: the CLIP text embedding (in the tower's parameter dtype)
    through `caption_proj` in the compute dtype. None without a text tower
    or without captions."""
    if captions is None or cfg.text is None:
        return None
    emb = encode_text(p.clip_text, cfg.text, captions)
    return nn.linear(p.caption_proj, emb.to(cfg.dtype))[:, None]


def vpu_backbone_embed(p: VPUModel, cfg: VPUConfig, rgb: torch.Tensor,
                       coords: torch.Tensor,
                       shuffle_noise: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Image + coord patch embeddings through the ViT (is_vpu_model.py:
    385-386): (B, H, W, 3) normalized rgb, (B, H, W, 3) coords -> (B, N, D)
    tokens; `shuffle_noise` as in `vit_backbone_forward`."""
    add = nn.patch_embed(p.patch_embed_coords, coords, cfg.backbone.patch_size)
    return vit_backbone_forward(p.backbone, cfg.backbone, rgb, additional=add,
                                shuffle_noise=shuffle_noise)


def vpu_forward(p: VPUModel, cfg: VPUConfig, image: torch.Tensor,
                points: torch.Tensor, boxes: Optional[torch.Tensor] = None,
                scribbles: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                prompt_type: int = 0,
                ppue_points: Optional[torch.Tensor] = None,
                coord_bias: Optional[torch.Tensor] = None,
                captions: Optional[torch.Tensor] = None,
                shuffle_noise: Optional[torch.Tensor] = None
                ) -> Dict[str, Optional[torch.Tensor]]:
    """Returns {"instances": (B, H, W, 1) logits, "instances_aux":
    (B, H, W, 2*num_max_points) P2CL maps}. `prompt_type` (0 click, 1 box,
    2 scribble) selects the PPuE encoder; boxes (B, 5) and scribbles
    ((B, 1, S, 2), (B, 1, 4)) as in the JAX package. `ppue_points`
    replaces the clicks fed to the PPuE encoders only (the disks keep
    `points`): the prompt session's extra error click. `coord_bias`
    (B, H, W, 2) perturbs the disk channels (DistMap-BRS). `captions`
    (B, context_length) token ids feed the text tower (`caption_queries`);
    `shuffle_noise` (depth, B, N) runs the token shuffle mode."""
    image = image.to(cfg.dtype)
    rgb, prev_mask = prepare_input(p, cfg, image)
    coords = coord_features(cfg, rgb, prev_mask, points, boxes, scribbles,
                            prompt_type, coord_bias)
    profiling.stage("backbone")
    tokens = vpu_backbone_embed(p, cfg, rgb, coords, shuffle_noise)
    profiling.stage("neck")
    ppts = points if ppue_points is None else ppue_points
    if prompt_type == 0:
        pv = ppue_click(ppts, cfg.ppue, num_max_points=cfg.num_max_points)
    elif prompt_type == 1:
        pv = ppue_box(ppts, boxes, cfg.ppue, num_max_points=cfg.num_max_points)
    else:
        pv = ppue_scribble(ppts, scribbles[0][:, 0], scribbles[1][:, 0],
                           cfg.ppue, num_max_points=cfg.num_max_points)
    ms_feats, q_out = neck_forward(p.neck, cfg.neck, tokens, pv.to(cfg.dtype),
                                   cfg.backbone.grid_size,
                                   caption_queries(p, cfg, captions))
    profiling.stage("head")
    seg, pcl = head_forward(p.head, cfg.head, ms_feats, q_out)
    h, w = image.shape[1], image.shape[2]
    aux = None
    if cfg.with_aux_output and pcl is not None:
        aux = bilinear_resize(pcl, h, w, align_corners=True)
    return {"instances": bilinear_resize(seg, h, w, align_corners=True),
            "instances_aux": aux}
