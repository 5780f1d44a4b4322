"""SegFormer-style all-MLP head with the P2CL cosine branch
(pvpuformer_tpu/models/seg_head.py). Dropout is off, in inference and in
training alike: the JAX train step passes no dropout key
(pvpuformer_tpu/engine/train_step.py:113-114), so its head never drops."""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import torch
from torch import nn as tnn

from .. import nn
from ..ops.resize import bilinear_resize


@dataclasses.dataclass(frozen=True)
class HeadConfig:
    in_channels: Tuple[int, ...] = (128, 256, 512, 1024)
    channels: int = 256
    num_classes: int = 1
    dropout_ratio: float = 0.1
    upsample: str = "x1"
    align_corners: bool = False
    d_model: int = 768
    ed_loss: bool = True

    @property
    def out_channels(self) -> int:
        return {"x1": self.channels, "x2": self.channels * 2,
                "x4": self.channels * 4}[self.upsample]


def _up_stage(c_in: int, c_out: int, g) -> nn.Node:
    return nn.Node(deconv=nn.Deconv2x2(c_in, c_out, g), gn1=nn.Norm(c_out),
                   conv=nn.Conv(1, 1, c_out, c_out, g), gn2=nn.Norm(c_out))


class Head(tnn.Module):
    def __init__(self, cfg: HeadConfig, g: Optional[torch.Generator] = None):
        super().__init__()
        oc = cfg.out_channels
        n = len(cfg.in_channels)
        self.convs = tnn.ModuleList(nn.Conv(1, 1, c, oc, g)
                                    for c in cfg.in_channels)
        self.fusion = nn.Conv(1, 1, oc * n, oc, g)
        self.conv_seg = nn.Conv(1, 1, cfg.channels, cfg.num_classes, g)
        if cfg.upsample in ("x2", "x4"):
            self.up1 = _up_stage(oc, oc // 2, g)
        if cfg.upsample == "x4":
            self.up2 = _up_stage(oc // 2, oc // 4, g)
        if cfg.ed_loss:
            self.logit_scale = nn.param(torch.tensor(math.log(1.0 / 0.07)))
            self.ffn = nn.Mlp(cfg.d_model, cfg.d_model * 2, oc, g=g)


def _up_forward(p, x):
    x = nn.group_norm1(p.gn1, nn.deconv2x2(p.deconv, x))
    return nn.gelu(nn.group_norm1(p.gn2, nn.conv1x1(p.conv, x)))


def _fuse(p: Head, cfg: HeadConfig, inputs: List[torch.Tensor]) -> torch.Tensor:
    th, tw = inputs[0].shape[1], inputs[0].shape[2]
    outs = [bilinear_resize(torch.relu(nn.conv1x1(conv, x)), th, tw,
                            align_corners=cfg.align_corners)
            for x, conv in zip(inputs, p.convs)]
    out = torch.relu(nn.conv1x1(p.fusion, torch.cat(outs, -1)))
    if cfg.upsample in ("x2", "x4"):
        out = _up_forward(p.up1, out)
    if cfg.upsample == "x4":
        out = _up_forward(p.up2, out)
    return out


def head_forward(p: Head, cfg: HeadConfig, inputs: List[torch.Tensor],
                 q_out: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """4 NHWC maps + DMA queries (B, L, d_model) -> (seg logits (B, h, w, 1),
    P2CL maps (B, h, w, L) or None)."""
    out = _fuse(p, cfg, inputs)
    b, h, w, c = out.shape
    logits = None
    if cfg.ed_loss and q_out is not None:
        query = nn.mlp(p.ffn, q_out.to(out.dtype), act=torch.relu)
        feat = out.reshape(b, h * w, c)
        qn = query * torch.rsqrt(query.float().square().sum(-1, keepdim=True)
                                 + 1e-24).to(query.dtype)
        fn_ = feat * torch.rsqrt(feat.float().square().sum(-1, keepdim=True)
                                 + 1e-24).to(feat.dtype)
        sim = torch.einsum("blc,bnc->bnl", qn, fn_)
        logits = ((sim + 1.0) / 2.0).reshape(b, h, w, -1)
    return nn.conv1x1(p.conv_seg, out), logits
