"""SimpleFPN neck with Dual-cross Merging Attention gating
(pvpuformer_tpu/models/fpn.py).

An FFN projects the (2W+3)-dim PPuE prompt vectors to the neck width; the
two-way transformer yields per-depth (queries, keys); channel and token
gates modulate the backbone tokens; four conv branches give strides
4/8/16/32 (NHWC).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
from torch import nn as tnn

from .. import nn
from .two_way import TwoWay, TwoWayConfig, two_way_forward


@dataclasses.dataclass(frozen=True)
class NeckConfig:
    in_dim: int = 768
    out_dims: Tuple[int, int, int, int] = (128, 256, 512, 1024)
    img_size: Tuple[int, int] = (448, 448)
    hide_dim: int = 1024
    two_way: TwoWayConfig = TwoWayConfig()

    @property
    def prompt_dim(self) -> int:
        return self.img_size[0] * 2 + 3

    @property
    def down4_chan(self) -> int:
        return max(self.out_dims[0] * 2, self.in_dim // 2)

    @property
    def down8_chan(self) -> int:
        return max(self.out_dims[1], self.in_dim // 2)

    @property
    def down32_chan(self) -> int:
        return max(self.out_dims[3], self.in_dim * 2)


class Neck(tnn.Module):
    def __init__(self, cfg: NeckConfig, grid_hw: Tuple[int, int],
                 g: Optional[torch.Generator] = None):
        super().__init__()
        d, od = cfg.in_dim, cfg.out_dims
        c4, c8, c32 = cfg.down4_chan, cfg.down8_chan, cfg.down32_chan
        self.ffn = nn.Mlp(cfg.prompt_dim, cfg.hide_dim * 2, d, g=g)
        self.att = TwoWay(cfg.two_way, grid_hw, g)
        self.down4 = nn.Node(
            deconv1=nn.Deconv2x2(d, c4, g), gn1=nn.Norm(c4),
            deconv2=nn.Deconv2x2(c4, c4 // 2, g), gn2=nn.Norm(c4 // 2),
            conv=nn.Conv(1, 1, c4 // 2, od[0], g), gn3=nn.Norm(od[0]))
        self.down8 = nn.Node(
            deconv=nn.Deconv2x2(d, c8, g), gn1=nn.Norm(c8),
            conv=nn.Conv(1, 1, c8, od[1], g), gn2=nn.Norm(od[1]))
        self.down16 = nn.Node(conv=nn.Conv(1, 1, d, od[2], g),
                              gn=nn.Norm(od[2]))
        self.down32 = nn.Node(
            conv1=nn.Conv(2, 2, d, c32, g), gn1=nn.Norm(c32),
            conv2=nn.Conv(1, 1, c32, od[3], g), gn2=nn.Norm(od[3]))


def _down4(p, x):
    x = nn.gelu(nn.group_norm1(p.gn1, nn.deconv2x2(p.deconv1, x)))
    x = nn.group_norm1(p.gn2, nn.deconv2x2(p.deconv2, x))
    return nn.gelu(nn.group_norm1(p.gn3, nn.conv1x1(p.conv, x)))


def _down8(p, x):
    x = nn.group_norm1(p.gn1, nn.deconv2x2(p.deconv, x))
    return nn.gelu(nn.group_norm1(p.gn2, nn.conv1x1(p.conv, x)))


def _down16(p, x):
    return nn.gelu(nn.group_norm1(p.gn, nn.conv1x1(p.conv, x)))


def _down32(p, x):
    x = nn.conv2d(p.conv1, x, stride=2, padding="VALID")
    x = nn.group_norm1(p.gn1, x)
    return nn.gelu(nn.group_norm1(p.gn2, nn.conv1x1(p.conv2, x)))


def neck_forward(p: Neck, cfg: NeckConfig, x: torch.Tensor, q: torch.Tensor,
                 grid_hw: Tuple[int, int]
                 ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """x (B, HW, C) backbone tokens; q (B, L, 2W+3) PPuE prompt vectors.
    Returns ([s4, s8, s16, s32] NHWC maps, q_out (B, L, C))."""
    if q.shape[-1] != x.shape[-1]:
        q = nn.mlp(p.ffn, q.to(x.dtype), act=torch.relu)
    b, n, c = x.shape
    (q_x2, x2_q), (q_x3, x3_q), (q_x4, x4_q) = two_way_forward(
        p.att, cfg.two_way, q, x)
    q_out = q + q_x2 + q_x3 + q_x4

    def gate(qi, ki):
        chan = torch.sigmoid(qi.amax(1))[:, None, :]     # (B, 1, C)
        tok = torch.sigmoid(ki.amax(2))[:, :, None]      # (B, N, 1)
        return x + x * chan + x * tok

    gh, gw = grid_hw
    to_map = lambda t: t.reshape(b, gh, gw, c)           # noqa: E731
    s4 = _down4(p.down4, to_map(x))
    s8 = _down8(p.down8, to_map(gate(q_x2, x2_q)))
    s16 = _down16(p.down16, to_map(gate(q_x3, x3_q)))
    s32 = _down32(p.down32, to_map(gate(q_x4, x4_q)))
    return [s4, s8, s16, s32], q_out
