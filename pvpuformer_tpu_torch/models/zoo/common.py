"""Shared pieces of the zoo (pvpuformer_tpu/models/zoo/common.py).

* `frozen_bn`: batch norm with stored statistics (leaves scale / bias /
  mean / var), torch's eval-mode BatchNorm2d;
* `conv_bn_relu`: conv + frozen BN (+ ReLU);
* `maps_transform`: RITM's coord-feature adapter (conv1x1 16, (Leaky)ReLU,
  3x3 stride-2 conv 64, a learned scalar scale);
* `is_inputs`: ImageNet normalization and the [prev_mask, pos, neg] coord
  channels every zoo model takes.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn as tnn

from ... import nn
from ...ops.distmaps import dist_maps

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class FrozenBN(tnn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.scale = nn.param(torch.ones(channels))
        self.bias = nn.param(torch.zeros(channels))
        self.mean = nn.param(torch.zeros(channels))
        self.var = nn.param(torch.ones(channels))


def frozen_bn(p: FrozenBN, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x * scale + bias with the folded affine computed in f32 and cast to
    x's dtype (JAX `frozen_bn`)."""
    inv = torch.rsqrt(p.var.float() + eps)
    scale = (p.scale.float() * inv).to(x.dtype)
    bias = (p.bias.float() - p.mean.float() * p.scale.float() * inv).to(x.dtype)
    return x * scale + bias


def conv_bn(kh: int, kw: int, cin: int, cout: int, g=None, bias: bool = False,
            groups: int = 1) -> nn.Node:
    """JAX `init_conv_bn`: {conv, bn}."""
    return nn.Node(conv=nn.Conv(kh, kw, cin, cout, g, bias=bias,
                                groups=groups),
                   bn=FrozenBN(cout))


def conv_bn_relu(p, x: torch.Tensor, stride: int = 1, relu: bool = True,
                 padding="TORCH") -> torch.Tensor:
    y = frozen_bn(p.bn, nn.conv2d(p.conv, x, stride=stride, padding=padding))
    return torch.relu(y) if relu else y


class MapsTransform(tnn.Module):
    def __init__(self, in_ch: int, g=None):
        super().__init__()
        self.conv1 = nn.Conv(1, 1, in_ch, 16, g)
        self.conv2 = nn.Conv(3, 3, 16, 64, g)
        self.scale = nn.param(torch.tensor(0.05))


def maps_transform(p: MapsTransform, coords: torch.Tensor,
                   leaky: bool = False) -> torch.Tensor:
    x = nn.conv1x1(p.conv1, coords)
    x = F.leaky_relu(x, 0.2) if leaky else torch.relu(x)
    x = nn.conv2d(p.conv2, x, stride=2)
    return x * p.scale.to(x.dtype)


def _consts(values, dtype, device) -> torch.Tensor:
    """A small constant vector made on `device` by fills (no host copy, so
    a CUDA graph can capture it)."""
    return torch.stack([torch.full((), v, dtype=dtype, device=device)
                        for v in values])


def normalize(image: torch.Tensor) -> torch.Tensor:
    """ImageNet normalization in the image dtype: (x - mean) in that dtype,
    times the f32 reciprocal of std, rounded once (the product XLA
    compiles JAX's division by the constant into; `vpu.prepare_input`)."""
    mean = _consts(IMAGENET_MEAN, image.dtype, image.device)
    inv_std = 1.0 / _consts(IMAGENET_STD, image.dtype, image.device).float()
    return ((image - mean).float() * inv_std).to(image.dtype)


def is_inputs(image: torch.Tensor, points: torch.Tensor, norm_radius: float,
              use_disks: bool, with_prev_mask: bool, dtype,
              coord_bias: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W, 3|4) + clicks -> (normalized rgb, coord channels).
    `coord_bias` (B, H, W, 2) is added to the disk channels only
    (DistMap-BRS)."""
    image = image.to(dtype)
    prev_mask = None
    if with_prev_mask:
        prev_mask = image[..., 3:4]
        image = image[..., :3]
    rgb = normalize(image)
    h, w = rgb.shape[1], rgb.shape[2]
    disks = dist_maps(points, h, w, norm_radius=norm_radius,
                      use_disks=use_disks).to(dtype)
    if coord_bias is not None:
        disks = disks + coord_bias.to(dtype)
    coords = torch.cat([prev_mask, disks], -1) if prev_mask is not None \
        else disks
    return rgb, coords
