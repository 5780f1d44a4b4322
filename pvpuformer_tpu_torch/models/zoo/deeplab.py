"""DeepLabV3+ (ResNet-V1b) interactive-segmentation model
(pvpuformer_tpu/models/zoo/deeplab.py; RITM's is_deeplab_model.py,
deeplab_v3.py, resnetv1b.py).

ResNet-50/101 take the deep "v1s" stem, ResNet-34 a 7x7 one; the RITM
coord features are zero-padded to the stem width and added after it, before
the max pool; the trunk is dilated to output stride 8 (layer3 dilation 2,
layer4 dilation 4, each layer's first block at half its dilation); ASPP at
rates 12 / 24 / 36 with image pooling; the decoder joins the stride-4 skip;
a separable-conv head gives one logit. `deeplab_backbone`,
`deeplab_aspp_concat`, `deeplab_decoder` and `deeplab_seg_head` stay split
for f-BRS's after_c4 / after_aspp / after_deeplab insertions.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn as tnn

from ... import nn
from ...ops.resize import bilinear_resize
from .common import (FrozenBN, MapsTransform, conv_bn, conv_bn_relu,
                     frozen_bn, is_inputs, maps_transform)

# layers per stage; block type; stem
RESNET_SPECS = {
    "resnet34": ((3, 4, 6, 3), "basic", "7x7"),
    "resnet50": ((3, 4, 6, 3), "bottleneck", "deep"),
    "resnet101": ((3, 4, 23, 3), "bottleneck", "deep"),
}

ASPP_RATES = (12, 24, 36)


@dataclasses.dataclass(frozen=True)
class DeeplabISConfig:
    backbone: str = "resnet50"
    ch: int = 256
    num_max_points: int = 24
    norm_radius: float = 5.0
    use_disks: bool = True
    with_prev_mask: bool = True
    use_leaky_relu: bool = True
    dtype: Any = torch.float32

    @property
    def expansion(self) -> int:
        return 1 if RESNET_SPECS[self.backbone][1] == "basic" else 4

    @property
    def stem_out(self) -> int:
        return 64 if RESNET_SPECS[self.backbone][2] == "7x7" else 128

    def replace(self, **kw) -> "DeeplabISConfig":
        return dataclasses.replace(self, **kw)


# ----------------------------------------------------------------- blocks

def _conv_bn_at(p, x, stride: int, dilation: int, relu: bool = True):
    """conv_bn_relu at a dilation (3x3, padding = dilation, stride 1 when
    dilated: JAX's `_dilated_conv_bn`)."""
    if dilation == 1:
        return conv_bn_relu(p, x, stride=stride, relu=relu)
    y = frozen_bn(p.bn, nn.conv2d(p.conv, x, dilation=dilation))
    return torch.relu(y) if relu else y


def _bottleneck_params(cin, planes, downsample: bool, g=None) -> nn.Node:
    kids = dict(c1=conv_bn(1, 1, cin, planes, g),
                c2=conv_bn(3, 3, planes, planes, g),
                c3=conv_bn(1, 1, planes, planes * 4, g))
    if downsample:
        kids["down"] = conv_bn(1, 1, cin, planes * 4, g)
    return nn.Node(**kids)


def _bottleneck(p, x, stride: int, dilation: int):
    """BottleneckV1b: conv2 carries the stride and dilation."""
    res = x
    y = conv_bn_relu(p.c1, x)
    y = _conv_bn_at(p.c2, y, stride, dilation)
    y = conv_bn_relu(p.c3, y, relu=False)
    if hasattr(p, "down"):
        res = conv_bn_relu(p.down, x, stride=stride, relu=False)
    return torch.relu(res + y)


def _basic_params(cin, planes, downsample: bool, g=None) -> nn.Node:
    kids = dict(c1=conv_bn(3, 3, cin, planes, g),
                c2=conv_bn(3, 3, planes, planes, g))
    if downsample:
        kids["down"] = conv_bn(1, 1, cin, planes, g)
    return nn.Node(**kids)


def _basic(p, x, stride: int, dilation: int, prev_dilation: int):
    """BasicBlockV1b: conv1 at `dilation`, conv2 always at the layer's."""
    res = x
    y = _conv_bn_at(p.c1, x, stride, dilation)
    y = _conv_bn_at(p.c2, y, 1, prev_dilation, relu=False)
    if hasattr(p, "down"):
        res = conv_bn_relu(p.down, x, stride=stride, relu=False)
    return torch.relu(res + y)


def _layer_params(block, cin, planes, blocks, expansion, stride=1,
                  g=None) -> tnn.ModuleList:
    """`_make_layer`: block 0 gets a 1x1 projection only when stride != 1
    or cin != planes * expansion."""
    out = planes * expansion
    need_down = stride != 1 or cin != out
    make = _bottleneck_params if block == "bottleneck" else _basic_params
    return tnn.ModuleList(make(cin if j == 0 else out, planes,
                               j == 0 and need_down, g)
                          for j in range(blocks))


def _layer(ps, x, block: str, stride: int, dilation: int = 1):
    """First block at `stride` and dilation // 2 (1 if dilation <= 2), the
    rest at stride 1 and the full dilation."""
    first_d = 1 if dilation in (1, 2) else dilation // 2
    for j, p in enumerate(ps):
        if block == "bottleneck":
            x = _bottleneck(p, x, stride if j == 0 else 1,
                            first_d if j == 0 else dilation)
        else:
            x = _basic(p, x, stride if j == 0 else 1,
                       first_d if j == 0 else dilation, dilation)
    return x


# ----------------------------------------------------------------- heads

def _sep_params(cin, cout, g=None) -> nn.Node:
    """SeparableConv2d: depthwise 3x3 and pointwise 1x1 (no biases), BN,
    ReLU."""
    return nn.Node(dw=nn.Conv(3, 3, cin, cin, g, bias=False, groups=cin),
                   pw=nn.Conv(1, 1, cin, cout, g, bias=False),
                   bn=FrozenBN(cout))


def _sep(p, x):
    y = nn.conv2d(p.dw, x, groups=x.shape[-1])
    y = nn.conv1x1(p.pw, y)
    return torch.relu(frozen_bn(p.bn, y))


class DeeplabISModel(tnn.Module):
    """The JAX `init_deeplab_is` tree; `generator=None` leaves the weights
    zero, for loading."""

    def __init__(self, cfg: DeeplabISConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.cfg = cfg
        layers, block, stem = RESNET_SPECS[cfg.backbone]
        exp, ch = cfg.expansion, cfg.ch
        aspp_in, skip_in = 512 * exp, 64 * exp
        self.maps_transform = MapsTransform(3 if cfg.with_prev_mask else 2, g)
        self.layer1 = _layer_params(block, cfg.stem_out, 64, layers[0], exp,
                                    1, g)
        self.layer2 = _layer_params(block, 64 * exp, 128, layers[1], exp, 2, g)
        self.layer3 = _layer_params(block, 128 * exp, 256, layers[2], exp, 1,
                                    g)
        self.layer4 = _layer_params(block, 256 * exp, 512, layers[3], exp, 1,
                                    g)
        self.aspp = nn.Node(
            b0=conv_bn(1, 1, aspp_in, ch, g), b1=conv_bn(3, 3, aspp_in, ch, g),
            b2=conv_bn(3, 3, aspp_in, ch, g), b3=conv_bn(3, 3, aspp_in, ch, g),
            pool=conv_bn(1, 1, aspp_in, ch, g),
            project=conv_bn(1, 1, ch * 5, ch, g))
        self.skip = conv_bn(1, 1, skip_in, 32, g)
        self.dhead = nn.Node(sep1=_sep_params(ch + 32, ch, g),
                             sep2=_sep_params(ch, ch, g),
                             cls=nn.Conv(1, 1, ch, ch, g))
        self.head = nn.Node(sep1=_sep_params(ch, ch // 2, g),
                            sep2=_sep_params(ch // 2, ch // 2, g),
                            cls=nn.Conv(1, 1, ch // 2, 1, g))
        if stem == "deep":
            self.stem = tnn.ModuleList([conv_bn(3, 3, 3, 64, g),
                                        conv_bn(3, 3, 64, 64, g),
                                        conv_bn(3, 3, 64, 128, g)])
        else:
            self.stem = tnn.ModuleList([conv_bn(7, 7, 3, 64, g)])

    def forward(self, image, points, **kw):
        return deeplab_is_forward(self, self.cfg, image, points, **kw)


def init_deeplab_is(cfg: DeeplabISConfig, generator: torch.Generator,
                    device=None) -> DeeplabISModel:
    return DeeplabISModel(cfg, generator).to(nn.resolve_device(device))


def _aspp(p, x):
    outs = [conv_bn_relu(p.b0, x)]
    for name, rate in zip(("b1", "b2", "b3"), ASPP_RATES):
        outs.append(_conv_bn_at(getattr(p, name), x, 1, rate))
    gp = x.mean((1, 2), keepdim=True)
    gp = conv_bn_relu(p.pool, gp)
    # the bilinear upsample of a 1x1 map (align_corners=True) broadcasts
    outs.append(gp.expand_as(outs[0]))
    return conv_bn_relu(p.project, torch.cat(outs, -1))


def deeplab_backbone(p: DeeplabISModel, cfg: DeeplabISConfig,
                     image: torch.Tensor, points: torch.Tensor,
                     coord_bias=None):
    """The trunk to (skip-projected c1, c4): f-BRS's after_c4 insertion
    point (c4 scaled, the skip cached)."""
    _, block, stem = RESNET_SPECS[cfg.backbone]
    rgb, coords = is_inputs(image, points, cfg.norm_radius, cfg.use_disks,
                            cfg.with_prev_mask, cfg.dtype,
                            coord_bias=coord_bias)
    extra = maps_transform(p.maps_transform, coords, leaky=cfg.use_leaky_relu)
    x = conv_bn_relu(p.stem[0], rgb, stride=2)
    if stem == "deep":
        x = conv_bn_relu(p.stem[1], x)
        x = conv_bn_relu(p.stem[2], x)
    pad = x.shape[-1] - extra.shape[-1]
    if pad > 0:                        # zero-padded up to the stem width
        extra = F.pad(extra, (0, pad))
    x = x + extra
    # MaxPool2d(3, stride=2, padding=1): -inf padding
    x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
    c1 = _layer(p.layer1, x, block, stride=1)                   # s4
    c2 = _layer(p.layer2, c1, block, stride=2)                  # s8
    c3 = _layer(p.layer3, c2, block, stride=1, dilation=2)      # s8 d2
    c4 = _layer(p.layer4, c3, block, stride=1, dilation=4)      # s8 d4
    return conv_bn_relu(p.skip, c1), c4


def deeplab_aspp_concat(p: DeeplabISModel, c4: torch.Tensor,
                        skip: torch.Tensor) -> torch.Tensor:
    """ASPP(c4) upsampled and joined with the skip: the after_aspp
    insertion map (ch + 32 channels)."""
    y = _aspp(p.aspp, c4)
    y = bilinear_resize(y, skip.shape[1], skip.shape[2], align_corners=True)
    return torch.cat([y, skip], -1)


def deeplab_decoder(p: DeeplabISModel, y: torch.Tensor) -> torch.Tensor:
    """_DeepLabHead on the joined map -> ch channels: the after_deeplab
    insertion map."""
    d = p.dhead
    return nn.conv1x1(d.cls, _sep(d.sep2, _sep(d.sep1, y)))


def deeplab_seg_head(p: DeeplabISModel, y: torch.Tensor) -> torch.Tensor:
    """SepConvHead -> one logit."""
    h = p.head
    return nn.conv1x1(h.cls, _sep(h.sep2, _sep(h.sep1, y)))


def deeplab_is_forward(p: DeeplabISModel, cfg: DeeplabISConfig,
                       image: torch.Tensor, points: torch.Tensor,
                       coord_bias=None, **_) -> Dict[str, torch.Tensor]:
    skip, c4 = deeplab_backbone(p, cfg, image, points, coord_bias)
    y = deeplab_decoder(p, deeplab_aspp_concat(p, c4, skip))
    seg = deeplab_seg_head(p, y)
    hh, ww = image.shape[1], image.shape[2]
    return {"instances": bilinear_resize(seg, hh, ww, align_corners=True),
            "instances_aux": None}
