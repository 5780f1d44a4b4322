"""HRNet + OCR interactive-segmentation model (pvpuformer_tpu/models/zoo/
hrnet.py; RITM's hrnet_ocr.py / ocr.py).

Stem (two stride-2 3x3 conv+BN+ReLU, the RITM coord features added after
the first), layer1 (bottlenecks, 64 -> 256), stages 2-4 of parallel
branches at strides 4 / 8 / 16 / 32 with full cross-resolution fusion,
then the OCR head (soft object regions, spatial gather, object attention,
1x1 classifier). `hrnet_feats`, `_ocr_pre_cls` and `_ocr` stay separate
functions: f-BRS inserts between them (inference/brs.py).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn as tnn

from ... import nn
from ...ops.resize import bilinear_resize
from .common import (MapsTransform, conv_bn, conv_bn_relu, is_inputs,
                     maps_transform)


@dataclasses.dataclass(frozen=True)
class HRNetISConfig:
    width: int = 18
    small: bool = True
    ocr_width: int = 64
    num_max_points: int = 24
    norm_radius: float = 5.0
    use_disks: bool = True
    with_prev_mask: bool = True
    use_leaky_relu: bool = True
    dtype: Any = torch.float32

    @property
    def branch_widths(self) -> Tuple[int, ...]:
        w = self.width
        return (w, 2 * w, 4 * w, 8 * w)

    @property
    def num_modules(self) -> Tuple[int, int, int]:
        return (1, 3, 2) if self.small else (1, 4, 3)

    @property
    def blocks_per_module(self) -> int:
        return 2 if self.small else 4

    def replace(self, **kw) -> "HRNetISConfig":
        return dataclasses.replace(self, **kw)


# ----------------------------------------------------------------- blocks

def basic_block(cin: int, cout: int, g=None) -> nn.Node:
    kids = dict(c1=conv_bn(3, 3, cin, cout, g), c2=conv_bn(3, 3, cout, cout, g))
    if cin != cout:
        kids["down"] = conv_bn(1, 1, cin, cout, g)
    return nn.Node(**kids)


def _basic(p, x):
    res = x
    y = conv_bn_relu(p.c1, x)
    y = conv_bn_relu(p.c2, y, relu=False)
    if hasattr(p, "down"):
        res = conv_bn_relu(p.down, x, relu=False)
    return torch.relu(res + y)


def bottleneck_block(cin: int, planes: int, g=None) -> nn.Node:
    cout = planes * 4
    kids = dict(c1=conv_bn(1, 1, cin, planes, g),
                c2=conv_bn(3, 3, planes, planes, g),
                c3=conv_bn(1, 1, planes, cout, g))
    if cin != cout:
        kids["down"] = conv_bn(1, 1, cin, cout, g)
    return nn.Node(**kids)


def _bottleneck(p, x):
    res = x
    y = conv_bn_relu(p.c1, x)
    y = conv_bn_relu(p.c2, y)
    y = conv_bn_relu(p.c3, y, relu=False)
    if hasattr(p, "down"):
        res = conv_bn_relu(p.down, x, relu=False)
    return torch.relu(res + y)


# ------------------------------------------------------------------ stages

def _module_params(widths: Tuple[int, ...], blocks: int, g=None) -> nn.Node:
    """One HR module: `blocks` basic blocks per branch + full fusion;
    fuse[i][j] is {} (i == j), {up} (j > i) or {downs: [...]} (j < i)."""
    nb = len(widths)
    branches = tnn.ModuleList(
        tnn.ModuleList(basic_block(widths[b], widths[b], g)
                       for _ in range(blocks)) for b in range(nb))
    fuse = tnn.ModuleList()
    for i in range(nb):
        row = tnn.ModuleList()
        for j in range(nb):
            if j > i:
                row.append(nn.Node(up=conv_bn(1, 1, widths[j], widths[i], g)))
            elif j < i:
                chain, cin = tnn.ModuleList(), widths[j]
                for step in range(i - j):
                    cout = widths[i] if step == i - j - 1 else cin
                    chain.append(conv_bn(3, 3, cin, cout, g))
                    cin = cout
                row.append(nn.Node(downs=chain))
            else:
                row.append(nn.Node())
        fuse.append(row)
    return nn.Node(branches=branches, fuse=fuse)


def _module(p, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    nb = len(xs)
    ys = []
    for bi in range(nb):
        y = xs[bi]
        for blk in p.branches[bi]:
            y = _basic(blk, y)
        ys.append(y)
    outs = []
    for i in range(nb):
        acc = None
        for j in range(nb):
            f = p.fuse[i][j]
            if j > i:
                v = conv_bn_relu(f.up, ys[j], relu=False)
                v = bilinear_resize(v, ys[i].shape[1], ys[i].shape[2],
                                    align_corners=True)
            elif j < i:
                v = ys[j]
                for step, c in enumerate(f.downs):
                    last = step == len(f.downs) - 1
                    v = conv_bn_relu(c, v, stride=2, relu=not last)
            else:
                v = ys[j]
            acc = v if acc is None else acc + v
        outs.append(torch.relu(acc))
    return outs


def transition_params(prev: Tuple[int, ...], new: Tuple[int, ...],
                      g=None) -> tnn.ModuleList:
    """Branch-count transition: a 3x3 conv where a width changes, {} where
    it does not, {new: stride-2 conv} for a new branch."""
    out = tnn.ModuleList()
    for i, w in enumerate(new):
        if i < len(prev):
            out.append(conv_bn(3, 3, prev[i], w, g) if prev[i] != w
                       else nn.Node())
        else:
            out.append(nn.Node(new=conv_bn(3, 3, prev[-1], w, g)))
    return out


def _transition(p, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    outs = []
    for i, t in enumerate(p):
        if hasattr(t, "new"):
            outs.append(conv_bn_relu(t.new, xs[-1], stride=2))
        elif hasattr(t, "conv"):
            outs.append(conv_bn_relu(t, xs[i]))
        else:
            outs.append(xs[i])
    return outs


# --------------------------------------------------------------------- OCR

def _ocr_params(in_ch: int, ocr_w: int, g=None) -> nn.Node:
    mid = 2 * ocr_w
    return nn.Node(
        aux=nn.Node(c1=conv_bn(1, 1, in_ch, in_ch, g),
                    cls=nn.Conv(1, 1, in_ch, 1, g)),
        conv3x3=conv_bn(3, 3, in_ch, mid, g),
        f_pixel=tnn.ModuleList([conv_bn(1, 1, mid, ocr_w, g),
                                conv_bn(1, 1, ocr_w, ocr_w, g)]),
        f_object=tnn.ModuleList([conv_bn(1, 1, mid, ocr_w, g),
                                 conv_bn(1, 1, ocr_w, ocr_w, g)]),
        f_down=conv_bn(1, 1, mid, ocr_w, g),
        f_up=conv_bn(1, 1, ocr_w, mid, g),
        bottleneck=conv_bn(1, 1, 2 * mid, mid, g),
        cls=nn.Conv(1, 1, mid, 1, g))


def object_context(x: torch.Tensor, aux_logits: torch.Tensor, f_pixel,
                   f_object, f_down, f_up, cbr) -> torch.Tensor:
    """SpatialGather (region features: the pixels pooled by a softmax over
    pixels of each class map, f32) and ObjectAttention (pixel queries
    against region keys, f32 logits and softmax): the context map, before
    the bottleneck. `cbr` applies one conv + BN + ReLU container."""
    b, h, w, c = x.shape
    probs = torch.softmax(aux_logits.reshape(b, h * w, -1).float(), dim=1)
    pix = x.reshape(b, h * w, c).float()
    regions = torch.einsum("bnk,bnc->bkc", probs, pix).to(x.dtype)
    q = x
    for p in f_pixel:
        q = cbr(p, q)
    k = regions[:, None]                                   # (B, 1, K, mid)
    for p in f_object:
        k = cbr(p, k)
    v = cbr(f_down, regions[:, None])
    d = q.shape[-1]
    sim = torch.einsum("bhwc,bzkc->bhwk", q.float(), k.float()) * (d ** -0.5)
    att = torch.softmax(sim, dim=-1).to(x.dtype)
    ctx = torch.einsum("bhwk,bzkc->bhwc", att.float(), v.float()).to(x.dtype)
    return cbr(f_up, ctx)


def _ocr_pre_cls(p, feats: torch.Tensor):
    """feats (B, H, W, C), the stride-4 concat of the branches -> (the
    pre-classifier OCR features (B, H, W, 2 * ocr_w), aux logits): f-BRS-C
    scales the former and re-runs only the classifier."""
    aux = conv_bn_relu(p.aux.c1, feats)
    aux_logits = nn.conv1x1(p.aux.cls, aux)                  # (B, H, W, 1)
    x = conv_bn_relu(p.conv3x3, feats)
    ctx = object_context(x, aux_logits, p.f_pixel, p.f_object, p.f_down,
                         p.f_up, conv_bn_relu)
    y = conv_bn_relu(p.bottleneck, torch.cat([ctx, x], -1))
    return y, aux_logits


def _ocr(p, feats: torch.Tensor):
    """(final logits, aux logits) at stride 4."""
    y, aux_logits = _ocr_pre_cls(p, feats)
    return nn.conv1x1(p.cls, y), aux_logits


# ------------------------------------------------------------------- model

class HRNetISModel(tnn.Module):
    """The JAX `init_hrnet_is` tree; `generator=None` leaves the weights
    zero, for loading."""

    def __init__(self, cfg: HRNetISConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.cfg = cfg
        w = cfg.branch_widths
        bpm = cfg.blocks_per_module
        self.maps_transform = MapsTransform(3 if cfg.with_prev_mask else 2, g)
        self.stem1 = conv_bn(3, 3, 3, 64, g)
        self.stem2 = conv_bn(3, 3, 64, 64, g)
        self.layer1 = tnn.ModuleList(
            bottleneck_block(64 if j == 0 else 256, 64, g) for j in range(bpm))
        self.tr1 = transition_params((256,), w[:2], g)
        self.stage2 = tnn.ModuleList(_module_params(w[:2], bpm, g)
                                     for _ in range(cfg.num_modules[0]))
        self.tr2 = transition_params(w[:2], w[:3], g)
        self.stage3 = tnn.ModuleList(_module_params(w[:3], bpm, g)
                                     for _ in range(cfg.num_modules[1]))
        self.tr3 = transition_params(w[:3], w, g)
        self.stage4 = tnn.ModuleList(_module_params(w, bpm, g)
                                     for _ in range(cfg.num_modules[2]))
        self.ocr = _ocr_params(sum(w), cfg.ocr_width, g)

    def forward(self, image, points, **kw):
        return hrnet_is_forward(self, self.cfg, image, points, **kw)


def init_hrnet_is(cfg: HRNetISConfig, generator: torch.Generator,
                  device=None) -> HRNetISModel:
    return HRNetISModel(cfg, generator).to(nn.resolve_device(device))


def hrnet_feats(p: HRNetISModel, cfg: HRNetISConfig, image: torch.Tensor,
                points: torch.Tensor, coord_bias=None) -> torch.Tensor:
    """The trunk: stem -> stages -> the stride-4 concat of every branch
    (the f-BRS-A insertion point)."""
    rgb, coords = is_inputs(image, points, cfg.norm_radius, cfg.use_disks,
                            cfg.with_prev_mask, cfg.dtype,
                            coord_bias=coord_bias)
    extra = maps_transform(p.maps_transform, coords, leaky=cfg.use_leaky_relu)
    x = conv_bn_relu(p.stem1, rgb, stride=2)
    x = x + extra
    x = conv_bn_relu(p.stem2, x, stride=2)
    for blk in p.layer1:
        x = _bottleneck(blk, x)
    xs = _transition(p.tr1, [x])
    for m in p.stage2:
        xs = _module(m, xs)
    xs = _transition(p.tr2, xs)
    for m in p.stage3:
        xs = _module(m, xs)
    xs = _transition(p.tr3, xs)
    for m in p.stage4:
        xs = _module(m, xs)
    th, tw = xs[0].shape[1], xs[0].shape[2]
    return torch.cat([xs[0]] + [bilinear_resize(v, th, tw, align_corners=True)
                                for v in xs[1:]], -1)


def hrnet_is_forward(p: HRNetISModel, cfg: HRNetISConfig,
                     image: torch.Tensor, points: torch.Tensor,
                     coord_bias=None, **_) -> Dict[str, torch.Tensor]:
    feats = hrnet_feats(p, cfg, image, points, coord_bias)
    logits, aux = _ocr(p.ocr, feats)
    hh, ww = image.shape[1], image.shape[2]
    return {"instances": bilinear_resize(logits, hh, ww, align_corners=True),
            "instances_aux": bilinear_resize(aux, hh, ww, align_corners=True)}
