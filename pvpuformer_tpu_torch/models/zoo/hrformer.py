"""HRFormer (HRT) interactive-segmentation model
(pvpuformer_tpu/models/zoo/hrformer.py; the reference's hrt_backbone.py,
transformer_block.py, multihead_isa_attention.py, ffn_block.py and
modeling/hrformer.py).

A conv stem and bottleneck layer1, HRNet transitions, and transformer
stages whose branches run GeneralTransformerBlocks: LayerNorm, ISA window
attention (the map centre-padded to window multiples, contiguous local
windows, q / k / v / out projections, q pre-scaled, Swin-layout relative
position bias), LayerNorm, the MlpDWBN FFN (conv1x1, depthwise 3x3, conv1x1,
each with BN and GELU); fusion by 1x1 conv + BN and nearest upsampling, or
chains of depthwise-separable stride-2 convs; the OCR head with 7x7 grouped
convs. Clicks enter as extra channels of the stem's first conv (the
wrapper's evident intent; JAX PARITY.md).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn as tnn

from ... import nn
from ...ops.resize import bilinear_resize
from .common import conv_bn, conv_bn_relu, frozen_bn, is_inputs
from .hrnet import (_bottleneck, _transition, bottleneck_block,
                    object_context, transition_params)
from .swin import _unwindows, _windows, rel_bias, window_attention


@dataclasses.dataclass(frozen=True)
class HRFormerISConfig:
    width: int = 78                              # hrt_base; hrt_small: 32
    num_heads: Tuple[int, ...] = (2, 4, 8, 16)   # hrt_small: (1, 2, 4, 8)
    num_units: Tuple[int, int, int] = (1, 4, 2)  # modules of stages 2 / 3 / 4
    blocks_per_unit: int = 2
    window: int = 7
    mlp_ratio: float = 4.0
    ocr_width: int = 512
    num_max_points: int = 24
    norm_radius: float = 5.0
    use_disks: bool = True
    with_prev_mask: bool = True
    use_leaky_relu: bool = True          # unused (no maps_transform)
    dtype: Any = torch.float32

    @property
    def branch_widths(self) -> Tuple[int, ...]:
        w = self.width
        return (w, 2 * w, 4 * w, 8 * w)

    def replace(self, **kw) -> "HRFormerISConfig":
        return dataclasses.replace(self, **kw)


def hrformer_small_config(**kw) -> HRFormerISConfig:
    return HRFormerISConfig(width=32, num_heads=(1, 2, 4, 8), **kw)


# ------------------------------------------------------------- ISA attention

def _attn_params(dim: int, heads: int, window: int, g=None) -> nn.Node:
    p = nn.Node(q=nn.Linear(dim, dim, g=g), k=nn.Linear(dim, dim, g=g),
                v=nn.Linear(dim, dim, g=g), out=nn.Linear(dim, dim, g=g))
    p.rpe = nn.param(nn.normal_init(((2 * window - 1) ** 2, heads), g))
    return p


def _center_pad(x: torch.Tensor, window: int):
    """PadBlock.pad_if_needed: H and W centre-padded to window multiples."""
    h, w = x.shape[1], x.shape[2]
    ph, pw = -h % window, -w % window
    if ph or pw:
        x = F.pad(x, (0, 0, pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
    return x, (ph, pw)


def _isa_attention(p, x: torch.Tensor, heads: int,
                   window: int) -> torch.Tensor:
    """x (B, H, W, C) -> (B, H, W, C): local-window attention with RPE."""
    b, h, w, c = x.shape
    xp, (ph, pw) = _center_pad(x, window)
    hp, wp = h + ph, w + pw
    xw = _windows(xp, window)
    hd, n = c // heads, window * window
    q = nn.linear(p.q, xw) * float(hd) ** -0.5
    k = nn.linear(p.k, xw)
    v = nn.linear(p.v, xw)
    out = window_attention(q.reshape(-1, n, heads, hd),
                           k.reshape(-1, n, heads, hd),
                           v.reshape(-1, n, heads, hd), None,
                           rel_bias(p.rpe, window)[None], x.dtype)
    out = nn.linear(p.out, out.reshape(-1, n, c))
    out = _unwindows(out, b, hp, wp, window)
    if ph or pw:
        out = out[:, ph // 2: ph // 2 + h, pw // 2: pw // 2 + w]
    return out


# ------------------------------------------------------------------ FFN

def _mlp_dwbn_params(cin: int, hidden: int, cout: int, g=None) -> nn.Node:
    return nn.Node(fc1=conv_bn(1, 1, cin, hidden, g, bias=True),
                   dw=conv_bn(3, 3, hidden, hidden, g, bias=True,
                              groups=hidden),
                   fc2=conv_bn(1, 1, hidden, cout, g, bias=True))


def _mlp_dwbn(p, x: torch.Tensor) -> torch.Tensor:
    """MlpDWBN: each stage conv -> BN -> GELU."""
    y = nn.gelu(frozen_bn(p.fc1.bn, nn.conv1x1(p.fc1.conv, x)))
    y = nn.gelu(frozen_bn(p.dw.bn, nn.conv2d(p.dw.conv, y,
                                             groups=y.shape[-1])))
    return nn.gelu(frozen_bn(p.fc2.bn, nn.conv1x1(p.fc2.conv, y)))


# ------------------------------------------------------------------ block

def _block_params(dim: int, heads: int, window: int, mlp_ratio: float,
                  g=None) -> nn.Node:
    return nn.Node(norm1=nn.Norm(dim), attn=_attn_params(dim, heads, window, g),
                   norm2=nn.Norm(dim),
                   mlp=_mlp_dwbn_params(dim, int(dim * mlp_ratio), dim, g))


def _block(p, x: torch.Tensor, heads: int, window: int) -> torch.Tensor:
    """GeneralTransformerBlock."""
    b, h, w, c = x.shape
    t = nn.layer_norm(p.norm1, x.reshape(b, h * w, c)).reshape(b, h, w, c)
    x = x + _isa_attention(p.attn, t, heads, window)
    t = nn.layer_norm(p.norm2, x.reshape(b, h * w, c)).reshape(b, h, w, c)
    return x + _mlp_dwbn(p.mlp, t)


# ------------------------------------------------------------------ fusion

def _fuse_params(widths: Tuple[int, ...], g=None) -> tnn.ModuleList:
    """fuse[i][j]: {} (i == j), {up: 1x1 conv + BN} (j > i), or {downs:
    [{dw: depthwise 3x3 + BN, pw: 1x1 + BN}, ...]} (j < i)."""
    nb = len(widths)
    rows = tnn.ModuleList()
    for i in range(nb):
        row = tnn.ModuleList()
        for j in range(nb):
            if j > i:
                row.append(nn.Node(up=conv_bn(1, 1, widths[j], widths[i], g)))
            elif j < i:
                chain = tnn.ModuleList()
                for step in range(i - j):
                    cout = widths[i] if step == i - j - 1 else widths[j]
                    chain.append(nn.Node(
                        dw=conv_bn(3, 3, widths[j], widths[j], g,
                                   groups=widths[j]),
                        pw=conv_bn(1, 1, widths[j], cout, g)))
                row.append(nn.Node(downs=chain))
            else:
                row.append(nn.Node())
        rows.append(row)
    return rows


def _fuse(p, ys: List[torch.Tensor]) -> List[torch.Tensor]:
    """The fused branches summed, then ReLU."""
    nb = len(ys)
    outs = []
    for i in range(nb):
        acc = None
        for j in range(nb):
            f = p[i][j]
            if j > i:
                v = frozen_bn(f.up.bn, nn.conv1x1(f.up.conv, ys[j]))
                fct = 2 ** (j - i)
                v = v.repeat_interleave(fct, 1).repeat_interleave(fct, 2)
                th, tw = ys[i].shape[1], ys[i].shape[2]
                if v.shape[1] != th or v.shape[2] != tw:
                    v = bilinear_resize(v, th, tw, align_corners=True)
            elif j < i:
                v = ys[j]
                last = len(f.downs) - 1
                for step, c in enumerate(f.downs):
                    v = frozen_bn(c.dw.bn, nn.conv2d(c.dw.conv, v, stride=2,
                                                     groups=v.shape[-1]))
                    v = frozen_bn(c.pw.bn, nn.conv1x1(c.pw.conv, v))
                    if step != last:
                        v = torch.relu(v)
            else:
                v = ys[j]
            acc = v if acc is None else acc + v
        outs.append(torch.relu(acc))
    return outs


def _hr_module_params(widths, cfg: HRFormerISConfig, g=None) -> nn.Node:
    branches = tnn.ModuleList(
        tnn.ModuleList(_block_params(widths[b], cfg.num_heads[b], cfg.window,
                                     cfg.mlp_ratio, g)
                       for _ in range(cfg.blocks_per_unit))
        for b in range(len(widths)))
    return nn.Node(branches=branches, fuse=_fuse_params(widths, g))


def _hr_module(p, xs: List[torch.Tensor], cfg: HRFormerISConfig):
    ys = []
    for bi, x in enumerate(xs):
        for blk in p.branches[bi]:
            x = _block(blk, x, cfg.num_heads[bi], cfg.window)
        ys.append(x)
    return ys if len(ys) == 1 else _fuse(p.fuse, ys)


# ------------------------------------------------------------------ OCR head

def _hrt_ocr_params(in_ch: int, hidden: int, g=None) -> nn.Node:
    """HRT_B_OCR_V3: 7x7 grouped convs (groups gcd(in, hidden)), the aux
    head, the SpatialOCR distri head (key channels hidden / 2)."""
    gr, kc = math.gcd(in_ch, hidden), hidden // 2

    def cbr(cin, cout):
        return conv_bn(1, 1, cin, cout, g, bias=True)
    return nn.Node(
        conv3x3=conv_bn(7, 7, in_ch, hidden, g, bias=True, groups=gr),
        aux1=conv_bn(7, 7, in_ch, hidden, g, bias=True, groups=gr),
        aux_cls=nn.Conv(1, 1, hidden, 1, g),
        f_pixel=tnn.ModuleList([cbr(hidden, kc), cbr(kc, kc)]),
        f_object=tnn.ModuleList([cbr(hidden, kc), cbr(kc, kc)]),
        f_down=cbr(hidden, kc), f_up=cbr(kc, hidden),
        bottleneck=cbr(2 * hidden, hidden),
        cls=nn.Conv(1, 1, hidden, 1, g))


def _grouped_bnrelu(p, x: torch.Tensor, groups: int) -> torch.Tensor:
    return torch.relu(frozen_bn(p.bn, nn.conv2d(p.conv, x, groups=groups)))


def _cbr1(p, x: torch.Tensor) -> torch.Tensor:
    return torch.relu(frozen_bn(p.bn, nn.conv1x1(p.conv, x)))


def _hrt_ocr(p, feats: torch.Tensor):
    """feats (B, H, W, in_ch) -> (cls logits, aux logits) at stride 4."""
    hidden = p.cls.w.shape[-2]
    gr = math.gcd(feats.shape[-1], hidden)
    aux_logits = nn.conv1x1(p.aux_cls, _grouped_bnrelu(p.aux1, feats, gr))
    x = _grouped_bnrelu(p.conv3x3, feats, gr)
    ctx = object_context(x, aux_logits, p.f_pixel, p.f_object, p.f_down,
                         p.f_up, _cbr1)
    y = _cbr1(p.bottleneck, torch.cat([ctx, x], -1))
    return nn.conv1x1(p.cls, y), aux_logits


# ------------------------------------------------------------------- model

class HRFormerISModel(tnn.Module):
    """The JAX `init_hrformer_is` tree; `generator=None` leaves the weights
    zero, for loading."""

    def __init__(self, cfg: HRFormerISConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.cfg = cfg
        w = cfg.branch_widths
        self.stem1 = conv_bn(3, 3, 3 + (3 if cfg.with_prev_mask else 2), 64, g)
        self.stem2 = conv_bn(3, 3, 64, 64, g)
        self.layer1 = tnn.ModuleList(
            bottleneck_block(64 if j == 0 else 256, 64, g) for j in range(2))
        self.tr1 = transition_params((256,), w[:2], g)
        self.stage2 = tnn.ModuleList(_hr_module_params(w[:2], cfg, g)
                                     for _ in range(cfg.num_units[0]))
        self.tr2 = transition_params(w[:2], w[:3], g)
        self.stage3 = tnn.ModuleList(_hr_module_params(w[:3], cfg, g)
                                     for _ in range(cfg.num_units[1]))
        self.tr3 = transition_params(w[:3], w, g)
        self.stage4 = tnn.ModuleList(_hr_module_params(w, cfg, g)
                                     for _ in range(cfg.num_units[2]))
        self.ocr = _hrt_ocr_params(sum(w), cfg.ocr_width, g)

    def forward(self, image, points, **kw):
        return hrformer_is_forward(self, self.cfg, image, points, **kw)


def init_hrformer_is(cfg: HRFormerISConfig, generator: torch.Generator,
                     device=None) -> HRFormerISModel:
    return HRFormerISModel(cfg, generator).to(nn.resolve_device(device))


def hrt_backbone_forward(p: HRFormerISModel, cfg: HRFormerISConfig,
                         x: torch.Tensor) -> List[torch.Tensor]:
    """x (B, H, W, in_ch) -> the four branch maps at strides 4 / 8 / 16 /
    32."""
    x = conv_bn_relu(p.stem1, x, stride=2)
    x = conv_bn_relu(p.stem2, x, stride=2)
    for blk in p.layer1:
        x = _bottleneck(blk, x)
    xs = _transition(p.tr1, [x])
    for m in p.stage2:
        xs = _hr_module(m, xs, cfg)
    xs = _transition(p.tr2, xs)
    for m in p.stage3:
        xs = _hr_module(m, xs, cfg)
    xs = _transition(p.tr3, xs)
    for m in p.stage4:
        xs = _hr_module(m, xs, cfg)
    return xs


def hrformer_is_forward(p: HRFormerISModel, cfg: HRFormerISConfig,
                        image: torch.Tensor, points: torch.Tensor,
                        coord_bias=None, **_) -> Dict[str, torch.Tensor]:
    rgb, coords = is_inputs(image, points, cfg.norm_radius, cfg.use_disks,
                            cfg.with_prev_mask, cfg.dtype,
                            coord_bias=coord_bias)
    xs = hrt_backbone_forward(p, cfg, torch.cat([rgb, coords], -1))
    th, tw = xs[0].shape[1], xs[0].shape[2]
    feats = torch.cat([xs[0]] + [bilinear_resize(v, th, tw, align_corners=True)
                                 for v in xs[1:]], -1)
    logits, aux = _hrt_ocr(p.ocr, feats)
    hh, ww = image.shape[1], image.shape[2]
    return {"instances": bilinear_resize(logits, hh, ww, align_corners=True),
            "instances_aux": bilinear_resize(aux, hh, ww, align_corners=True)}
