"""Swin transformer interactive-segmentation model
(pvpuformer_tpu/models/zoo/swin.py; the reference's swin_transformer.py).

A 4x4 patch embed, with the coord channels through a patch embed of their
own added to the image tokens; four stages of Swin blocks (window attention
with relative-position bias, every other block on windows shifted by a
cyclic roll and masked), patch merging between stages; the shared
SegFormer-style head without P2CL. Window attention is plain PyTorch: f32
logits and softmax, as JAX's einsum with an f32 result. The position
index and the shift mask are made on the tensors' device by arange and
compares, so a CUDA graph can capture a round.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn as tnn

from ... import nn
from ...ops.resize import bilinear_resize
from ..seg_head import Head, HeadConfig, head_forward
from .common import is_inputs


@dataclasses.dataclass(frozen=True)
class SwinISConfig:
    embed_dim: int = 96
    depths: Tuple[int, ...] = (2, 2, 6, 2)       # Swin-T
    num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    window: int = 7
    mlp_ratio: float = 4.0
    head_channels: int = 128
    patch_norm: bool = False
    num_max_points: int = 24
    norm_radius: float = 5.0
    use_disks: bool = True
    with_prev_mask: bool = True
    dtype: Any = torch.float32

    @property
    def stage_dims(self) -> Tuple[int, ...]:
        return tuple(self.embed_dim * (2 ** i) for i in range(len(self.depths)))

    @property
    def head_config(self) -> HeadConfig:
        return HeadConfig(in_channels=self.stage_dims,
                          channels=self.head_channels, ed_loss=False)

    def replace(self, **kw) -> "SwinISConfig":
        return dataclasses.replace(self, **kw)


def block_params(dim: int, heads: int, mlp_ratio: float, window: int,
                 g=None) -> nn.Node:
    p = nn.Node(norm1=nn.Norm(dim), qkv=nn.Linear(dim, dim * 3, g=g),
                proj=nn.Linear(dim, dim, g=g), norm2=nn.Norm(dim),
                mlp=nn.Mlp(dim, int(dim * mlp_ratio), g=g))
    p.rel_bias = nn.param(nn.normal_init(((2 * window - 1) ** 2, heads), g))
    return p


def merge_params(dim: int, g=None) -> nn.Node:
    return nn.Node(norm=nn.Norm(4 * dim),
                   lin=nn.Linear(4 * dim, 2 * dim, bias=False, g=g))


def _rel_index(window: int, device) -> torch.Tensor:
    """(w*w, w*w) index into the (2w - 1)^2 relative-position table."""
    r = torch.arange(window, device=device)
    yy, xx = r.repeat_interleave(window), r.repeat(window)
    dy = yy[:, None] - yy[None, :] + window - 1
    dx = xx[:, None] - xx[None, :] + window - 1
    return dy * (2 * window - 1) + dx


def rel_bias(table: torch.Tensor, window: int) -> torch.Tensor:
    """The (heads, w*w, w*w) bias of a relative-position table, f32."""
    n = window * window
    idx = _rel_index(window, table.device).reshape(-1)
    return table[idx].reshape(n, n, -1).permute(2, 0, 1).float()


def _windows(x: torch.Tensor, window: int) -> torch.Tensor:
    """(B, Hp, Wp, C) -> (B * nh * nw, w * w, C), window-major."""
    b, hp, wp, c = x.shape
    nh, nw = hp // window, wp // window
    x = x.reshape(b, nh, window, nw, window, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b * nh * nw, window * window, c)


def _unwindows(x: torch.Tensor, b: int, hp: int, wp: int,
               window: int) -> torch.Tensor:
    nh, nw = hp // window, wp // window
    x = x.reshape(b, nh, nw, window, window, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, hp, wp, -1)


def window_attention(q, k, v, scale: Optional[float],
                     bias: torch.Tensor, dtype) -> torch.Tensor:
    """Attention over (Bw, n, heads, hd) windows with f32 logits
    (q k^T, times `scale` if given, plus `bias` broadcast over
    (Bw, heads, n, n)), an f32 softmax, probabilities rounded to `dtype` and
    the PV product accumulated in f32 (JAX's einsums with an f32 result)."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    if scale is not None:
        logits = logits * scale
    probs = torch.softmax(logits + bias, -1).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float()).to(dtype)


def _shift_mask(hp: int, wp: int, window: int, shift: int,
                device) -> torch.Tensor:
    """(nh * nw, w*w, w*w): -1e9 between tokens of a rolled window that
    came from different regions of the padded map, 0 elsewhere."""
    def region(n):
        r = torch.arange(n, device=device)
        return (r >= n - window).long() + (r >= n - shift).long()
    ids = (region(hp)[:, None] * 3 + region(wp)[None, :])[None, :, :, None]
    m = _windows(ids, window)[..., 0]                     # (nW, w*w)
    zero = torch.zeros((), device=device)
    return torch.where(m[:, None, :] != m[:, :, None], zero - 1e9, zero)


def _window_attn(p, x: torch.Tensor, hw: Tuple[int, int], heads: int,
                 window: int, shift: int) -> torch.Tensor:
    """x (B, H*W, C); H and W are padded up to window multiples inside."""
    b, n, c = x.shape
    h, w = hw
    xm = x.reshape(b, h, w, c)
    ph, pw = (-h) % window, (-w) % window
    if ph or pw:
        xm = F.pad(xm, (0, 0, 0, pw, 0, ph))
    hp, wp = h + ph, w + pw
    if shift:
        xm = torch.roll(xm, (-shift, -shift), dims=(1, 2))
    xw = _windows(xm, window)
    bw, nt = xw.shape[0], window * window
    qkv = nn.linear(p.qkv, xw).reshape(bw, nt, 3, heads, c // heads)
    bias = rel_bias(p.rel_bias, window)[None]             # (1, heads, n, n)
    if shift:
        mask = _shift_mask(hp, wp, window, shift, x.device)
        bias = (bias + mask[:, None]).repeat(b, 1, 1, 1)  # (B*nW, heads, n, n)
    out = window_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                           (c // heads) ** -0.5, bias, x.dtype)
    out = nn.linear(p.proj, out.reshape(bw, nt, c))
    om = _unwindows(out, b, hp, wp, window)
    if shift:
        om = torch.roll(om, (shift, shift), dims=(1, 2))
    if ph or pw:
        om = om[:, :h, :w]
    return om.reshape(b, n, c)


def _block(p, x, hw, heads, window, shift):
    x = x + _window_attn(p, nn.layer_norm(p.norm1, x, 1e-5), hw, heads,
                         window, shift)
    return x + nn.mlp(p.mlp, nn.layer_norm(p.norm2, x, 1e-5))


def patch_merge(p, x: torch.Tensor, h: int, w: int, pad: bool = True):
    """2x2 neighbours joined (x0, x1, x2, x3 = (0,0), (1,0), (0,1), (1,1)),
    LayerNorm, linear 4C -> 2C: (tokens, h', w')."""
    b, _, c = x.shape
    xm = x.reshape(b, h, w, c)
    if pad and (h % 2 or w % 2):
        xm = F.pad(xm, (0, 0, 0, w % 2, 0, h % 2))
    xm = torch.cat([xm[:, 0::2, 0::2], xm[:, 1::2, 0::2],
                    xm[:, 0::2, 1::2], xm[:, 1::2, 1::2]], -1)
    h, w = xm.shape[1], xm.shape[2]
    xm = nn.layer_norm(p.norm, xm.reshape(b, h * w, 4 * c), 1e-5)
    return nn.linear(p.lin, xm), h, w


class SwinISModel(tnn.Module):
    """The JAX `init_swin_is` tree; `generator=None` leaves the weights
    zero, for loading."""

    def __init__(self, cfg: SwinISConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.cfg = cfg
        coord_ch = 3 if cfg.with_prev_mask else 2
        self.patch_embed = nn.PatchEmbed((4, 4), 3, cfg.embed_dim, g=g)
        self.patch_embed_coords = nn.PatchEmbed((4, 4), coord_ch,
                                                cfg.embed_dim, init="torch",
                                                g=g)
        if cfg.patch_norm:
            self.patch_norm = nn.Norm(cfg.embed_dim)
        self.stages = tnn.ModuleList()
        for i, depth in enumerate(cfg.depths):
            dim = cfg.stage_dims[i]
            kids = dict(blocks=tnn.ModuleList(
                block_params(dim, cfg.num_heads[i], cfg.mlp_ratio, cfg.window,
                             g) for _ in range(depth)),
                norm=nn.Norm(dim))
            if i < len(cfg.depths) - 1:
                kids["merge"] = merge_params(dim, g)
            self.stages.append(nn.Node(**kids))
        self.head = Head(cfg.head_config, g)

    def forward(self, image, points, **kw):
        return swin_is_forward(self, self.cfg, image, points, **kw)


def init_swin_is(cfg: SwinISConfig, generator: torch.Generator,
                 device=None) -> SwinISModel:
    return SwinISModel(cfg, generator).to(nn.resolve_device(device))


def swin_is_forward(p: SwinISModel, cfg: SwinISConfig, image: torch.Tensor,
                    points: torch.Tensor, coord_bias=None,
                    **_) -> Dict[str, torch.Tensor]:
    rgb, coords = is_inputs(image, points, cfg.norm_radius, cfg.use_disks,
                            cfg.with_prev_mask, cfg.dtype,
                            coord_bias=coord_bias)
    x = nn.patch_embed(p.patch_embed, rgb, (4, 4))
    if cfg.patch_norm:
        x = nn.layer_norm(p.patch_norm, x, 1e-5)
    x = x + nn.patch_embed(p.patch_embed_coords, coords, (4, 4))
    h, w = rgb.shape[1] // 4, rgb.shape[2] // 4
    feats: List[torch.Tensor] = []
    for i, stage in enumerate(p.stages):
        for j, blk in enumerate(stage.blocks):
            shift = 0 if j % 2 == 0 else cfg.window // 2
            x = _block(blk, x, (h, w), cfg.num_heads[i], cfg.window, shift)
        y = nn.layer_norm(stage.norm, x, 1e-5)
        feats.append(y.reshape(y.shape[0], h, w, -1))
        if hasattr(stage, "merge"):
            x, h, w = patch_merge(stage.merge, x, h, w)
    seg, _ = head_forward(p.head, cfg.head_config, feats, None)
    hh, ww = image.shape[1], image.shape[2]
    return {"instances": bilinear_resize(seg, hh, ww, align_corners=True),
            "instances_aux": None}
