"""CRIS / DETR-style vision-language TransformerDecoder
(pvpuformer_tpu/models/decoder.py).

The decoder stack of the reference's `is_vitdetr_*` experiment variants
(`isegm/model/modeling/transformer.py:17-219`): query self-attention ->
cross-attention onto the image tokens with 2-D sin-cos positions -> FFN,
pre-norm, with per-layer intermediate outputs on request. No registered
model family uses it (the VPU model's neck runs the two-way transformer).

Inference only, as in JAX (PARITY.md #8b): the reference layer's
dropout(0.1) on the self / cross / FFN residuals is left out (it is the
identity in eval mode). Attention is `nn.sdpa`, the dense form whose
logits are rounded to the input dtype. Each attention keeps torch
`nn.MultiheadAttention`'s packed in-projection (`in_proj`, (d, 3d));
after `nn.quantize_params` it is one `QuantLinear`, and each of q / k / v
takes its column slice of `w_q` (a column slice of a column-major matrix
is column-major, the layout the int8 product takes), of `w_s` and of `b`.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import types
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn as tnn

from .. import nn


def pos1d_sincos(d_model: int, length: int) -> np.ndarray:
    """1-D sine-cosine positions (transformer.py pos1d)."""
    pe = np.zeros((length, d_model), np.float32)
    position = np.arange(length, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float32)
                 * -(math.log(10000.0) / d_model))
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div)
    return pe


def pos2d_sincos(d_model: int, h: int, w: int) -> np.ndarray:
    """2-D sine-cosine positions (transformer.py pos2d: half the channels
    encode x, half y, interleaved sin / cos) -> (h * w, d_model)."""
    assert d_model % 4 == 0
    pe = np.zeros((d_model, h, w), np.float32)
    dm = d_model // 2
    div = np.exp(np.arange(0, dm, 2, dtype=np.float32)
                 * -(math.log(10000.0) / dm))
    pw = np.arange(w, dtype=np.float32)[:, None] * div[None]
    ph = np.arange(h, dtype=np.float32)[:, None] * div[None]
    pe[0:dm:2] = np.broadcast_to(np.sin(pw).T[:, None, :], (dm // 2, h, w))
    pe[1:dm:2] = np.broadcast_to(np.cos(pw).T[:, None, :], (dm // 2, h, w))
    pe[dm::2] = np.broadcast_to(np.sin(ph).T[:, :, None], (dm // 2, h, w))
    pe[dm + 1::2] = np.broadcast_to(np.cos(ph).T[:, :, None], (dm // 2, h, w))
    return pe.reshape(d_model, h * w).T


@functools.lru_cache(maxsize=16)
def _pos(d: int, grid_hw: Tuple[int, int], length: Optional[int]):
    """The host positions of one call's shapes, made once per shape."""
    if length is None:
        return torch.from_numpy(pos2d_sincos(d, *grid_hw))
    return torch.from_numpy(pos1d_sincos(d, length))


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    num_layers: int = 3
    d_model: int = 512
    nhead: int = 8
    dim_ffn: int = 2048
    return_intermediate: bool = False


def _attention(d: int, g=None) -> nn.Node:
    """torch nn.MultiheadAttention's layout: packed in-proj + out-proj."""
    return nn.Node(in_proj=nn.Linear(d, 3 * d, init="xavier", g=g),
                   out=nn.Linear(d, d, init="xavier", g=g))


class DecoderLayer(tnn.Module):
    def __init__(self, cfg: DecoderConfig, g=None):
        super().__init__()
        d = cfg.d_model
        self.self_attn = _attention(d, g)
        self.self_attn_norm = nn.Norm(d)
        self.cross_attn = _attention(d, g)
        self.cross_attn_norm = nn.Norm(d)
        # Linear -> ReLU -> LayerNorm(dim_ffn) -> Linear (transformer.py:160-164)
        self.ffn = nn.Node(
            fc1=nn.Linear(d, cfg.dim_ffn, init="xavier", g=g),
            ln=nn.Norm(cfg.dim_ffn),
            fc2=nn.Linear(cfg.dim_ffn, d, init="xavier", g=g))
        self.norm1 = nn.Norm(d)
        self.norm2 = nn.Norm(d)
        self.norm3 = nn.Norm(d)


class Decoder(tnn.Module):
    """The JAX `init_decoder` tree; `generator=None` leaves the weights
    zero, for loading."""

    def __init__(self, cfg: DecoderConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.layers = tnn.ModuleList(DecoderLayer(cfg, generator)
                                     for _ in range(cfg.num_layers))
        self.norm = nn.Norm(cfg.d_model)


def init_decoder(cfg: DecoderConfig, generator: torch.Generator,
                 device=None) -> Decoder:
    """Seeded random weights, built on the CPU and moved to `device` (None:
    the card)."""
    return Decoder(cfg, generator).to(nn.resolve_device(device))


def _in_proj(p, x: torch.Tensor, i: int) -> torch.Tensor:
    """Projection i (0 q, 1 k, 2 v) of the packed in-projection: its column
    slice of the float weight and bias, or of the int8 `w_q`, `w_s` and
    `b` (JAX decoder.py:104-111)."""
    d = x.shape[-1]
    sl = slice(i * d, (i + 1) * d)
    b = None if p.b is None else p.b[sl]
    if isinstance(p, nn.QuantLinear):
        return nn.linear_int8(types.SimpleNamespace(
            w_q=p.w_q[:, sl], w_s=p.w_s[sl], b=b), x)
    y = x @ p.w[:, sl].to(x.dtype)
    return y if b is None else y + b.to(x.dtype)


def _mha(p, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         heads: int) -> torch.Tensor:
    """torch nn.MultiheadAttention: q / k / v through their slices of
    in_proj, dense attention, out-proj."""
    d = q.shape[-1]
    qp, kp, vp = (_in_proj(p.in_proj, t, i) for i, t in enumerate((q, k, v)))
    b, nq, _ = qp.shape
    out = nn.sdpa(qp.reshape(b, nq, heads, d // heads),
                  kp.reshape(b, -1, heads, d // heads),
                  vp.reshape(b, -1, heads, d // heads)).reshape(b, nq, d)
    return nn.linear(p.out, out)


def _ffn(p, x: torch.Tensor) -> torch.Tensor:
    h = torch.relu(nn.linear(p.fc1, x))
    return nn.linear(p.fc2, nn.layer_norm(p.ln, h, 1e-5))


def decoder_forward(p: Decoder, cfg: DecoderConfig, vis: torch.Tensor,
                    txt: torch.Tensor, grid_hw: Tuple[int, int],
                    as_text: bool = False, image_to_token: bool = False):
    """vis (B, HW, D) image tokens, txt (B, L, D) query tokens
    (TransformerDecoder.forward, transformer.py:90-219):
      * every layer self-attends over the ORIGINAL vis (the vis residual
        is layer-local);
      * cross-attention queries are norm2(txt) (+ pos1d when `as_text`),
        keys the layer's self-attended vis + pos2d, values that vis;
      * the FFN has a LayerNorm on its hidden activations;
      * the final norm is LayerNorm + ReLU;
      * `image_to_token` threads the vis side instead of txt.
    Returns the final output, or the list of per-layer outputs (the last
    equal to the final output) when cfg.return_intermediate."""
    d = vis.shape[-1]
    vis_pos = _pos(d, tuple(grid_hw), None).to(vis.device, vis.dtype)[None]
    txt_pos = (_pos(d, (0, 0), txt.shape[1]).to(txt.device, txt.dtype)[None]
               if as_text else None)
    out = vis if image_to_token else txt
    inters: List[torch.Tensor] = []

    def final_norm(x):
        return torch.relu(nn.layer_norm(p.norm, x, 1e-5))

    for lp in p.layers:
        vis2 = nn.layer_norm(lp.norm1, vis, 1e-5)
        a = vis2 + vis_pos
        vis2 = _mha(lp.self_attn, a, a, vis2, cfg.nhead)
        vis_l = vis + nn.layer_norm(lp.self_attn_norm, vis2, 1e-5)
        if image_to_token:
            # queries from the self-attended vis; keys / values the threaded
            # output (transformer.py:193-201)
            q = nn.layer_norm(lp.norm2, vis_l, 1e-5) + vis_pos
            kv = out if txt_pos is None else out + txt_pos
            c = _mha(lp.cross_attn, q, kv, out, cfg.nhead)
            out = vis_l + nn.layer_norm(lp.cross_attn_norm, c, 1e-5)
        else:
            h = nn.layer_norm(lp.norm2, out, 1e-5)
            q = h if txt_pos is None else h + txt_pos
            c = _mha(lp.cross_attn, q, vis_l + vis_pos, vis_l, cfg.nhead)
            out = out + nn.layer_norm(lp.cross_attn_norm, c, 1e-5)
        out = out + _ffn(lp.ffn, nn.layer_norm(lp.norm3, out, 1e-5))
        if cfg.return_intermediate:
            inters.append(final_norm(out))
    return inters if cfg.return_intermediate else final_norm(out)
