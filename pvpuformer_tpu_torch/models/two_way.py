"""Two-way (queries <-> image) cross-attention transformer, the DMA core
(pvpuformer_tpu/models/two_way.py).

Per block: query self-attention (the first block skips the PE add and the
residual), token->image cross-attention, query MLP (ReLU), image->token
cross-attention, each followed by a LayerNorm; then a final token->image
attention + LayerNorm. Returns the per-depth (queries, keys) intermediates.
The attention here is the plain dense `nn.sdpa` (no kernel in JAX either).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn as tnn

from .. import nn


@dataclasses.dataclass(frozen=True)
class TwoWayConfig:
    depth: int = 3
    embedding_dim: int = 768
    num_heads: int = 8
    mlp_dim: int = 1024
    attention_downsample_rate: int = 2
    ln_eps: float = 1e-5


def pos2d_interleaved(d_model: int, h: int, w: int) -> np.ndarray:
    """Interleaved sin/cos 2-D encoding (transformer.py:290-318), (h*w, d)."""
    assert d_model % 4 == 0
    pe = np.zeros((d_model, h, w), dtype=np.float64)
    dm = d_model // 2
    div = np.exp(np.arange(0.0, dm, 2) * -(math.log(10000.0) / dm))
    pos_w = np.arange(0.0, w)[:, None] * div[None, :]
    pos_h = np.arange(0.0, h)[:, None] * div[None, :]
    pe[0:dm:2] = np.sin(pos_w).T[:, None, :]
    pe[1:dm:2] = np.cos(pos_w).T[:, None, :]
    pe[dm::2] = np.sin(pos_h).T[:, :, None]
    pe[dm + 1::2] = np.cos(pos_h).T[:, :, None]
    return pe.reshape(d_model, h * w).T.astype(np.float32)


def _attention_params(dim: int, downsample: int,
                      g: Optional[torch.Generator]) -> nn.Node:
    internal = dim // downsample
    return nn.Node(q=nn.Linear(dim, internal, g=g),
                   k=nn.Linear(dim, internal, g=g),
                   v=nn.Linear(dim, internal, g=g),
                   out=nn.Linear(internal, dim, g=g))


class TwoWayBlock(tnn.Module):
    def __init__(self, cfg: TwoWayConfig, g: Optional[torch.Generator] = None):
        super().__init__()
        d, r = cfg.embedding_dim, cfg.attention_downsample_rate
        self.self_attn = _attention_params(d, 1, g)
        self.norm1 = nn.Norm(d)
        self.cross_t2i = _attention_params(d, r, g)
        self.norm2 = nn.Norm(d)
        self.mlp = nn.Mlp(d, cfg.mlp_dim, d, g=g)
        self.norm3 = nn.Norm(d)
        self.cross_i2t = _attention_params(d, r, g)
        self.norm4 = nn.Norm(d)


class TwoWay(tnn.Module):
    """Parameters of the two-way transformer. `grid_hw` fixes the image
    positional encoding, kept as a (non-checkpointed) buffer."""

    def __init__(self, cfg: TwoWayConfig, grid_hw: Tuple[int, int],
                 g: Optional[torch.Generator] = None):
        super().__init__()
        self.layers = tnn.ModuleList(TwoWayBlock(cfg, g)
                                     for _ in range(cfg.depth))
        self.final_t2i = _attention_params(
            cfg.embedding_dim, cfg.attention_downsample_rate, g)
        self.norm_final = nn.Norm(cfg.embedding_dim)
        pe = torch.from_numpy(pos2d_interleaved(cfg.embedding_dim, *grid_hw))
        self.register_buffer("image_pe", pe[None], persistent=False)


def attention(p, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              num_heads: int) -> torch.Tensor:
    """Downsampling attention (transformer.py:466-521)."""
    q = nn.linear(p.q, q)
    k = nn.linear(p.k, k)
    v = nn.linear(p.v, v)
    b, nq, c = q.shape
    nk = k.shape[1]
    out = nn.sdpa(q.reshape(b, nq, num_heads, c // num_heads),
                  k.reshape(b, nk, num_heads, c // num_heads),
                  v.reshape(b, nk, num_heads, c // num_heads))
    return nn.linear(p.out, out.reshape(b, nq, c))


def _block_forward(p: TwoWayBlock, cfg: TwoWayConfig, queries, keys,
                   query_pe, key_pe, skip_first_layer_pe: bool):
    eps = cfg.ln_eps
    if skip_first_layer_pe:
        queries = attention(p.self_attn, queries, queries, queries,
                            cfg.num_heads)
    else:
        q = queries + query_pe
        queries = queries + attention(p.self_attn, q, q, queries,
                                      cfg.num_heads)
    queries = nn.layer_norm(p.norm1, queries, eps)
    q = queries + query_pe
    k = keys + key_pe
    queries = queries + attention(p.cross_t2i, q, k, keys, cfg.num_heads)
    queries = nn.layer_norm(p.norm2, queries, eps)
    queries = queries + nn.mlp(p.mlp, queries, act=torch.relu)
    queries = nn.layer_norm(p.norm3, queries, eps)
    q = queries + query_pe
    k = keys + key_pe
    keys = keys + attention(p.cross_i2t, k, q, queries, cfg.num_heads)
    keys = nn.layer_norm(p.norm4, keys, eps)
    return queries, keys


def two_way_forward(p: TwoWay, cfg: TwoWayConfig,
                    point_embedding: torch.Tensor,
                    image_embedding: torch.Tensor
                    ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """point_embedding (B, L, D), image_embedding (B, HW, D) -> intermediates
    [(q_after_block_0, k_0), ..., (q_final, k_last)]."""
    image_pe = p.image_pe.to(image_embedding.dtype)
    query_pe = point_embedding
    queries, keys = point_embedding, image_embedding
    inter = []
    for i, layer in enumerate(p.layers):
        queries, keys = _block_forward(layer, cfg, queries, keys, query_pe,
                                       image_pe, skip_first_layer_pe=(i == 0))
        if i != cfg.depth - 1:
            inter.append((queries, keys))
    attn_out = attention(p.final_t2i, queries + query_pe, keys + image_pe,
                         keys, cfg.num_heads)
    queries = nn.layer_norm(p.norm_final, queries + attn_out, cfg.ln_eps)
    inter.append((queries, keys))
    return inter
