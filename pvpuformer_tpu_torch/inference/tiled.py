"""Tiled ("Crops") inference for very large images
(pvpuformer_tpu/inference/tiled.py; reference inference/transforms/
crops.py:11-97): the image splits into overlapping tiles of the crop size,
the clicks are moved into each tile's frame, every tile runs in one batched
forward of any registered model family, and the logits blend back under a
window that falls off linearly towards each tile's border.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch
from torch import nn as tnn

from ..models.registry import forward_for


def _tile_origins(size: int, crop: int, min_overlap: float) -> List[int]:
    if size <= crop:
        return [0]
    n = max(2, math.ceil((size - crop * min_overlap) /
                         (crop * (1 - min_overlap))))
    step = (size - crop) / (n - 1)
    return [int(round(i * step)) for i in range(n)]


def _blend_window(crop_h: int, crop_w: int) -> np.ndarray:
    wy = np.minimum(np.arange(crop_h) + 1, np.arange(crop_h)[::-1] + 1)
    wx = np.minimum(np.arange(crop_w) + 1, np.arange(crop_w)[::-1] + 1)
    w = np.minimum.outer(wy, wx).astype(np.float32)
    return w / w.max()


@torch.no_grad()
def tiled_forward(model: tnn.Module, model_cfg, image: torch.Tensor,
                  points: torch.Tensor, crop_size: Tuple[int, int] = (448, 448),
                  min_overlap: float = 0.2) -> torch.Tensor:
    """image (1, H, W, C), points (1, 2N, 3) full-frame clicks -> (1, H, W,
    1) f32 logits blended across the tiles. The image must be at least the
    crop size on each side (as JAX's dynamic_slice requires)."""
    _, h, w, c = image.shape
    ch, cw = crop_size
    if h < ch or w < cw:
        raise ValueError(f"tiled_forward: the image {h}x{w} is smaller than "
                         f"the crop {ch}x{cw}")
    ys = _tile_origins(h, ch, min_overlap)
    xs = _tile_origins(w, cw, min_overlap)
    tiles, tile_pts = [], []
    for y0 in ys:
        for x0 in xs:
            tiles.append(image[0, y0:y0 + ch, x0:x0 + cw])
            py = points[0, :, 0] - y0
            px = points[0, :, 1] - x0
            inside = ((points[0, :, 2] >= 0) & (py >= 0) & (py < ch)
                      & (px >= 0) & (px < cw))
            tile_pts.append(torch.where(
                inside[:, None], torch.stack([py, px, points[0, :, 2]], -1),
                -1.0))
    batch = torch.stack(tiles)                           # (T, ch, cw, C)
    pts = torch.stack(tile_pts)                          # (T, 2N, 3)
    logits = forward_for(model_cfg)(model, model_cfg, batch, pts)["instances"]
    window = torch.from_numpy(_blend_window(ch, cw)).to(image.device)[..., None]
    acc = torch.zeros((h, w, 1), dtype=torch.float32, device=image.device)
    den = torch.full((h, w, 1), 1e-6, dtype=torch.float32, device=image.device)
    i = 0
    for y0 in ys:
        for x0 in xs:
            acc[y0:y0 + ch, x0:x0 + cw] += logits[i].float() * window
            den[y0:y0 + ch, x0:x0 + cw] += window
            i += 1
    return (acc / den)[None]
