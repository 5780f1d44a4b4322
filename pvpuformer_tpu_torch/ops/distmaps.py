"""Click -> disk / distance maps (pvpuformer_tpu/ops/distmaps.py).

points: (B, 2N, 3) rows of (y, x, order); the first N are positive clicks,
the last N negative; a point is invalid iff max(y, x) < 0 and contributes
distance 1e6. Output is NHWC (B, H, W, 2): channel 0 positive, 1 negative.
"""
from __future__ import annotations

import torch


def dist_maps(points: torch.Tensor, rows: int, cols: int,
              norm_radius: float = 5.0, spatial_scale: float = 1.0,
              use_disks: bool = True) -> torch.Tensor:
    b, twon, _ = points.shape
    n = twon // 2
    pts = points.float().reshape(b * 2, n, 3)
    dev = points.device
    yy = torch.arange(rows, dtype=torch.float32, device=dev)[:, None]
    xx = torch.arange(cols, dtype=torch.float32, device=dev)[None, :]
    py = (pts[..., 0] * spatial_scale)[..., None, None]      # (2B, N, 1, 1)
    px = (pts[..., 1] * spatial_scale)[..., None, None]
    invalid = torch.maximum(pts[..., 0], pts[..., 1]) < 0
    dy = yy - py
    dx = xx - px
    if not use_disks:
        denom = norm_radius * spatial_scale
        dy = dy / denom
        dx = dx / denom
    d2 = torch.where(invalid[..., None, None], 1e6, dy * dy + dx * dx)
    per = d2.amin(1).reshape(b, 2, rows, cols)
    if use_disks:
        out = (per <= (norm_radius * spatial_scale) ** 2).float()
    else:
        out = torch.tanh(2.0 * per.sqrt())
    return out.permute(0, 2, 3, 1)
