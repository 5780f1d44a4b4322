"""Bilinear resizing with torch `align_corners` semantics, NHWC
(pvpuformer_tpu/ops/resize.py).

Static-shape resizes apply two dense interpolation matrices (bf16 inputs
interpolate in bf16 with f32 accumulation, as in JAX). The zoom-in crop and
paste-back take the ROI as a device tensor (rmin, rmax, cmin, cmax),
inclusive, and sample with gathers, so a click needs no host round trip.
`_bicubic_axis_matrix` is the host-side bicubic of CLIP's attention pool.
"""
from __future__ import annotations

import numpy as np
import torch


def resize_axis_matrix(src: int, dst: int, align_corners: bool,
                       device=None) -> torch.Tensor:
    """Dense (dst, src) f32 interpolation matrix for one axis, built on
    `device` (positions in f64, like the JAX package's host numpy)."""
    m = torch.zeros(dst, src, dtype=torch.float64, device=device)
    if src == 1 or dst == 1:
        m[:, 0] = 1.0
        return m.float()
    i = torch.arange(dst, dtype=torch.float64, device=device)
    if align_corners:
        x = i * (src - 1) / (dst - 1)
    else:
        x = (i + 0.5) * src / dst - 0.5
    x = x.clamp(0.0, src - 1)
    x0 = x.floor().long()
    x1 = (x0 + 1).clamp_max(src - 1)
    w1 = x - x0
    m.scatter_add_(1, x0[:, None], (1.0 - w1)[:, None])
    m.scatter_add_(1, x1[:, None], w1[:, None])
    return m.float()


def bilinear_resize(x: torch.Tensor, out_h: int, out_w: int,
                    align_corners: bool = False) -> torch.Tensor:
    """NHWC bilinear resize with torch `F.interpolate` semantics."""
    b, h, w, c = x.shape
    if (h, w) == (out_h, out_w):
        return x
    ct = torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32
    mh = resize_axis_matrix(h, out_h, align_corners, x.device).to(ct)
    mw = resize_axis_matrix(w, out_w, align_corners, x.device).to(ct)
    y = torch.einsum("Oh,bhwc->bOwc", mh, x.to(ct))
    y = torch.einsum("Pw,bhwc->bhPc", mw, y)
    return y.to(x.dtype)


def _axis_sample(length_src: int, n_out: int, lo, hi):
    """align_corners=True sample positions of the spans [lo, hi] (inclusive,
    (B,) each): (B, n_out) indices and weights."""
    i = torch.arange(n_out, dtype=torch.float32, device=lo.device)
    x = lo.float()[:, None] + i * (hi - lo).float()[:, None] / float(n_out - 1)
    x = x.clamp(0.0, float(length_src - 1))
    x0 = x.floor().long()
    x1 = (x0 + 1).clamp_max(length_src - 1)
    return x0, x1, x - x0.float()


def _gather_2d(f: torch.Tensor, y0, y1, wy, x0, x1, wx) -> torch.Tensor:
    """f (B, H, W, C) sampled bilinearly at each item's rows (B, h) and
    columns (B, w)."""
    b, _, _, c = f.shape
    item = torch.arange(b, device=f.device)[:, None]
    rows = (f[item, y0] * (1.0 - wy)[..., None, None]
            + f[item, y1] * wy[..., None, None])                  # (B, h, W, C)

    def cols(x):
        return rows.gather(2, x[:, None, :, None].expand(
            b, rows.shape[1], x.shape[1], c))
    return (cols(x0) * (1.0 - wx)[:, None, :, None]
            + cols(x1) * wx[:, None, :, None])


def _rois(roi: torch.Tensor, b: int) -> torch.Tensor:
    """One roi (4,) for the whole batch, or one per item (B, 4) -> (B, 4)."""
    return roi.reshape(-1, 4).expand(b, 4)


def roi_crop_resize(img: torch.Tensor, roi: torch.Tensor, out_h: int,
                    out_w: int) -> torch.Tensor:
    """Crop img (B, H, W, C) to roi = (rmin, rmax, cmin, cmax) (inclusive
    int tensor, (4,) for every item or (B, 4) one per item) and resize to
    (out_h, out_w) with align_corners=True."""
    b, h, w, c = img.shape
    rmin, rmax, cmin, cmax = _rois(roi, b).unbind(-1)
    y0, y1, wy = _axis_sample(h, out_h, rmin, rmax)
    x0, x1, wx = _axis_sample(w, out_w, cmin, cmax)
    return _gather_2d(img.float(), y0, y1, wy, x0, x1, wx).to(img.dtype)


def roi_paste_back(probs: torch.Tensor, roi: torch.Tensor, canvas_h: int,
                   canvas_w: int) -> torch.Tensor:
    """Resize probs (B, h, w, C) to the ROI span (align_corners=True) and
    paste it into a zero (canvas_h, canvas_w) canvas, as one gather; roi
    (4,) for every item or (B, 4) one per item."""
    b, h, w, c = probs.shape
    dev = probs.device
    rmin, rmax, cmin, cmax = (v[:, None] for v in
                              _rois(roi, b).float().unbind(-1))
    r = torch.arange(canvas_h, dtype=torch.float32, device=dev)
    cc = torch.arange(canvas_w, dtype=torch.float32, device=dev)
    rh = rmax - rmin
    rw = cmax - cmin
    sy = (r - rmin) * (h - 1) / rh.clamp_min(1.0)                 # (B, Hc)
    sx = (cc - cmin) * (w - 1) / rw.clamp_min(1.0)                # (B, Wc)
    sy = torch.where(rh < 1.0, 0.0, sy)
    sx = torch.where(rw < 1.0, 0.0, sx)
    inside = (((r >= rmin) & (r <= rmax))[:, :, None]
              & ((cc >= cmin) & (cc <= cmax))[:, None, :])
    sy = sy.clamp(0.0, h - 1)
    sx = sx.clamp(0.0, w - 1)
    y0 = sy.floor().long()
    x0 = sx.floor().long()
    out = _gather_2d(probs.float(), y0, (y0 + 1).clamp_max(h - 1),
                     sy - y0.float(), x0, (x0 + 1).clamp_max(w - 1),
                     sx - x0.float())
    out = torch.where(inside[..., None], out, 0.0)
    return out.to(probs.dtype)


def _cubic_kernel(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    ax = np.abs(x)
    return np.where(
        ax <= 1.0, ((a + 2) * ax - (a + 3)) * ax * ax + 1,
        np.where(ax < 2.0, (((ax - 5) * ax + 8) * ax - 4) * a, 0.0))


def _bicubic_axis_matrix(src: int, dst: int) -> np.ndarray:
    """torch bicubic align_corners=False (dst, src) axis matrix with clamped
    taps, computed in f64 on the host and returned as f32
    (pvpuformer_tpu/ops/resize.py:182)."""
    m = np.zeros((dst, src), dtype=np.float64)
    for i in range(dst):
        x = (i + 0.5) * src / dst - 0.5
        x0 = int(np.floor(x))
        t = x - x0
        taps = np.array([x0 - 1, x0, x0 + 1, x0 + 2])
        wts = _cubic_kernel(np.array([t + 1, t, 1 - t, 2 - t]))
        for tap, wt in zip(taps, wts):
            m[i, int(np.clip(tap, 0, src - 1))] += wt
    return m.astype(np.float32)
