"""Host-side scribble synthesis for training batches (a copy of
pvpuformer_tpu/data/scribbles.py: the same draws, the same curves).

Port of `cal_scribble` / `bezier_curve` (`isegm/engine/trainer.py:1135-1243`):
sample 3-10 points column-wise inside the target mask, fit either a Bezier
curve (Bernstein evaluation — replaces the `bezier` package, not in the
image) or a B-spline (scipy.make_interp_spline), sample `num_samples` points,
clip to the mask bbox. Output matches the trainer's layout: scribbles
(num_samples, 2) of (col, row) and rect (col_center, row_center, col_extent,
row_extent) — the reference's variable names call rows "x"
(trainer.py:1205-1209), so its `[y_center, x_center, b_height, b_width]`
is col-first.

The reference recomputes scribbles from gt every round (trainer.py:727); they
depend only on gt, so the input pipeline precomputes one draw per batch and
the fused train step reuses it (documented in engine/train_step.py).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def bezier_multi(control: np.ndarray, num_samples: int) -> np.ndarray:
    """Bernstein-basis evaluation of a Bezier curve: control (P, 2) ->
    (num_samples, 2). Equivalent to bezier.Curve.evaluate_multi
    (trainer.py:1137-1144)."""
    p = control.shape[0] - 1
    s = np.linspace(0.0, 1.0, num_samples)[:, None]          # (S, 1)
    # binomial coefficients
    from math import comb
    coef = np.array([comb(p, i) for i in range(p + 1)], np.float64)
    i = np.arange(p + 1)[None, :]
    basis = coef[None, :] * (s ** i) * ((1 - s) ** (p - i))  # (S, P+1)
    return basis @ control.astype(np.float64)


def _largest_region(mask: np.ndarray) -> np.ndarray:
    """Host max_connected_regions (trainer.py:1175-1190 semantics — largest
    8-connected component plus >10% components)."""
    from scipy import ndimage
    lab, nlab = ndimage.label(mask, structure=np.ones((3, 3)))
    if nlab == 0:
        return np.zeros_like(mask, bool)
    sizes = np.bincount(lab.ravel())
    sizes[0] = 0
    largest = sizes.argmax()
    total = mask.sum()
    keep = lab == largest
    for j in range(1, nlab + 1):
        if sizes[j] > 0.1 * total:
            keep |= lab == j
    return keep


def cal_scribble_single(rng: np.random.Generator, gt_mask: np.ndarray,
                        min_p: int = 3, max_p: int = 10,
                        num_samples: int = 1000
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """One sample of trainer.py:1192-1243. gt_mask: (H, W) {0,1}.
    Returns (scribble (num_samples, 2) of (col, row) float32,
             rect (4,) of (col_c, row_c, col_extent, row_extent) float32)."""
    if gt_mask.sum() == 0:
        return (np.zeros((num_samples, 2), np.float32),
                np.zeros((4,), np.float32))

    mask = _largest_region(gt_mask > 0.5)
    ind = np.argwhere(mask)
    num_p = int(rng.integers(min_p, max_p + 1))
    # NB reference variable names: its `x` runs over rows (dim 0)
    x0, x1 = ind[:, 0].min(), ind[:, 0].max()
    y0, y1 = ind[:, 1].min(), ind[:, 1].max()
    b_width = int(x1 - x0)
    b_height = int(y1 - y0)
    rect = np.array([(y0 + y1) // 2, (x0 + x1) // 2, b_height, b_width],
                    np.float32)
    bbox = [x0, y0, x1, y1]

    value = x0
    gap = max(b_width // num_p, 0)
    s_points = []
    for _ in range(num_p):
        hi = value + gap - 1 if gap > 0 else value
        row = int(rng.integers(value, max(hi, value) + 1))
        cand = ind[ind[:, 0] == row]
        if len(cand) > 0:
            s_points.append(cand[int(rng.integers(0, len(cand)))])
        value += gap
    if not s_points:
        return (np.zeros((num_samples, 2), np.float32),
                np.zeros((4,), np.float32))

    pts = np.asarray(s_points, np.float64)           # rows (r, c)
    as_inline = rng.uniform() > 0.5
    if as_inline or len(pts) < 4:
        data = bezier_multi(pts, num_samples)
        r = np.clip(data[:, 0], bbox[0], bbox[2]).astype(int)
        c = np.clip(data[:, 1], bbox[1], bbox[3]).astype(int)
    else:
        try:
            from scipy.interpolate import make_interp_spline
            rr, cc = pts[:, 0], pts[:, 1]
            uniq = np.unique(rr, return_index=True)[1]
            spline = make_interp_spline(rr[sorted(uniq)], cc[sorted(uniq)])
            r = np.linspace(rr.min(), rr.max(), num_samples)
            c = spline(r)
            r = np.clip(r, bbox[0], bbox[2]).astype(int)
            c = np.clip(c, bbox[1], bbox[3]).astype(int)
        except Exception:
            data = bezier_multi(pts, num_samples)
            r = np.clip(data[:, 0], bbox[0], bbox[2]).astype(int)
            c = np.clip(data[:, 1], bbox[1], bbox[3]).astype(int)

    # trainer.py:1232: scribbles[:, ::-1] -> (col, row) = (x, y) order
    scr = np.stack([c, r], axis=1).astype(np.float32)
    return scr, rect


def batch_scribbles(rng: np.random.Generator, gt: np.ndarray,
                    num_samples: int = 1000
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """gt: (B, H, W). Returns (scribbles (B, S, 2), rects (B, 4))."""
    scr, rects = zip(*[cal_scribble_single(rng, g, num_samples=num_samples)
                       for g in gt])
    return np.stack(scr), np.stack(rects)
