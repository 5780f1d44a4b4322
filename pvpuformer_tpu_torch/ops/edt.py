"""Exact squared EDT + oracle next-click selection (pvpuformer_tpu/ops/edt.py).

`squared_edt(mask)[r, c]` is the squared distance from (r, c) to the nearest
zero of `mask`, with a virtual zero ring just outside the array (the
reference's `np.pad(..., 1)` before cv2.distanceTransform). Distances are
exact integers in f32, so tie patterns match cv2's exact transform.

Pass 1 (per column, plain torch) gives the squared row distance to the
nearest zero; pass 2 (per row) is the min-plus product of ops/edt_minplus.py,
which launches the hand-written kernel on CUDA tensors.
"""
from __future__ import annotations

from typing import Optional

import torch

from .edt_minplus import minplus_rows


def _col_dist(mask: torch.Tensor) -> torch.Tensor:
    """(H, ..., W) bool over axis 0 -> int32 row distance to the nearest zero
    (virtual zero rows at -1 and H), as running max / min scans."""
    h = mask.shape[0]
    shape = (h,) + (1,) * (mask.ndim - 1)
    rows = torch.arange(h, dtype=torch.int32, device=mask.device).view(shape)
    zero_at = torch.where(mask, -h - 1, rows).clamp_min(-1)
    above = torch.cummax(zero_at, dim=0).values
    zero_dn = torch.where(mask, 2 * h + 1, rows).clamp_max(h)
    below = torch.cummin(zero_dn.flip(0), dim=0).values.flip(0)
    return torch.minimum(rows - above, below - rows)


def _col_dist2_dense(mask: torch.Tensor) -> torch.Tensor:
    """Pass 1 as a dense min-plus over rows: dcol²[r, c] = min_r' (r - r')²
    over zero rows r' (virtual zeros at -1 and H). Bit-identical to
    `_col_dist`² (exact integers in f32)."""
    h = mask.shape[0]
    rows = torch.arange(h, dtype=torch.float32, device=mask.device)
    off = (rows[:, None] - rows[None, :]).square()               # (H, H)
    z = torch.where(mask, float((2 * h + 2) ** 2), 0.0)          # (H, W)
    d = (off[:, :, None] + z[None, :, :]).amin(1)
    border = torch.minimum((rows + 1.0).square(), (h - rows).square())
    return torch.minimum(d, border[:, None])


def _pass1(masks: torch.Tensor, rows: str) -> torch.Tensor:
    """(B, H, W) bool -> (B, H, W) f32 squared column distances."""
    if rows == "dense":
        return torch.stack([_col_dist2_dense(m) for m in masks])
    if rows != "scan":
        raise ValueError(f"edt rows must be 'scan' or 'dense', got {rows!r}")
    return _col_dist(masks.transpose(0, 1)).transpose(0, 1).float().square()


def _finish(masks: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    w = masks.shape[-1]
    cols = torch.arange(w, dtype=torch.float32, device=masks.device)
    border = torch.minimum((cols + 1.0).square(), (w - cols).square())
    return torch.where(masks, torch.minimum(d, border), 0.0)


def squared_edt(mask: torch.Tensor, chunk: Optional[int] = 32,
                rows: str = "scan") -> torch.Tensor:
    """Exact squared EDT of an (H, W) bool mask. `rows` selects the pass-1
    form ("scan" or "dense", bit-identical); `chunk` sizes the plain
    min-plus version's column blocks."""
    return _squared_edt_batch(mask[None], chunk, rows)[0]


def _squared_edt_batch(masks: torch.Tensor, chunk, rows) -> torch.Tensor:
    b, h, w = masks.shape
    dcol2 = _pass1(masks, rows)
    d = minplus_rows(dcol2.reshape(b * h, w), chunk=chunk).reshape(b, h, w)
    return _finish(masks, d)


def squared_edt_pair(fn_mask: torch.Tensor, fp_mask: torch.Tensor,
                     chunk: Optional[int] = 32, rows: str = "scan"):
    """Both error-mask EDTs with ONE min-plus launch over the stacked rows."""
    d = _squared_edt_batch(torch.stack([fn_mask, fp_mask]), chunk, rows)
    return d[0], d[1]


def next_click_from_error(fn_mask: torch.Tensor, fp_mask: torch.Tensor,
                          not_clicked: torch.Tensor,
                          chunk: Optional[int] = 32, rows: str = "scan"):
    """Oracle next click: centre of the larger of the FN / FP error regions
    (clicker.py:29-56). Returns (is_positive, y, x, max_sqdist) as 0-d
    tensors; ties break to the first maximum in row-major order."""
    d_fn, d_fp = squared_edt_pair(fn_mask, fp_mask, chunk=chunk, rows=rows)
    d_fn = d_fn * not_clicked
    d_fp = d_fp * not_clicked
    fn_max = d_fn.max()
    fp_max = d_fp.max()
    is_positive = fn_max > fp_max
    d = torch.where(is_positive, d_fn, d_fp)
    flat_idx = torch.argmax(d.reshape(-1))           # first max, row-major
    w = fn_mask.shape[1]
    return (is_positive, (flat_idx // w).to(torch.int32),
            (flat_idx % w).to(torch.int32), torch.maximum(fn_max, fp_max))
