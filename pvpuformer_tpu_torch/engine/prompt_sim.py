"""Prompt synthesis on the device, batched (pvpuformer_tpu/engine/prompt_sim.py):
the box and scribble prompts of the prompt sessions and the click rounds of
training.

  * `connected_regions_mask_batch` = max_connected_regions: the largest
    8-connected component unioned with every component covering more than
    `keep_frac` of the foreground, through the two CC kernels (ops/cc.py).
  * `synth_boxes` = cal_box: the bbox of that dominant region of the error
    mask (or of the gt with `as_allmask`), optionally jittered.
  * `synth_scribbles` = cal_scribble: a Bezier curve through control points
    drawn row-wise inside the dominant gt region.
  * `next_clicks` = get_next_points (training): per sample, the exact EDT
    of the FN / FP error masks, a uniform random click inside the
    `dist > max/2` region of the larger one, written to the first free slot
    of its half; `update_ed_mask` writes that error mask into the slot's
    P2CL label; `get_next_prompts` = get_next_promts (boxes + click).

Every random draw is an argument (box jitter offsets, the scribble row
jitter `u` and column Gumbel noise `g`, the click Gumbel noise): torch
cannot reproduce `jax.random`, so a caller draws the noise and a test can
pass JAX's own. Functions are batched over the leading dimension where the
JAX package vmaps a per-sample function.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops.cc import cc_labels, component_max
from ..ops.edt import squared_edt_pair


def _first_true(v: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Index of the first True along `dim` (0 where there is none)."""
    return torch.argmax(v.to(torch.uint8), dim=dim)


def _bbox(mask: torch.Tensor):
    """(..., H, W) bool -> (y0, y1, x0, x1) int32 of the True region (an
    empty mask gives (0, H - 1, 0, W - 1), as jnp.argmax does)."""
    h, w = mask.shape[-2:]
    rows = mask.any(-1)
    cols = mask.any(-2)
    y0 = _first_true(rows)
    y1 = h - 1 - _first_true(rows.flip(-1))
    x0 = _first_true(cols)
    x1 = w - 1 - _first_true(cols.flip(-1))
    return tuple(v.to(torch.int32) for v in (y0, y1, x0, x1))


def _scatter_keep_one(masks: torch.Tensor, labs: torch.Tensor,
                      keep_frac: float) -> torch.Tensor:
    """The reference formulation, batched over (B, H, W): a size histogram
    by scatter-add into H*W + 1 label bins, the `sizes[lab]` gather, keep =
    largest | size > keep_frac * foreground. Bin 0 (background) never
    counts; the largest is the first maximum, the smallest label."""
    b, h, w = masks.shape
    flat = labs.view(b, -1).long()
    sizes = torch.zeros(b, h * w + 1, dtype=torch.int32, device=masks.device)
    sizes.scatter_add_(1, flat, masks.view(b, -1).to(torch.int32))
    bins = torch.arange(h * w + 1, device=masks.device)
    sizes = torch.where(bins == 0, 0, sizes)
    largest = torch.argmax(sizes, 1)
    total = masks.sum((1, 2)).float()
    comp_size = sizes.gather(1, flat).view(b, h, w).float()
    keep = ((labs == largest[:, None, None])
            | (comp_size > keep_frac * total[:, None, None]))
    return masks & keep


def connected_regions_mask_batch(masks: torch.Tensor, keep_frac: float = 0.1,
                                 iters: int = 8) -> torch.Tensor:
    """Batched max_connected_regions (trainer.py:1175-1190), (B, H, W) bool
    -> (B, H, W) bool, in the JAX "pallas" form:
      1. the cc_labels kernel labels the components;
      2. a component's representative is the pixel whose label is its own
         flat index + 1;
      3. representatives are ranked 1..K in row-major order (a cumsum, so
         rank order is label order);
      4. the component_max kernel floods each rank over its component;
      5. keep = largest | size > keep_frac * foreground (_scatter_keep_one
         over the ranks).
    The size histogram is a scatter_add_ into H*W + 1 bins: exact for any
    number of components, so the TPU's `compact_cap` and its lax.cond
    fallback to the scatter path (scatter is slow on the TPU) have no
    counterpart here. The largest-component tie-break stays "smallest rank
    = smallest label" (torch.argmax returns the first maximum)."""
    b, h, w = masks.shape
    labs = cc_labels(masks, iters)
    idx = torch.arange(1, h * w + 1, dtype=torch.int32,
                       device=masks.device).view(h, w)
    rep = masks & (labs == idx)
    rank = torch.cumsum(rep.view(b, -1).to(torch.int32), -1,
                        dtype=torch.int32).view(b, h, w)
    rank_img = component_max(masks, torch.where(rep, rank, 0), iters)
    return _scatter_keep_one(masks, rank_img, keep_frac)


# ---------------------------------------------------------------------------
# box synthesis (cal_box, trainer.py:1061-1131)
# ---------------------------------------------------------------------------

def _synth_box_one(masks: torch.Tensor, locs: torch.Tensor,
                   offsets: Optional[torch.Tensor], set_offset: int
                   ) -> torch.Tensor:
    """Bbox (+ jitter) of precomputed region masks (B, H, W) -> (B, 5)
    int32 [x_center, y_center, width, height, slot], zero where invalid.
    `offsets` (B, 4) int32 are the jitter draws for x0, x1, y0, y1, in
    [-set_offset, 0], [0, set_offset], [-set_offset, 0], [0, set_offset]."""
    h, w = masks.shape[-2:]
    nonempty = masks.any(-1).any(-1)
    y0, y1, x0, x1 = _bbox(masks)
    if offsets is not None:
        o = offsets.to(torch.int32)
        bx0 = (x0 + o[:, 0]).clamp_min(0).clamp_max(w - set_offset)
        bx1 = torch.maximum((x1 + o[:, 1]).clamp_max(w), bx0 + set_offset)
        by0 = (y0 + o[:, 2]).clamp_min(0).clamp_max(h - set_offset)
        by1 = torch.maximum((y1 + o[:, 3]).clamp_max(h), by0 + set_offset)
        y0, y1, x0, x1 = by0, by1, bx0, bx1
    xc = (x0 + x1) // 2
    yc = (y0 + y1) // 2
    bw = x1 - x0
    bh = y1 - y0
    ok = nonempty & (xc >= 1) & (yc >= 1) & (bw >= 1) & (bh >= 1)
    box = torch.stack([xc, yc, bw, bh, locs.to(torch.int32)], -1)
    return torch.where(ok[:, None], box, 0).to(torch.int32)


def synth_boxes(gt: torch.Tensor, fn: torch.Tensor, fp: torch.Tensor,
                points: torch.Tensor, offsets: Optional[torch.Tensor] = None,
                as_allmask: bool = False, jitter: bool = True,
                set_offset: int = 10, n_dyn=None) -> torch.Tensor:
    """Batched cal_box. gt/fn/fp: (B, H, W); points: (B, 2N, 3); `offsets`
    (B, 4) int32 jitter draws, required when `jitter`. Returns (B, 5) int32
    [x_center, y_center, width, height, slot].

    `n_dyn` (tensor or int, default N; one value or one per item) is the
    reference's per-click half capacity: slots are searched among the
    first n_dyn of a half, and the positive slot is hard-coded to n_dyn - 1
    (trainer.py:1087)."""
    b, twon, _ = points.shape
    n = twon // 2
    dev = points.device
    # the default stays a Python int: a device tensor made from a host
    # int is a copy that syncs the host (one per box round in training)
    if n_dyn is None:
        cap = lim = n
    else:
        cap = torch.as_tensor(n_dyn, dtype=torch.int32, device=dev).expand(b)
        lim = cap[:, None]
    orders = points[:, :, 2]
    slots = torch.arange(n, device=dev)

    def first_free(half_orders):
        free = (half_orders < 0) & (slots < lim)
        return torch.where(free.any(-1), _first_true(free),
                           cap - 1).to(torch.int32)

    if as_allmask:
        masks = gt > 0.5
        locs = first_free(orders[:, :n])
    else:
        is_positive = fn.sum((1, 2)) > fp.sum((1, 2))
        err = torch.where(is_positive[:, None, None], fn, fp)
        masks = connected_regions_mask_batch(err)
        locs = torch.where(is_positive, cap - 1, first_free(orders[:, n:]) + n)
    if jitter and offsets is None:
        raise ValueError("synth_boxes: jitter=True needs the jitter draws "
                         "(offsets)")
    return _synth_box_one(masks, locs, offsets if jitter else None,
                          set_offset)


# ---------------------------------------------------------------------------
# scribble synthesis (cal_scribble, trainer.py:1192-1243)
# ---------------------------------------------------------------------------

def bernstein_matrix(num_ctrl: int, num_samples: int) -> np.ndarray:
    """(num_samples, num_ctrl) f32 Bezier basis (bezier.evaluate_multi)."""
    from math import comb
    p = num_ctrl - 1
    s = np.linspace(0.0, 1.0, num_samples)[:, None]
    i = np.arange(p + 1)[None, :]
    coef = np.array([comb(p, j) for j in range(p + 1)], np.float64)
    return (coef * (s ** i) * ((1 - s) ** (p - i))).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _bernstein_on(num_ctrl: int, num_samples: int,
                  device: torch.device) -> torch.Tensor:
    """The basis on `device`, uploaded once (no copy inside a click)."""
    return torch.from_numpy(bernstein_matrix(num_ctrl, num_samples)).to(device)


def _bezier(bern: torch.Tensor, ctrl: torch.Tensor) -> torch.Tensor:
    """(S, K) basis x (B, K, 2) control points -> (B, S, 2), summed in
    order over K with separate f32 products and adds: the same bits on
    every device, and no TF32 on the card."""
    acc = bern[None, :, 0, None] * ctrl[:, None, 0]
    for k in range(1, bern.shape[1]):
        acc = acc + bern[None, :, k, None] * ctrl[:, None, k]
    return acc


def _synth_scribble_one(masks: torch.Tensor, u: torch.Tensor,
                        g: torch.Tensor, bern: torch.Tensor):
    """Scribbles of precomputed region masks (B, H, W). u: (B, K) uniform
    row jitter; g: (B, K, W) Gumbel noise for the column picks.

    Control rows spread over the row extent with jitter inside each band;
    per control row a uniform random column among the mask pixels (the
    Gumbel argmax); rows without mask pixels carry the previous valid point
    (the first falls back to the bbox centre); a Bezier through them,
    clipped to the bbox. Returns (scribbles (B, S, 2) of (col, row), rects
    (B, 4) of (col_c, row_c, col_ext, row_ext)), zero for an empty mask."""
    b, h, w = masks.shape
    k = u.shape[1]
    dev = masks.device
    nonempty = masks.any(-1).any(-1)
    y0, y1, x0, x1 = _bbox(masks)
    band = (y1 - y0).float() / k
    rows = (y0.float()[:, None]
            + band[:, None] * (torch.arange(k, dtype=torch.float32,
                                            device=dev) + u))
    rows = rows.to(torch.int32).clamp(0, h - 1)
    bidx = torch.arange(b, device=dev)[:, None]
    row_masks = masks[bidx, rows.long()]                      # (B, K, W)
    score = torch.where(row_masks, g, float("-inf"))
    cols = torch.argmax(score, -1).to(torch.int32)
    has = row_masks.any(-1)
    # empty rows carry the previous valid point (prefix propagation)
    kidx = torch.arange(k, device=dev).expand(b, k)
    last = torch.cummax(torch.where(has, kidx, -1), 1).values
    first_r = torch.where(has[:, 0], rows[:, 0], (y0 + y1) // 2)
    first_c = torch.where(has[:, 0], cols[:, 0], (x0 + x1) // 2)
    src = last.clamp_min(0)
    rs = torch.where(last >= 0, rows.gather(1, src), first_r[:, None])
    cs = torch.where(last >= 0, cols.gather(1, src), first_c[:, None])
    ctrl = torch.stack([rs, cs], -1).float()                  # (B, K, 2)
    curve = _bezier(bern, ctrl)                               # (B, S, 2)
    r = torch.minimum(torch.maximum(curve[..., 0], y0.float()[:, None]),
                      y1.float()[:, None])
    c = torch.minimum(torch.maximum(curve[..., 1], x0.float()[:, None]),
                      x1.float()[:, None])
    scr = torch.stack([c, r], -1)
    rect = torch.stack([(x0 + x1) // 2, (y0 + y1) // 2, x1 - x0, y1 - y0],
                       -1).float()
    okf = nonempty.float()
    return scr * okf[:, None, None], rect * okf[:, None]


def synth_scribbles(gt: torch.Tensor, u: torch.Tensor, g: torch.Tensor,
                    num_samples: int = 1000
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched cal_scribble. gt: (B, H, W); u: (B, K) uniform in [0, 1);
    g: (B, K, W) Gumbel noise (K = the number of control points, 10 in the
    JAX package). Returns (scribbles (B, S, 2) of (col, row), rects (B, 4))."""
    bern = _bernstein_on(u.shape[1], num_samples, gt.device)
    masks = connected_regions_mask_batch(gt > 0.5)
    return _synth_scribble_one(masks, u, g, bern)


# ---------------------------------------------------------------------------
# next click (get_next_points, trainer.py:615-703)
# ---------------------------------------------------------------------------

def _first_free_slot(orders: torch.Tensor, fallback: int) -> torch.Tensor:
    """(B, n) orders -> (B,) first index with order < 0, else `fallback`
    (trainer.py:641-652)."""
    free = orders < 0
    return torch.where(free.any(-1), _first_true(free),
                       fallback).to(torch.int32)


class ClickInfo(NamedTuple):
    has_click: torch.Tensor    # (B,) bool
    is_positive: torch.Tensor  # (B,) bool
    y: torch.Tensor            # (B,) int32
    x: torch.Tensor            # (B,) int32
    slot: torch.Tensor         # (B,) int32
    fn_mask: torch.Tensor      # (B, H, W) bool
    fp_mask: torch.Tensor      # (B, H, W) bool


def next_clicks(pred: torch.Tensor, gt: torch.Tensor, points: torch.Tensor,
                gumbel: torch.Tensor, pred_thresh: float = 0.49
                ) -> Tuple[torch.Tensor, ClickInfo]:
    """Batched get_next_points (trainer.py:615-654).

    pred: (B, H, W) probabilities; gt: (B, H, W); points: (B, 2N, 3);
    gumbel: (B, H, W) Gumbel noise, the uniform draw of the click inside
    the inner region. The EDTs of all 2B error masks run as one min-plus
    call (chunk=None, as JAX). Returns (updated points, a new
    tensor; ClickInfo for the ed-mask update)."""
    b, twon, _ = points.shape
    n = twon // 2
    w = pred.shape[-1]
    gtm = gt > 0.5
    fn = gtm & (pred < pred_thresh)
    fp = ~gtm & (pred > pred_thresh)
    d_fn, d_fp = squared_edt_pair(fn, fp, chunk=None)
    fn_max = d_fn.amax((1, 2))
    fp_max = d_fp.amax((1, 2))
    is_positive = fn_max > fp_max
    d = torch.where(is_positive[:, None, None], d_fn, d_fp)
    # linear-distance threshold dt > max/2 <=> squared > max^2/4
    inner = d > (torch.maximum(fn_max, fp_max) / 4.0)[:, None, None]
    has_click = inner.flatten(1).any(1)
    score = torch.where(inner, gumbel, float("-inf"))
    flat = torch.argmax(score.flatten(1), 1)
    y = (flat // w).to(torch.int32)
    x = (flat % w).to(torch.int32)

    orders = points[:, :, 2]
    slot_pos = _first_free_slot(orders[:, :n], n - 1)
    slot_neg = _first_free_slot(orders[:, n:], n - 1) + n
    slot = torch.where(is_positive, slot_pos, slot_neg)

    order = orders.amax(1).clamp_min(0.0) + 1.0
    row = torch.stack([y.float(), x.float(), order], -1)       # (B, 3)
    bidx = torch.arange(b, device=points.device)
    sl = slot.long()
    new_rows = torch.where(has_click[:, None], row, points[bidx, sl])
    points = points.clone()
    points[bidx, sl] = new_rows
    return points, ClickInfo(has_click, is_positive, y, x, slot, fn, fp)


def update_ed_mask(ed_mask: torch.Tensor, info: ClickInfo) -> torch.Tensor:
    """ed_mask_label[b, slot] = fn (positive) / fp (negative) for samples
    that produced a click (trainer.py:686-702). ed_mask: (B, H, W, 2N) bool."""
    err = torch.where(info.is_positive[:, None, None], info.fn_mask,
                      info.fp_mask)                              # (B, H, W)
    # a comparison, not F.one_hot, which checks its input's range on the host
    slots = torch.arange(ed_mask.shape[-1], device=ed_mask.device)
    onehot = info.slot.long()[:, None] == slots
    sel = onehot[:, None, None, :] & info.has_click[:, None, None, None]
    return torch.where(sel, err[..., None], ed_mask)


def get_next_prompts(pred: torch.Tensor, gt: torch.Tensor,
                     points: torch.Tensor, ed_mask: torch.Tensor,
                     gumbel: Optional[torch.Tensor],
                     offsets: Optional[torch.Tensor],
                     pred_thresh: float = 0.49, as_allmask: bool = False,
                     jitter_box: bool = True, update_points: bool = True):
    """One round of prompt simulation (get_next_promts, trainer.py:703-768):
    boxes from the current error masks, the next click and the ed-mask
    labels. `gumbel` (B, H, W) is the click noise, `offsets` (B, 4) the box
    jitter. With `update_points=False` (the click_indx == 0 path,
    trainer.py:370-376) only the boxes are made: no click, no EDT.
    Returns (points, boxes (B, 5) int32, ed_mask)."""
    if not update_points:
        gtm = gt > 0.5
        fn = gtm & (pred < pred_thresh)
        fp = ~gtm & (pred > pred_thresh)
        boxes = synth_boxes(gt, fn, fp, points, offsets,
                            as_allmask=as_allmask, jitter=jitter_box)
        return points, boxes, ed_mask
    new_points, info = next_clicks(pred, gt, points, gumbel, pred_thresh)
    boxes = synth_boxes(gt, info.fn_mask, info.fp_mask, points, offsets,
                        as_allmask=as_allmask, jitter=jitter_box)
    return new_points, boxes, update_ed_mask(ed_mask, info)
