"""Interactive click predictor (pvpuformer_tpu/inference/predictor.py).

A `SessionState` of device tensors threads through `click_step`, which per
click runs:
  1. the oracle next click (exact EDT over the FN / FP error masks);
  2. the zoom-in ROI update (data-dependent bounds held as a tensor);
  3. crop + resize of image and prev-mask, click remap, flip-TTA batch of 2;
  4. the model's forward (any registered family: for VPU the disk maps,
     the PPuE click encoding and the VPU forward);
  5. flip-average, sigmoid, paste-back into the canvas, and IoU.
The ROI, click slots and counters stay on the device, so a click is one
stream of launches with no host synchronisation. Every step is written
over a leading session axis: a batch of B sessions (`stack_states`) runs
one click round of all of them with the same launches as one session
(`batched_click_step`; the flip-TTA model batch is [B originals; B
flips]), and `click_step` is the batch of one; `click_scan` and
`batched_click_scan` are Python loops over clicks. `prompt_mode` 1 / 2
add box / scribble prompts synthesised on the device from the ROI-cropped
gt and error masks, in both `as_multi_prompts` protocols; their random
draws come from a CPU `torch.Generator` (`_prompt_noise`), so a session
draws the same noise on the CPU and on the card, alone or in a batch. These eager functions are
the definition and the CPU path; `Predictor` runs its rounds through
`graphs`, which replays captured rounds on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..engine.prompt_sim import (_bbox, _first_true,
                                 connected_regions_mask_batch, synth_boxes,
                                 synth_scribbles)
from torch import nn as tnn

from ..models.registry import forward_for
from ..nn import inference_model, resolve_device
from ..ops.edt import next_click_from_error, squared_edt_pair
from ..ops.resize import roi_crop_resize, roi_paste_back
from ..utils import profiling
from . import graphs

SCRIBBLE_CTRL = 10       # synth_scribbles' control points (prompt_sim.py:470)
SCRIBBLE_POINTS = 7      # cal_scribble_inference's num_p (trainer.py:921)
BOX_OFFSET = 10          # cal_box_inference's set_offset (trainer.py:920)
NOISE_SEED = 17          # the JAX predictor's key(17) (predictor.py:491)


@dataclasses.dataclass(frozen=True)
class PredictorConfig:
    """Field names match the JAX PredictorConfig. `edt_impl` is read but not
    honoured: on CUDA the min-plus pass always runs the hand-written kernel.
    `edt_chunk` sizes the plain min-plus version's blocks; `edt_rows`
    selects the pass-1 form (bit-identical). `model` is any registered
    model family's config (models/registry.py)."""
    model: Any
    target_size: Tuple[int, int] = (448, 448)
    with_flip: bool = True
    prob_thresh: float = 0.49
    zoom_prob_thresh: float = 0.50
    expansion_ratio: float = 1.4
    min_crop_size: int = 200
    recompute_thresh_iou: float = 0.5
    skip_clicks: int = -1
    cascade_step: int = 0
    cascade_adaptive: bool = False
    cascade_clicks: int = 1
    canvas_bucket: int = 64
    prompt_mode: int = 0
    as_multi_prompts: bool = True
    deterministic_prompts: bool = False
    limit_longest_side: int = 0
    net_clicks_limit: Optional[int] = None
    edt_impl: str = "xla"
    edt_chunk: Optional[int] = 32
    edt_rows: str = "scan"


class SessionState(NamedTuple):
    """One session; a batch of B sessions (`stack_states`) has the same
    fields with B in place of the 1 of image / prev_probs / points and a
    leading B on every other field (gt (B, Hc, Wc), roi (B, 4), counters
    (B,), ...)."""
    image: torch.Tensor        # (1, Hc, Wc, 3) f32 in [0, 1]
    gt: torch.Tensor           # (Hc, Wc) f32: 1 obj, 0 bg, -1 ignore (pad 0)
    prev_probs: torch.Tensor   # (1, Hc, Wc, 1) f32
    points: torch.Tensor       # (1, 2N, 3) f32 canvas (y, x, order), -1 pad
    not_clicked: torch.Tensor  # (Hc, Wc) bool
    roi: torch.Tensor          # (4,) int32 (rmin, rmax, cmin, cmax) inclusive
    has_roi: torch.Tensor      # () bool
    num_pos: torch.Tensor      # () int32
    num_neg: torch.Tensor      # () int32
    click_count: torch.Tensor  # () int32
    img_h: torch.Tensor        # () int32 valid extent
    img_w: torch.Tensor        # () int32


def init_session(image: np.ndarray, gt_mask: np.ndarray, num_max_points: int,
                 canvas_hw: Tuple[int, int], device=None) -> SessionState:
    """image (H, W, 3) uint8/float; gt_mask (H, W) with {0, 1, -1}. The
    state lies on `device` (None: the card; device="cpu" for the CPU)."""
    device = resolve_device(device)
    h, w = image.shape[:2]
    hc, wc = canvas_hw
    img = np.zeros((1, hc, wc, 3), np.float32)
    img[0, :h, :w] = image.astype(np.float32) / (
        255.0 if image.dtype == np.uint8 else 1.0)
    gt = np.zeros((hc, wc), np.float32)
    gt[:h, :w] = gt_mask.astype(np.float32)
    i32 = dict(dtype=torch.int32, device=device)
    return SessionState(
        image=torch.from_numpy(img).to(device),
        gt=torch.from_numpy(gt).to(device),
        prev_probs=torch.zeros((1, hc, wc, 1), device=device),
        points=torch.full((1, 2 * num_max_points, 3), -1.0, device=device),
        not_clicked=torch.ones((hc, wc), dtype=torch.bool, device=device),
        roi=torch.zeros(4, **i32),
        has_roi=torch.zeros((), dtype=torch.bool, device=device),
        num_pos=torch.zeros((), **i32), num_neg=torch.zeros((), **i32),
        click_count=torch.zeros((), **i32),
        img_h=torch.full((), h, **i32), img_w=torch.full((), w, **i32))


_SESSION_AXIS = ("image", "prev_probs", "points")    # lead with the session


def stack_states(states) -> SessionState:
    """Sessions of one canvas shape -> one batch of sessions."""
    return SessionState(*(
        torch.cat(fs) if name in _SESSION_AXIS else torch.stack(fs)
        for name, fs in zip(SessionState._fields, zip(*states))))


def session(states: SessionState, i: int) -> SessionState:
    """The i-th session of a batch (views)."""
    return SessionState(*(
        f[i:i + 1] if name in _SESSION_AXIS else f[i]
        for name, f in zip(SessionState._fields, states)))


def _as_batch(state: SessionState) -> SessionState:
    """One session as a batch of one (views)."""
    return SessionState(*(
        f if name in _SESSION_AXIS else f[None]
        for name, f in zip(SessionState._fields, state)))


# ---------------------------------------------------------------------------
# ROI machinery (zoom_in.py:156-200, utils/misc.py:36-79)
# ---------------------------------------------------------------------------

def _expand_clamp_bbox(bbox: torch.Tensor, ratio: float, min_size: int,
                       img_h, img_w) -> torch.Tensor:
    """(..., 4) boxes; img_h / img_w of the leading shape."""
    rmin, rmax, cmin, cmax = bbox.float().unbind(-1)
    rc = 0.5 * (rmin + rmax)
    cc = 0.5 * (cmin + cmax)
    height = (ratio * (rmax - rmin + 1)).clamp_min(float(min_size))
    width = (ratio * (cmax - cmin + 1)).clamp_min(float(min_size))
    # torch.round is round-half-to-even, like jnp.round
    out = torch.stack([torch.round(rc - 0.5 * height),
                       torch.round(rc + 0.5 * height),
                       torch.round(cc - 0.5 * width),
                       torch.round(cc + 0.5 * width)], -1).to(torch.int32)
    return torch.stack([out[..., 0].clamp_min(0),
                        torch.minimum(out[..., 1], img_h - 1),
                        out[..., 2].clamp_min(0),
                        torch.minimum(out[..., 3], img_w - 1)], -1)


def _segments_iou(a0, a1, b0, b1):
    inter = (torch.minimum(a1, b1) - torch.maximum(a0, b0) + 1.0).clamp_min(0.0)
    union = (torch.maximum(a1, b1) - torch.minimum(a0, b0) + 1.0).clamp_min(1e-6)
    return inter / union


def _bbox_iou(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    b1, b2 = b1.float(), b2.float()
    return (_segments_iou(b1[..., 0], b1[..., 1], b2[..., 0], b2[..., 1])
            * _segments_iou(b1[..., 2], b1[..., 3], b2[..., 2], b2[..., 3]))


def _clicks_inside_roi(points: torch.Tensor, n: int, roi: torch.Tensor):
    """check_object_roi (zoom_in.py:192-200), per session: all positive
    clicks of points (B, 2N, 3) inside roi (B, 4)."""
    pos = points[:, :n]
    y, x = pos[..., 0], pos[..., 1]
    inside = ((y >= roi[:, 0:1]) & (y < roi[:, 1:2])
              & (x >= roi[:, 2:3]) & (x < roi[:, 3:4]))
    return torch.where(pos[..., 2] >= 0, inside, True).all(-1)


def _update_roi(cfg: PredictorConfig, state: SessionState,
                points: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One ZoomIn.transform ROI decision (zoom_in.py:40-63) per session of
    a batch (roi (B, 4)), or of one session (roi (4,))."""
    if state.roi.dim() == 1:
        roi, has_roi = _update_roi(cfg, _as_batch(state), points)
        return roi[0], has_roi[0]
    b, twon = points.shape[:2]
    n = twon // 2
    hc, wc = state.gt.shape[-2:]
    pred = state.prev_probs[..., 0] > cfg.zoom_prob_thresh
    pred_any = pred.flatten(1).any(1) & (state.click_count > cfg.skip_clicks)

    # pred masks with the valid positive clicks stamped in (each session at
    # its own offset); invalid clicks go to a spare slot past the end, which
    # is then dropped (mode="drop")
    pos = points[:, :n]
    yy = pos[..., 0].to(torch.int32).clamp(0, hc - 1)
    xx = pos[..., 1].to(torch.int32).clamp(0, wc - 1)
    sess = torch.arange(b, device=pred.device)[:, None]
    flat = torch.where(pos[..., 2] >= 0, (sess * hc + yy) * wc + xx,
                       b * hc * wc)
    stamped = torch.cat([pred.reshape(-1), pred.new_zeros(1)])
    stamped = stamped.index_fill(0, flat.reshape(-1), True)[:-1]

    obj_roi = _expand_clamp_bbox(
        torch.stack(_bbox(stamped.reshape(b, hc, wc)), -1),
        cfg.expansion_ratio, cfg.min_crop_size, state.img_h, state.img_w)
    zero = torch.zeros_like(state.img_h)
    full_roi = torch.stack([zero, state.img_h - 1, zero, state.img_w - 1], -1)
    current = torch.where(pred_any[:, None], obj_roi, full_roi)
    update = ((~state.has_roi) | (~_clicks_inside_roi(points, n, state.roi))
              | (_bbox_iou(current, state.roi) < cfg.recompute_thresh_iou))
    roi = torch.where(update[:, None], current, state.roi)
    return roi, torch.ones_like(state.has_roi)


# ---------------------------------------------------------------------------
# prompt noise: every random draw of a click's prompt synthesis
# ---------------------------------------------------------------------------

def _gumbel(shape, gen: torch.Generator) -> torch.Tensor:
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=gen).clamp_min(tiny)
    return -torch.log(-torch.log(u))


def _to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """Host -> card without a host sync (pinned, non-blocking)."""
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def _prompt_noise(cfg: PredictorConfig, gen: torch.Generator,
                  device: torch.device) -> Dict[str, torch.Tensor]:
    """One click's random draws, from the CPU generator `gen`, on `device`.
    Only what the configuration uses is drawn; `deterministic_prompts` pins
    every draw but the scribble synthesis (as in JAX):
      multi-prompt protocol: "click_gumbel" (B, th, tw) for the extra error
        click; mode 2 "scribble_u" (B, 10) and "scribble_g" (B, 10, tw);
      points protocol, mode 1: "box_gumbel" (B, th, tw) and "box_offsets"
        (B, 4) int32 in [-10, 0], [0, 10], [-10, 0], [0, 10]; mode 2
        "points_bits" (2, B, 7) int64 32-bit draws (see _randint_from_bits)
        and "points_g" (B, 7, tw)."""
    b = 2 if cfg.with_flip else 1
    th, tw = cfg.target_size
    det = cfg.deterministic_prompts
    noise = {}
    if cfg.as_multi_prompts:
        if not det:
            noise["click_gumbel"] = _gumbel((b, th, tw), gen)
        if cfg.prompt_mode == 2:
            noise["scribble_u"] = torch.rand((b, SCRIBBLE_CTRL), generator=gen)
            noise["scribble_g"] = _gumbel((b, SCRIBBLE_CTRL, tw), gen)
    elif not det and cfg.prompt_mode == 1:
        noise["box_gumbel"] = _gumbel((b, th, tw), gen)
        neg = torch.tensor([BOX_OFFSET, 0, BOX_OFFSET, 0])
        noise["box_offsets"] = (torch.randint(0, BOX_OFFSET + 1, (b, 4),
                                              generator=gen) - neg).int()
    elif not det:
        noise["points_bits"] = torch.randint(0, 2 ** 32,
                                             (2, b, SCRIBBLE_POINTS),
                                             generator=gen)
        noise["points_g"] = _gumbel((b, SCRIBBLE_POINTS, tw), gen)
    return {k: _to_device(v, device) for k, v in noise.items()}


def _randint_from_bits(bits: torch.Tensor, minval, maxval) -> torch.Tensor:
    """jax.random.randint's map (jax/_src/random.py:_randint, int32) from
    its two 32-bit draws bits = (higher, lower) to [minval, maxval): the
    integers JAX returns for the same bits, in uint32 arithmetic."""
    m32 = 0xFFFFFFFF
    span = torch.where(maxval <= minval, 1, (maxval - minval).long() & m32)
    mult = torch.full_like(span, 2 ** 16) % span
    mult = ((mult * mult) & m32) % span
    off = ((((bits[0] % span) * mult) & m32) + bits[1] % span) & m32
    return (minval + off % span).to(torch.int32)


# ---------------------------------------------------------------------------
# prompt protocols (get_next_promts / get_next_promts_inference,
# trainer.py:703-1043), batched over the flip batch
# ---------------------------------------------------------------------------

def _rows_at(points: torch.Tensor, at: torch.Tensor) -> torch.Tensor:
    """points[b, at[b]], the index clamped into range as JAX's gather."""
    bidx = torch.arange(points.shape[0], device=points.device)
    return points[bidx, at.long().clamp(0, points.shape[1] - 1)]


def _set_rows(points: torch.Tensor, at: torch.Tensor,
              rows: torch.Tensor) -> torch.Tensor:
    """points.at[b, at[b]].set(rows) (at: (B,) or (B, K)), as a copy; an
    index outside [0, 2N) is dropped, as JAX's scatter drops it."""
    b, twon, _ = points.shape
    ext = torch.cat([points, points.new_zeros(b, 1, 3)], 1)
    at = at.long()
    at = torch.where((at >= 0) & (at < twon), at, twon)
    bidx = torch.arange(b, device=points.device)
    ext[bidx.view((b,) + (1,) * (at.dim() - 1)).expand_as(at), at] = rows
    return ext[:, :twon]


def _next_order(points: torch.Tensor) -> torch.Tensor:
    return points[:, :, 2].amax(1).clamp_min(0.0) + 1.0


def _append_error_click(pred: torch.Tensor, gt: torch.Tensor,
                        points: torch.Tensor, n_dyn: torch.Tensor,
                        gumbel: Optional[torch.Tensor],
                        pred_thresh: float) -> torch.Tensor:
    """get_next_promts' click rewrite (trainer.py:735-764) for the PPuE
    points: per batch item, the exact EDT over the FN / FP error masks (one
    min-plus launch for the whole batch), one click inside the
    `dist > max / 2` region (the first row-major pixel when `gumbel` is
    None, else the Gumbel argmax), written to the first free slot of the
    dynamic half capacity `n_dyn` (a full half overwrites slot n_dyn - 1)."""
    b, twon, _ = points.shape
    n = twon // 2
    w = pred.shape[-1]
    n_dyn = n_dyn.expand(b)                     # one value, or one per item
    gtm = gt > 0.5
    fn = gtm & (pred < pred_thresh)
    fp = ~gtm & (pred > pred_thresh)
    d_fn, d_fp = squared_edt_pair(fn, fp)
    fn_max = d_fn.amax((1, 2))
    fp_max = d_fp.amax((1, 2))
    is_pos = fn_max > fp_max
    d = torch.where(is_pos[:, None, None], d_fn, d_fp)
    inner = d > (torch.maximum(fn_max, fp_max) / 4.0)[:, None, None]
    has = inner.any(-1).any(-1)
    if gumbel is None:
        flat = _first_true(inner.view(b, -1))
    else:
        score = torch.where(inner, gumbel, float("-inf"))
        flat = torch.argmax(score.view(b, -1), -1)
    orders = points[:, :, 2]
    half = torch.where(is_pos[:, None], orders[:, :n], orders[:, n:])
    free = (half < 0) & (torch.arange(n, device=points.device)
                         < n_dyn[:, None])
    slot = torch.where(free.any(1), _first_true(free), n_dyn - 1)
    slot = torch.where(is_pos, slot, slot + n)
    rows = torch.stack([(flat // w).float(), (flat % w).float(),
                        _next_order(points)], -1)
    new = torch.where(has[:, None], rows, _rows_at(points, slot))
    return _set_rows(points, slot, new)


def _value_in_mask_coords(mask: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The reference's `v in np.argwhere(mask)` (trainer.py:822): the VALUE
    v among all row AND column coordinates of foreground pixels."""
    h, w = mask.shape[-2:]
    dev = mask.device
    rows = mask.any(-1)
    cols = mask.any(-2)
    return ((rows & (torch.arange(h, device=dev) == v[:, None])).any(-1)
            | (cols & (torch.arange(w, device=dev) == v[:, None])).any(-1))


def _box_prompt_one(gtb: torch.Tensor, noise: Dict[str, torch.Tensor],
                    det: bool, set_offset: int = BOX_OFFSET):
    """cal_box_inference with as_allmask=True, jitter_box=True
    (trainer.py:770-842), batched: the gt bbox with jittered, clamped
    edges; the centre is replaced by a random foreground pixel when neither
    centre coordinate VALUE appears among the foreground coordinates; zero
    unless centre >= 1 and extents >= 1. `det` pins the offsets to 0 and the
    pixel to the first foreground one. Returns ((B, 6) int32 [y0, x0, y1,
    x1, y_c, x_c], (B,) ok)."""
    b, h, w = gtb.shape
    has = gtb.any(-1).any(-1)
    y0, y1, x0, x1 = _bbox(gtb)
    if det:
        flat = _first_true(gtb.view(b, -1))
        o = torch.zeros(b, 4, dtype=torch.int32, device=gtb.device)
    else:
        score = torch.where(gtb, noise["box_gumbel"], float("-inf"))
        flat = torch.argmax(score.view(b, -1), -1)
        o = noise["box_offsets"]
    iy = (flat // w).to(torch.int32)
    ix = (flat % w).to(torch.int32)
    bx0 = (x0 + o[:, 0]).clamp_min(0).clamp_max(w - set_offset)
    bx1 = torch.maximum((x1 + o[:, 1]).clamp_max(w), bx0 + set_offset)
    by0 = (y0 + o[:, 2]).clamp_min(0).clamp_max(h - set_offset)
    by1 = torch.maximum((y1 + o[:, 3]).clamp_max(h), by0 + set_offset)
    xc = (bx0 + bx1) // 2
    yc = (by0 + by1) // 2
    sub = ~_value_in_mask_coords(gtb, xc) & ~_value_in_mask_coords(gtb, yc)
    xc = torch.where(sub, ix, xc)
    yc = torch.where(sub, iy, yc)
    ok = has & (xc >= 1) & (yc >= 1) & (bx1 - bx0 >= 1) & (by1 - by0 >= 1)
    out = torch.stack([by0, bx0, by1, bx1, yc, xc], -1).to(torch.int32)
    return torch.where(ok[:, None], out, 0), ok


def _rewrite_points_box(net_points: torch.Tensor, gtb: torch.Tensor,
                        noise: Dict[str, torch.Tensor], n_dyn: torch.Tensor,
                        first: torch.Tensor, det: bool,
                        sessions: int = 1) -> torch.Tensor:
    """as_prompt_type=1 points rewrite (trainer.py:963-1009): on the first
    click the clicks are DISCARDED and replaced by [centre (+, order 1) |
    corner0 (-, order 0), corner1 (-, order 2)]; afterwards the three
    pseudo-clicks follow the live clicks (centre at positive slot n_dyn,
    corners at negative slots n_dyn, n_dyn + 1) with orders (max + 2,
    max + 1, max + 3). `first` and `n_dyn` are one value or one per item.
    The items are the forward batch of `sessions` sessions, [B originals;
    B flips]: a session keeps its clicks when no item of its own flip pair
    has a box (JAX's `jnp.any(ok)` under its per-session vmap)."""
    b, twon, _ = net_points.shape
    n = twon // 2
    first, n_dyn = first.expand(b), n_dyn.expand(b)
    bp, ok = _box_prompt_one(gtb, noise, det)
    bpf = bp.float()
    order = _next_order(net_points)
    o_center = torch.where(first, 1.0, order + 1.0)
    o_c0 = torch.where(first, 0.0, order)
    o_c1 = torch.where(first, 2.0, order + 2.0)
    base = torch.where(first[:, None, None], -1.0, net_points)
    idx = torch.where(first, 0, n_dyn)

    def put(pts, at, row):
        return _set_rows(pts, at, torch.where(ok[:, None], row,
                                              _rows_at(pts, at)))

    pts = put(base, idx, torch.stack([bpf[:, 4], bpf[:, 5], o_center], -1))
    pts = put(pts, idx + n, torch.stack([bpf[:, 0], bpf[:, 1], o_c0], -1))
    pts = put(pts, idx + n + 1, torch.stack([bpf[:, 2], bpf[:, 3], o_c1], -1))
    any_ok = ok.view(-1, sessions).any(0).repeat(b // sessions)
    return torch.where(any_ok[:, None, None], pts, net_points)


def _scribble_points_one(masks: torch.Tensor, noise: Dict[str, torch.Tensor],
                         det: bool, num_p: int = SCRIBBLE_POINTS):
    """cal_scribble_inference control points (trainer.py:844-899), batched:
    rows stepped from the region's row min by `row_extent // 7` (plus a
    randint(0, max(gap, 1)) jitter unless `det`); per row one foreground
    pixel (the first for `det`, else the Gumbel argmax). Rows without
    foreground are invalid. Returns (rows, cols, valid), each (B, num_p)."""
    b, h, w = masks.shape
    y0, y1, _, _ = _bbox(masks)
    gap = (y1 - y0) // num_p
    i = torch.arange(num_p, dtype=torch.int32, device=masks.device)
    rows = y0[:, None] + i * gap[:, None]
    if not det:
        rows = rows + _randint_from_bits(noise["points_bits"], 0,
                                         gap.clamp_min(1)[:, None])
    rows = rows.clamp(0, h - 1)
    bidx = torch.arange(b, device=masks.device)[:, None]
    row_masks = masks[bidx, rows.long()]                     # (B, K, W)
    valid = row_masks.any(-1)
    if det:
        cols = _first_true(row_masks)
    else:
        cols = torch.argmax(torch.where(row_masks, noise["points_g"],
                                        float("-inf")), -1)
    return rows, cols.to(torch.int32), valid


def _rewrite_points_scribble(net_points: torch.Tensor, gtb: torch.Tensor,
                             noise: Dict[str, torch.Tensor],
                             n_dyn: torch.Tensor, first: torch.Tensor,
                             det: bool) -> torch.Tensor:
    """as_prompt_type=2 points rewrite (trainer.py:1011-1041): the scribble
    CONTROL points become positive pseudo-clicks, replacing the clicks on
    the first click (orders 0..K-1), after them otherwise (positive slots
    n_dyn.., orders max + 1 + p); invalid rows are compacted away.
    `first` and `n_dyn` are one value or one per item."""
    b, twon, _ = net_points.shape
    first, n_dyn = first.expand(b), n_dyn.expand(b)
    masks = connected_regions_mask_batch(gtb)      # max_connected_regions
    rows, cols, valid = _scribble_points_one(masks, noise, det)
    valid = valid & gtb.any(-1).any(-1)[:, None]
    rank = torch.cumsum(valid.to(torch.int32), 1) - 1
    o = (torch.where(first, 0.0, _next_order(net_points))[:, None]
         + rank.float())
    slots = torch.where(valid, torch.where(first, 0, n_dyn)[:, None] + rank,
                        twon)
    base = torch.where(first[:, None, None], -1.0, net_points)
    return _set_rows(base, slots,
                     torch.stack([rows.float(), cols.float(), o], -1))


# ---------------------------------------------------------------------------
# click step
# ---------------------------------------------------------------------------

def _transform_points(points: torch.Tensor, roi: torch.Tensor,
                      crop_hw: Tuple[int, int], with_flip: bool) -> torch.Tensor:
    """Canvas clicks (B, 2N, 3) -> zoomed coords in each session's roi
    (B, 4) (zoom_in.py:141-153), plus the flipped duplicates after them
    (flip.py:9-21): [B originals; B flips]. Invalid slots stay (-1, -1, -1)."""
    ch, cw = crop_hw
    rmin, rmax, cmin, cmax = (v[:, None] for v in roi.unbind(-1))
    y, x, order = points.unbind(-1)
    valid = order >= 0
    ny = ch * (y - rmin) / (rmax - rmin + 1).float()
    nx = cw * (x - cmin) / (cmax - cmin + 1).float()
    t = torch.stack([torch.where(valid, ny, -1.0),
                     torch.where(valid, nx, -1.0), order], -1)
    if not with_flip:
        return t
    tf = torch.stack([t[..., 0], torch.where(valid, cw - t[..., 1] - 1, -1.0),
                      order], -1)
    return torch.cat([t, tf], 0)


def _session_noise(noise: Dict[str, torch.Tensor],
                   b: int) -> Dict[str, torch.Tensor]:
    """One session's draws (`_prompt_noise`) -> the forward batch of B
    sessions, [B originals; B flips]: draw r of the flip pair on rows
    [r B, (r + 1) B). JAX's prompt key depends only on the click count
    (predictor.py:491), so under its vmap every session draws what its own
    sequential session draws; so does each session here."""
    if b == 1:
        return noise
    return {k: v.repeat_interleave(b, 1 if k == "points_bits" else 0)
            for k, v in noise.items()}


def _prompt_inputs(cfg: PredictorConfig, state: SessionState,
                   crop: torch.Tensor, pts: torch.Tensor, roi: torch.Tensor,
                   noise: Dict[str, torch.Tensor]):
    """Box / scribble prompts from the ROI-cropped gt and error masks
    (predictor.py:482-526), for a batch of B sessions (the forward batch
    [B originals; B flips]); `noise` is one session's flip pair of draws.
    Returns (points, boxes, scribbles, ppue_points, prompt_type) for the
    forward."""
    th, tw = cfg.target_size
    b = state.gt.shape[0]
    rows = 2 if cfg.with_flip else 1
    noise = _session_noise(noise, b)
    gtc = roi_crop_resize(state.gt[..., None], roi, th, tw)
    if cfg.with_flip:
        gtc = torch.cat([gtc, gtc.flip(2)], 0)
    gtf = gtc[..., 0]
    gtb = gtf > 0.5
    # per session, repeated over the forward batch's flip rows
    first = (state.click_count <= 1).repeat(rows)  # eval's click_indx == 0
    det = cfg.deterministic_prompts
    nmax = torch.maximum(state.num_pos, state.num_neg)
    if cfg.net_clicks_limit is not None:
        nmax = nmax.clamp_max(cfg.net_clicks_limit)
    n_dyn = nmax.clamp_min(1).repeat(rows)         # base.py:199-202
    if not cfg.as_multi_prompts:
        # points-rewrite protocol (base.py:153-163): box corners / scribble
        # control points become pseudo-clicks of a plain click forward
        if cfg.prompt_mode == 1:
            pts = _rewrite_points_box(pts, gtb, noise, n_dyn, first, det, b)
        else:
            pts = _rewrite_points_scribble(pts, gtb, noise, n_dyn, first,
                                           det)
        return pts, None, None, None, 0
    # prompt-tensor protocol (base.py:166-177): boxes from the dominant ROI
    # error region, plus get_next_promts' extra error click appended to the
    # PPuE points only (the disks keep the live clicks)
    prevb = crop[..., 3]
    fn = gtb & (prevb < cfg.prob_thresh)
    fp = ~gtb & (prevb > cfg.prob_thresh)
    boxes = synth_boxes(gtf, fn, fp, pts, as_allmask=False, jitter=False,
                        n_dyn=n_dyn).float()
    ppue_points = _append_error_click(prevb, gtf, pts, n_dyn,
                                      noise.get("click_gumbel"),
                                      cfg.prob_thresh)
    scribbles = None
    if cfg.prompt_mode == 2:
        scr, rects = synth_scribbles(gtf, noise["scribble_u"],
                                     noise["scribble_g"], num_samples=1000)
        scribbles = (scr[:, None], rects[:, None])
    return pts, boxes, scribbles, ppue_points, cfg.prompt_mode


def _forward_round(model: tnn.Module, cfg: PredictorConfig,
                   state: SessionState, points: torch.Tensor, prev_probs: torch.Tensor,
                   noise: Optional[Dict[str, torch.Tensor]] = None):
    """ROI update + crop + net forward + paste-back of a batch of sessions,
    using `prev_probs`. `noise`: the click's prompt draws (prompt_mode 1 / 2),
    one session's, which every session of the batch draws alike."""
    st = state._replace(prev_probs=prev_probs)
    roi, has_roi = _update_roi(cfg, st, points)
    th, tw = cfg.target_size
    b = points.shape[0]
    net_in = torch.cat([state.image, prev_probs], -1)
    crop = roi_crop_resize(net_in, roi, th, tw)                 # (B, th, tw, 4)
    if cfg.with_flip:
        crop = torch.cat([crop, crop.flip(2)], 0)
    net_points = points
    if cfg.net_clicks_limit is not None:
        net_points = torch.where(points[..., 2:3] < cfg.net_clicks_limit,
                                 points, -1.0)
    pts = _transform_points(net_points, roi, (th, tw), cfg.with_flip)
    boxes = scribbles = ppue_points = None
    prompt_type = 0
    if cfg.prompt_mode != 0:
        pts, boxes, scribbles, ppue_points, prompt_type = _prompt_inputs(
            cfg, state, crop, pts, roi, noise)
    logits = forward_for(cfg.model)(
        model, cfg.model, crop, pts, boxes=boxes, scribbles=scribbles,
        prompt_type=prompt_type, ppue_points=ppue_points)["instances"]
    profiling.stage("output")
    if cfg.with_flip:
        logits = 0.5 * (logits[:b] + logits[b:].flip(2))
    probs = torch.sigmoid(logits.float())
    hc, wc = state.gt.shape[-2:]
    return roi_paste_back(probs, roi, hc, wc), roi, has_roi


def _put_click(states: SessionState, is_pos: torch.Tensor, cy: torch.Tensor,
               cx: torch.Tensor, clear: bool = True) -> SessionState:
    """Write one click per session of a batch (is_pos, cy, cx (B,), cy / cx
    int32 canvas coords) into its slot (a click past the limit overwrites
    the last slot of its sign), with order = click_count; with `clear`,
    clear not_clicked there (the oracle's clicks, always inside the
    canvas)."""
    b, twon = states.points.shape[:2]
    n = twon // 2
    hc, wc = states.gt.shape[-2:]
    sess = torch.arange(b, device=states.gt.device)
    row = torch.stack([cy.float(), cx.float(), states.click_count.float()], -1)
    slot = torch.where(is_pos, states.num_pos.clamp_max(n - 1),
                       n + states.num_neg.clamp_max(n - 1))
    points = states.points.reshape(b * twon, 3).index_copy(
        0, sess * twon + slot, row).reshape(b, twon, 3)
    not_clicked = states.not_clicked
    if clear:
        not_clicked = not_clicked.reshape(-1).index_fill(
            0, (sess * hc + cy) * wc + cx, False).reshape(b, hc, wc)
    return states._replace(points=points, not_clicked=not_clicked,
                           num_pos=states.num_pos + is_pos.int(),
                           num_neg=states.num_neg + (~is_pos).int(),
                           click_count=states.click_count + 1)


def _put_user_click(states: SessionState, is_pos: torch.Tensor,
                    cy: torch.Tensor, cx: torch.Tensor) -> SessionState:
    """`_put_click` for a click from a person, which may lie off the
    canvas: not_clicked is cleared as JAX's `.at[cy, cx].set(False)` does
    (a negative coord counts from the end, a coord outside clears
    nothing); the slot keeps the coords as given."""
    b = states.points.shape[0]
    hc, wc = states.gt.shape[-2:]
    sess = torch.arange(b, device=states.gt.device)
    wy = torch.where(cy < 0, cy + hc, cy)
    wx = torch.where(cx < 0, cx + wc, cx)
    inside = (wy >= 0) & (wy < hc) & (wx >= 0) & (wx < wc)
    flat = (sess * hc + wy.clamp(0, hc - 1)) * wc + wx.clamp(0, wc - 1)
    not_clicked = states.not_clicked.reshape(-1)
    not_clicked = not_clicked.index_put(
        (flat,), not_clicked[flat] & ~inside).reshape(b, hc, wc)
    return _put_click(states._replace(not_clicked=not_clicked), is_pos, cy,
                      cx, clear=False)


def _iou(cfg: PredictorConfig, states: SessionState,
         probs: torch.Tensor) -> torch.Tensor:
    """Per-session IoU of probs > prob_thresh against the gt (ignore -1;
    inference/utils.py:80-87); 0 for an empty gt and prediction."""
    gt_pos = states.gt == 1
    not_ignore = states.gt != -1
    pm = probs[..., 0] > cfg.prob_thresh
    inter = (pm & gt_pos & not_ignore).flatten(1).sum(1)
    union = ((pm | gt_pos) & not_ignore).flatten(1).sum(1)
    return inter.float() / union.float().clamp_min(1.0)


def _draw_noise(cfg: PredictorConfig, gen: Optional[torch.Generator],
                device: torch.device) -> Optional[Dict[str, torch.Tensor]]:
    """One round's prompt draws (None for clicks), one session's, from the
    CPU generator `gen` (None: a fresh generator seeded NOISE_SEED)."""
    if cfg.prompt_mode == 0:
        return None
    if gen is None:
        gen = torch.Generator().manual_seed(NOISE_SEED)
    return _prompt_noise(cfg, gen, device)


def _click_step(model: tnn.Module, cfg: PredictorConfig, states: SessionState,
                noise: Optional[Dict[str, torch.Tensor]]):
    """One interactive round of every session of a batch: (new states,
    ious (B,)). One min-plus launch for the B oracle clicks and one model
    forward at batch 2B (B without flip). `noise`: the round's prompt draws
    (`_draw_noise`), or None for clicks."""
    # --- 1. oracle next click (clicker.py:21-69) ---
    profiling.stage("oracle")
    pred = states.prev_probs[..., 0] > cfg.prob_thresh
    gt_pos = states.gt == 1
    not_ignore = states.gt != -1
    fn = gt_pos & ~pred & not_ignore
    fp = ~gt_pos & pred & not_ignore
    is_pos, cy, cx, _ = next_click_from_error(
        fn, fp, states.not_clicked, chunk=cfg.edt_chunk, rows=cfg.edt_rows)
    st = _put_click(states, is_pos, cy, cx)
    points, click_count = st.points, st.click_count

    # --- 2. forward, with the optional CFR cascade (base.py:59-72) ---
    profiling.stage("input")
    probs, roi, has_roi = _forward_round(model, cfg, st, points, st.prev_probs,
                                         noise)
    if cfg.cascade_step > 1:
        active = click_count <= cfg.cascade_clicks
        for _ in range(cfg.cascade_step - 1):
            profiling.stage("input")
            nxt = torch.where(active[:, None, None, None],
                              _forward_round(model, cfg, st, points, probs,
                                             noise)[0], probs)
            if cfg.cascade_adaptive:
                diff = ((nxt > cfg.prob_thresh)
                        != (probs > cfg.prob_thresh)).flatten(1).sum(1)
                active = active & (diff > 20)
            probs = nxt
    st = st._replace(prev_probs=probs, roi=roi, has_roi=has_roi)

    # --- 3. IoU (inference/utils.py:80-87) ---
    return st, _iou(cfg, st, probs)


def click_step(model: tnn.Module, cfg: PredictorConfig, state: SessionState,
               gen: Optional[torch.Generator] = None):
    """One full interactive round of one session. Returns (new_state, iou).
    `gen` (a CPU generator) supplies the prompt draws of prompt_mode 1 / 2,
    once per click (every cascade round reuses them, as JAX's per-click key
    does); None draws from a fresh generator seeded NOISE_SEED."""
    st, iou = _click_step(model, cfg, _as_batch(state),
                          _draw_noise(cfg, gen, state.image.device))
    return session(st, 0), iou[0]


def batched_click_step(model: tnn.Module, cfg: PredictorConfig,
                       states: SessionState,
                       gen: Optional[torch.Generator] = None):
    """One round of every session of a batch (`stack_states`): (new states,
    ious (B,)), each session's the same as its own `click_step`'s. `gen`
    supplies one session's prompt draws, which every session takes (as
    `click_step` does; None: a fresh generator seeded NOISE_SEED)."""
    return _click_step(model, cfg, states,
                       _draw_noise(cfg, gen, states.image.device))


def user_click_step(model: tnn.Module, cfg: PredictorConfig,
                    state: SessionState, y: torch.Tensor, x: torch.Tensor,
                    is_positive: torch.Tensor):
    """One round of one session with a user's click in place of the
    oracle's (the GUI / serving path, predictor.py:597-634; the gt plays no
    part in the click). y, x: 0-d float tensors of canvas coords, truncated
    to int32 as JAX's `jnp.asarray(y, jnp.int32)` does; is_positive: a 0-d
    bool tensor. All three lie on the session's device, so the round makes
    no host sync. Returns (new_state, iou against state.gt: 0 for a
    gt-less demo session)."""
    st, iou = _user_click_step(model, cfg, _as_batch(state), y, x,
                               is_positive)
    return session(st, 0), iou[0]


def _user_click_step(model: tnn.Module, cfg: PredictorConfig,
                     states: SessionState, y: torch.Tensor, x: torch.Tensor,
                     is_positive: torch.Tensor):
    """`user_click_step` on a batch of one session: (states, ious (1,))."""
    profiling.stage("input")
    states = _put_user_click(states, is_positive.reshape(1),
                             y.to(torch.int32).reshape(1),
                             x.to(torch.int32).reshape(1))
    probs, roi, has_roi = _forward_round(model, cfg, states, states.points,
                                         states.prev_probs)
    states = states._replace(prev_probs=probs, roi=roi, has_roi=has_roi)
    return states, _iou(cfg, states, probs)


def click_scan(model: tnn.Module, cfg: PredictorConfig, state: SessionState,
               num_clicks: int, gen: Optional[torch.Generator] = None):
    """`num_clicks` rounds; returns (final state, ious (num_clicks,) tensor).
    The prompt draws of all rounds come from `gen` (None: one generator
    seeded NOISE_SEED for the scan)."""
    if gen is None:
        gen = torch.Generator().manual_seed(NOISE_SEED)
    ious = []
    for _ in range(num_clicks):
        state, iou = click_step(model, cfg, state, gen)
        ious.append(iou)
    return state, torch.stack(ious)


def batched_click_scan(model: tnn.Module, cfg: PredictorConfig,
                       states: SessionState, num_clicks: int,
                       gen: Optional[torch.Generator] = None):
    """`num_clicks` rounds of a batch of sessions. Returns (final states,
    ious (B, num_clicks)). The prompt draws of all rounds come from `gen`
    (None: one generator seeded NOISE_SEED for the scan), as each session's
    own `click_scan` draws them."""
    if gen is None:
        gen = torch.Generator().manual_seed(NOISE_SEED)
    ious = []
    for _ in range(num_clicks):
        states, iou = batched_click_step(model, cfg, states, gen)
        ious.append(iou)
    return states, torch.stack(ious, 1)


# ---------------------------------------------------------------------------
# host-side driver
# ---------------------------------------------------------------------------

class Predictor:
    """Session driver: canvas bucketing and an undo stack (the reference
    controller's session surface, headless). The model is moved to `device`
    (None: the card; device="cpu" for the CPU) and cast once to the
    config's compute dtype, in place; with `int8` it runs a quantized copy
    (`nn.inference_model`). Each `set_input` restarts the prompt draws from
    a CPU generator seeded NOISE_SEED. Rounds run through `graphs`: on the
    card replayed from a round captured per shape (the counterpart of
    JAX's per-shape compile cache) once a shape's first round has run
    eagerly; on the CPU eagerly. Its calls are traced
    (`utils/profiling.py`): spans `predictor.set_input`, `predictor.round`
    and, inside a round, `predictor.read`, the host read that waits for
    the card."""

    def __init__(self, model: tnn.Module, cfg: PredictorConfig, device=None,
                 int8: bool = False):
        self.device = resolve_device(device)
        self.model = inference_model(model, cfg.model.dtype, self.device,
                                     int8)
        self.cfg = cfg
        self.gen = torch.Generator()
        self.state: Optional[SessionState] = None
        self._undo: list = []

    def _canvas(self, h: int, w: int) -> Tuple[int, int]:
        b = self.cfg.canvas_bucket
        return (-(-h // b) * b, -(-w // b) * b)

    def set_input(self, image: np.ndarray, gt_mask: np.ndarray):
        with profiling.span("predictor.set_input"):
            lls = self.cfg.limit_longest_side
            if lls and max(image.shape[:2]) > lls:
                from PIL import Image as PILImage
                scale = lls / max(image.shape[:2])
                nh = max(1, int(round(image.shape[0] * scale)))
                nw = max(1, int(round(image.shape[1] * scale)))
                image = np.asarray(PILImage.fromarray(
                    np.ascontiguousarray(image)).resize((nw, nh),
                                                        PILImage.BILINEAR))
                gt_mask = np.asarray(PILImage.fromarray(
                    gt_mask.astype(np.int32), mode="I").resize(
                        (nw, nh), PILImage.NEAREST))
            self.state = init_session(
                image, gt_mask, self.cfg.model.num_max_points,
                self._canvas(*image.shape[:2]), self.device)
            self.gen.manual_seed(NOISE_SEED)
            self._undo = []

    def _scan(self, num_clicks: int):
        st, ious = graphs.click_rounds(self.model, self.cfg,
                                       _as_batch(self.state), num_clicks,
                                       self.gen)
        return session(st, 0), ious[0]

    @torch.no_grad()
    def next_click(self) -> float:
        """One oracle-driven round; returns IoU."""
        with profiling.span("predictor.round"):
            self._undo.append(self.state)
            self.state, ious = self._scan(1)
            with profiling.span("predictor.read"):
                return float(ious[0])

    @torch.no_grad()
    def user_click(self, y: float, x: float, is_positive: bool) -> float:
        """One round with a user's click (the GUI / serving path); returns
        IoU against the session's gt (0 for a gt-less demo session). Grad
        mode is off, whatever the calling thread's: the undo stack keeps
        the states, which must not hold a forward's autograd graph."""
        with profiling.span("predictor.round"):
            self._undo.append(self.state)
            self.state, iou = graphs.user_click_round(
                self.model, self.cfg, self.state, y, x, is_positive)
            with profiling.span("predictor.read"):
                return float(iou)

    @torch.no_grad()
    def run_clicks(self, num_clicks: int) -> np.ndarray:
        """`num_clicks` rounds; returns the IoU curve (one host read)."""
        with profiling.span("predictor.round"):
            self._undo.append(self.state)
            self.state, ious = self._scan(num_clicks)
            with profiling.span("predictor.read"):
                return ious.cpu().numpy()

    def undo_click(self) -> None:
        if self._undo:
            self.state = self._undo.pop()

    @property
    def probs(self) -> np.ndarray:
        h, w = int(self.state.img_h), int(self.state.img_w)
        return self.state.prev_probs[0, :h, :w, 0].cpu().numpy()

    @property
    def clicks(self) -> np.ndarray:
        return self.state.points[0].cpu().numpy()
