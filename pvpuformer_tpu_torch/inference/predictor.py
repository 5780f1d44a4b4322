"""Interactive click predictor (pvpuformer_tpu/inference/predictor.py).

A `SessionState` of device tensors threads through `click_step`, which per
click runs:
  1. the oracle next click (exact EDT over the FN / FP error masks);
  2. the zoom-in ROI update (data-dependent bounds held as a tensor);
  3. crop + resize of image and prev-mask, click remap, flip-TTA batch of 2;
  4. disk maps + PPuE click encoding + the VPU forward;
  5. flip-average, sigmoid, paste-back into the canvas, and IoU.
The ROI, click slots and counters stay on the device, so a click is one
stream of launches with no host synchronisation; `click_scan` is a Python
loop over clicks. Click prompts only (prompt_mode 0).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..models.vpu import VPUConfig, VPUModel, vpu_forward
from ..nn import cast_params
from ..ops.edt import next_click_from_error
from ..ops.resize import roi_crop_resize, roi_paste_back


@dataclasses.dataclass(frozen=True)
class PredictorConfig:
    """Field names match the JAX PredictorConfig. `edt_impl` is read but not
    honoured: on CUDA the min-plus pass always runs the hand-written kernel.
    `edt_chunk` sizes the plain min-plus version's blocks; `edt_rows`
    selects the pass-1 form (bit-identical)."""
    model: VPUConfig
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
    """image (H, W, 3) uint8/float; gt_mask (H, W) with {0, 1, -1}."""
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


# ---------------------------------------------------------------------------
# ROI machinery (zoom_in.py:156-200, utils/misc.py:36-79)
# ---------------------------------------------------------------------------

def _first_true(v: torch.Tensor) -> torch.Tensor:
    return torch.argmax(v.to(torch.uint8))


def _bbox_from_mask(mask: torch.Tensor) -> torch.Tensor:
    h, w = mask.shape
    rows = mask.any(1)
    cols = mask.any(0)
    return torch.stack([_first_true(rows), h - 1 - _first_true(rows.flip(0)),
                        _first_true(cols), w - 1 - _first_true(cols.flip(0))])


def _expand_clamp_bbox(bbox: torch.Tensor, ratio: float, min_size: int,
                       img_h, img_w) -> torch.Tensor:
    rmin, rmax, cmin, cmax = bbox.float().unbind()
    rc = 0.5 * (rmin + rmax)
    cc = 0.5 * (cmin + cmax)
    height = (ratio * (rmax - rmin + 1)).clamp_min(float(min_size))
    width = (ratio * (cmax - cmin + 1)).clamp_min(float(min_size))
    # torch.round is round-half-to-even, like jnp.round
    out = torch.stack([torch.round(rc - 0.5 * height),
                       torch.round(rc + 0.5 * height),
                       torch.round(cc - 0.5 * width),
                       torch.round(cc + 0.5 * width)]).to(torch.int32)
    return torch.stack([out[0].clamp_min(0), torch.minimum(out[1], img_h - 1),
                        out[2].clamp_min(0), torch.minimum(out[3], img_w - 1)])


def _segments_iou(a0, a1, b0, b1):
    inter = (torch.minimum(a1, b1) - torch.maximum(a0, b0) + 1.0).clamp_min(0.0)
    union = (torch.maximum(a1, b1) - torch.minimum(a0, b0) + 1.0).clamp_min(1e-6)
    return inter / union


def _bbox_iou(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    b1, b2 = b1.float(), b2.float()
    return (_segments_iou(b1[0], b1[1], b2[0], b2[1])
            * _segments_iou(b1[2], b1[3], b2[2], b2[3]))


def _clicks_inside_roi(points: torch.Tensor, n: int, roi: torch.Tensor):
    """check_object_roi (zoom_in.py:192-200): all positive clicks inside."""
    pos = points[0, :n]
    y, x = pos[:, 0], pos[:, 1]
    inside = (y >= roi[0]) & (y < roi[1]) & (x >= roi[2]) & (x < roi[3])
    return torch.where(pos[:, 2] >= 0, inside, True).all()


def _update_roi(cfg: PredictorConfig, state: SessionState,
                points: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One ZoomIn.transform ROI decision (zoom_in.py:40-63)."""
    n = points.shape[1] // 2
    hc, wc = state.gt.shape
    pred = state.prev_probs[0, :, :, 0] > cfg.zoom_prob_thresh
    pred_any = pred.any() & (state.click_count > cfg.skip_clicks)

    # pred mask with the valid positive clicks stamped in; invalid clicks go
    # to a spare slot past the end, which is then dropped (mode="drop")
    pos = points[0, :n]
    yy = pos[:, 0].to(torch.int32).clamp(0, hc - 1)
    xx = pos[:, 1].to(torch.int32).clamp(0, wc - 1)
    flat = torch.where(pos[:, 2] >= 0, yy * wc + xx, hc * wc).long()
    stamped = torch.cat([pred.reshape(-1), pred.new_zeros(1)])
    stamped = stamped.index_fill(0, flat, True)[:-1].reshape(hc, wc)

    obj_roi = _expand_clamp_bbox(_bbox_from_mask(stamped), cfg.expansion_ratio,
                                 cfg.min_crop_size, state.img_h, state.img_w)
    zero = torch.zeros((), dtype=torch.int32, device=pred.device)
    full_roi = torch.stack([zero, state.img_h - 1, zero, state.img_w - 1])
    current = torch.where(pred_any, obj_roi, full_roi)
    update = ((~state.has_roi) | (~_clicks_inside_roi(points, n, state.roi))
              | (_bbox_iou(current, state.roi) < cfg.recompute_thresh_iou))
    roi = torch.where(update, current, state.roi)
    return roi, torch.ones((), dtype=torch.bool, device=pred.device)


# ---------------------------------------------------------------------------
# click step
# ---------------------------------------------------------------------------

def _transform_points(points: torch.Tensor, roi: torch.Tensor,
                      crop_hw: Tuple[int, int], with_flip: bool) -> torch.Tensor:
    """Canvas clicks -> zoomed coords (zoom_in.py:141-153), plus the flipped
    duplicate batch (flip.py:9-21). Invalid slots stay (-1, -1, -1)."""
    ch, cw = crop_hw
    rmin, rmax, cmin, cmax = roi.unbind()
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


def _forward_round(model: VPUModel, cfg: PredictorConfig, state: SessionState,
                   points: torch.Tensor, prev_probs: torch.Tensor):
    """ROI update + crop + net forward + paste-back, using `prev_probs`."""
    st = state._replace(prev_probs=prev_probs)
    roi, has_roi = _update_roi(cfg, st, points)
    th, tw = cfg.target_size
    net_in = torch.cat([state.image, prev_probs], -1)
    crop = roi_crop_resize(net_in, roi, th, tw)                 # (1, th, tw, 4)
    if cfg.with_flip:
        crop = torch.cat([crop, crop.flip(2)], 0)
    net_points = points
    if cfg.net_clicks_limit is not None:
        net_points = torch.where(points[..., 2:3] < cfg.net_clicks_limit,
                                 points, -1.0)
    pts = _transform_points(net_points, roi, (th, tw), cfg.with_flip)
    logits = vpu_forward(model, cfg.model, crop, pts)["instances"]
    if cfg.with_flip:
        logits = 0.5 * (logits[:1] + logits[1:].flip(2))
    probs = torch.sigmoid(logits.float())
    hc, wc = state.gt.shape
    return roi_paste_back(probs, roi, hc, wc), roi, has_roi


def click_step(model: VPUModel, cfg: PredictorConfig, state: SessionState):
    """One full interactive round. Returns (new_state, iou)."""
    if cfg.prompt_mode != 0:
        raise NotImplementedError("prompt_mode 1/2 (box / scribble) is not "
                                  "ported yet (ROADMAP Queue 1 item 9)")
    n = state.points.shape[1] // 2
    hc, wc = state.gt.shape

    # --- 1. oracle next click (clicker.py:21-69) ---
    pred = state.prev_probs[0, :, :, 0] > cfg.prob_thresh
    gt_pos = state.gt == 1
    not_ignore = state.gt != -1
    fn = gt_pos & ~pred & not_ignore
    fp = ~gt_pos & pred & not_ignore
    is_pos, cy, cx, _ = next_click_from_error(
        fn, fp, state.not_clicked, chunk=cfg.edt_chunk, rows=cfg.edt_rows)
    row = torch.stack([cy.float(), cx.float(), state.click_count.float()])
    slot = torch.where(is_pos, state.num_pos.clamp_max(n - 1),
                       n + state.num_neg.clamp_max(n - 1))
    points = state.points.clone()
    points[0].index_copy_(0, slot.long().view(1), row.view(1, 3))
    not_clicked = state.not_clicked.reshape(-1).index_fill(
        0, (cy * wc + cx).long().view(1), False).reshape(hc, wc)
    click_count = state.click_count + 1
    st = state._replace(points=points, not_clicked=not_clicked,
                        num_pos=state.num_pos + is_pos.int(),
                        num_neg=state.num_neg + (~is_pos).int(),
                        click_count=click_count)

    # --- 2. forward, with the optional CFR cascade (base.py:59-72) ---
    probs, roi, has_roi = _forward_round(model, cfg, st, points, st.prev_probs)
    if cfg.cascade_step > 1:
        active = click_count <= cfg.cascade_clicks
        for _ in range(cfg.cascade_step - 1):
            nxt = torch.where(active, _forward_round(model, cfg, st, points,
                                                     probs)[0], probs)
            if cfg.cascade_adaptive:
                diff = ((nxt > cfg.prob_thresh)
                        != (probs > cfg.prob_thresh)).sum()
                active = active & (diff > 20)
            probs = nxt
    st = st._replace(prev_probs=probs, roi=roi, has_roi=has_roi)

    # --- 3. IoU (inference/utils.py:80-87) ---
    pm = probs[0, :, :, 0] > cfg.prob_thresh
    inter = (pm & gt_pos & not_ignore).sum()
    union = ((pm | gt_pos) & not_ignore).sum()
    return st, inter.float() / union.float().clamp_min(1.0)


def click_scan(model: VPUModel, cfg: PredictorConfig, state: SessionState,
               num_clicks: int):
    """`num_clicks` rounds; returns (final state, ious (num_clicks,) tensor)."""
    ious = []
    for _ in range(num_clicks):
        state, iou = click_step(model, cfg, state)
        ious.append(iou)
    return state, torch.stack(ious)


# ---------------------------------------------------------------------------
# host-side driver
# ---------------------------------------------------------------------------

class Predictor:
    """Session driver: canvas bucketing and an undo stack (the reference
    controller's session surface, headless). The model is moved to `device`
    (default: where its parameters are) and cast once to the config's
    compute dtype."""

    def __init__(self, model: VPUModel, cfg: PredictorConfig, device=None):
        if cfg.prompt_mode != 0:
            raise NotImplementedError("prompt_mode 1/2 (box / scribble) is not "
                                      "ported yet (ROADMAP Queue 1 item 9)")
        self.device = torch.device(device) if device is not None else \
            next(model.parameters()).device
        # in place: the caller's module is moved and cast, not copied
        self.model = cast_params(model.to(self.device), cfg.model.dtype)
        self.cfg = cfg
        self.state: Optional[SessionState] = None
        self._undo: list = []

    def _canvas(self, h: int, w: int) -> Tuple[int, int]:
        b = self.cfg.canvas_bucket
        return (-(-h // b) * b, -(-w // b) * b)

    def set_input(self, image: np.ndarray, gt_mask: np.ndarray):
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
        self.state = init_session(image, gt_mask, self.cfg.model.num_max_points,
                                  self._canvas(*image.shape[:2]), self.device)
        self._undo = []

    @torch.no_grad()
    def next_click(self) -> float:
        """One oracle-driven round; returns IoU."""
        self._undo.append(self.state)
        self.state, iou = click_step(self.model, self.cfg, self.state)
        return float(iou)

    @torch.no_grad()
    def run_clicks(self, num_clicks: int) -> np.ndarray:
        """`num_clicks` rounds; returns the IoU curve (one host read)."""
        self._undo.append(self.state)
        self.state, ious = click_scan(self.model, self.cfg, self.state,
                                      num_clicks)
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
