"""Plain reference of one interactive click round of a batch of sessions,
teacher-forced from the program's own state before the round.

A round (the NoC protocol of RITM / SimpleClick / PVPUFormer with zoom-in
and flip TTA):
  1. the oracle click: the exact squared Euclidean distance transform of
     the false-negative and false-positive masks (a virtual zero ring
     outside the canvas, clicked pixels excluded); the click goes to the
     larger region's farthest pixel, the first maximum in row-major order,
     positive iff that region is the false negatives;
  2. the zoom-in ROI: the bounding box of the previous mask (> 0.5) with
     the positive clicks, expanded 1.4x to at least 200 pixels and clamped,
     taken when there was none, when a positive click lies outside the
     current one, or when its box IoU with the current one is below 0.5;
  3. crop of image and previous mask to the ROI, resized (align corners)
     to the model's crop, clicks mapped into it, a flipped copy beside it;
  4. the model (reference/vpu.py), the two logit maps averaged back,
     sigmoid, pasted back into the canvas (bilinear, align corners);
  5. IoU of probs > 0.49 against the ground truth (ignore label -1).
The session layout is the program's `SessionState`, as a dict of tensors;
nothing of the program is imported.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from . import vpu

PROB_THRESH = 0.49
ZOOM_THRESH = 0.50
EXPANSION = 1.4
MIN_CROP = 200
RECOMPUTE_IOU = 0.5

State = Dict[str, torch.Tensor]


# ------------------------------------------------------------------- EDT

def _col_dist2(masks: torch.Tensor) -> torch.Tensor:
    """(B, H, W) bool -> squared distance along each column to the nearest
    zero, with zero rows at -1 and H."""
    h = masks.shape[1]
    rows = torch.arange(h, device=masks.device).view(1, h, 1)
    zero_at = torch.where(masks, -h - 1, rows).clamp_min(-1)
    above = torch.cummax(zero_at, dim=1).values
    zero_dn = torch.where(masks, 2 * h + 1, rows).clamp_max(h)
    below = torch.cummin(zero_dn.flip(1), dim=1).values.flip(1)
    return torch.minimum(rows - above, below - rows).float().square()


def squared_edt(masks: torch.Tensor, chunk: int = 16) -> torch.Tensor:
    """Exact squared EDT of (B, H, W) bool masks: distance to the nearest
    zero, with a virtual zero ring just outside. The row pass is the brute
    min over every column, `chunk` output columns at a time."""
    b, h, w = masks.shape
    f = _col_dist2(masks).reshape(b * h, w)
    cols = torch.arange(w, dtype=torch.float32, device=masks.device)
    out = torch.empty_like(f)
    for c0 in range(0, w, chunk):
        off = (cols[c0:c0 + chunk, None] - cols[None, :]).square()
        out[:, c0:c0 + chunk] = (f[:, None, :] + off).amin(-1)
    border = torch.minimum((cols + 1.0).square(), (w - cols).square())
    out = torch.minimum(out.reshape(b, h, w), border)
    return torch.where(masks, out, 0.0)


def oracle_click(state: State) -> Tuple[torch.Tensor, ...]:
    """(is_pos, y, x) per session of the batch."""
    pred = state["prev_probs"][..., 0] > PROB_THRESH
    gt = state["gt"]
    gt_pos, keep = gt == 1, gt != -1
    fn = gt_pos & ~pred & keep
    fp = ~gt_pos & pred & keep
    b, h, w = fn.shape
    d = squared_edt(torch.cat([fn, fp])) * state["not_clicked"].repeat(
        2, 1, 1)
    d_fn, d_fp = d[:b], d[b:]
    is_pos = d_fn.amax((1, 2)) > d_fp.amax((1, 2))
    d = torch.where(is_pos[:, None, None], d_fn, d_fp)
    flat = torch.argmax(d.reshape(b, -1), -1)
    return is_pos, (flat // w).int(), (flat % w).int()


def put_click(state: State, is_pos, cy, cx) -> State:
    """The click into its slot (past the limit: the sign's last slot),
    order = the click count; the pixel marked clicked."""
    points = state["points"].clone()
    b, twon, _ = points.shape
    n = twon // 2
    slot = torch.where(is_pos, state["num_pos"].clamp_max(n - 1),
                       n + state["num_neg"].clamp_max(n - 1)).long()
    idx = torch.arange(b, device=points.device)
    points[idx, slot] = torch.stack(
        [cy.float(), cx.float(), state["click_count"].float()], -1)
    not_clicked = state["not_clicked"].clone()
    not_clicked[idx, cy.long(), cx.long()] = False
    out = dict(state)
    out.update(points=points, not_clicked=not_clicked,
               num_pos=state["num_pos"] + is_pos.int(),
               num_neg=state["num_neg"] + (~is_pos).int(),
               click_count=state["click_count"] + 1)
    return out


# ------------------------------------------------------------------- ROI

def _first(v: torch.Tensor) -> torch.Tensor:
    return torch.argmax(v.to(torch.uint8), -1)


def _bbox(mask: torch.Tensor):
    """(B, H, W) bool -> (y0, y1, x0, x1); an empty mask gives the whole
    canvas."""
    h, w = mask.shape[-2:]
    rows, cols = mask.any(-1), mask.any(-2)
    return (_first(rows), h - 1 - _first(rows.flip(-1)), _first(cols),
            w - 1 - _first(cols.flip(-1)))


def _expand(box, img_h, img_w) -> torch.Tensor:
    rmin, rmax, cmin, cmax = (v.float() for v in box)
    rc, cc = 0.5 * (rmin + rmax), 0.5 * (cmin + cmax)
    hh = (EXPANSION * (rmax - rmin + 1)).clamp_min(float(MIN_CROP))
    ww = (EXPANSION * (cmax - cmin + 1)).clamp_min(float(MIN_CROP))
    r0 = torch.round(rc - 0.5 * hh).int().clamp_min(0)
    r1 = torch.minimum(torch.round(rc + 0.5 * hh).int(), img_h - 1)
    c0 = torch.round(cc - 0.5 * ww).int().clamp_min(0)
    c1 = torch.minimum(torch.round(cc + 0.5 * ww).int(), img_w - 1)
    return torch.stack([r0, r1, c0, c1], -1)


def _span_iou(a0, a1, b0, b1):
    inter = (torch.minimum(a1, b1) - torch.maximum(a0, b0) + 1.0).clamp_min(0)
    union = (torch.maximum(a1, b1) - torch.minimum(a0, b0) + 1.0
             ).clamp_min(1e-6)
    return inter / union


def update_roi(state: State) -> torch.Tensor:
    """The round's ROI (B, 4) int32 (rmin, rmax, cmin, cmax), inclusive,
    from the previous mask and the clicks (the new one included)."""
    points, roi = state["points"], state["roi"]
    b, twon, _ = points.shape
    n = twon // 2
    hc, wc = state["gt"].shape[-2:]
    pred = state["prev_probs"][..., 0] > ZOOM_THRESH
    pred_any = pred.flatten(1).any(1)
    pos = points[:, :n]
    valid = pos[..., 2] >= 0
    stamped = pred.clone()
    for i in range(b):
        yy = pos[i, valid[i], 0].int().clamp(0, hc - 1).long()
        xx = pos[i, valid[i], 1].int().clamp(0, wc - 1).long()
        stamped[i, yy, xx] = True
    obj = _expand(_bbox(stamped), state["img_h"], state["img_w"])
    zero = torch.zeros_like(state["img_h"])
    full = torch.stack([zero, state["img_h"] - 1, zero, state["img_w"] - 1],
                       -1)
    current = torch.where(pred_any[:, None], obj, full)
    y, x = pos[..., 0], pos[..., 1]
    inside = ((y >= roi[:, 0:1]) & (y < roi[:, 1:2])
              & (x >= roi[:, 2:3]) & (x < roi[:, 3:4]))
    inside = torch.where(valid, inside, True).all(-1)
    c, r = current.float(), roi.float()
    box_iou = (_span_iou(c[:, 0], c[:, 1], r[:, 0], r[:, 1])
               * _span_iou(c[:, 2], c[:, 3], r[:, 2], r[:, 3]))
    update = (~state["has_roi"]) | (~inside) | (box_iou < RECOMPUTE_IOU)
    return torch.where(update[:, None], current, roi)


# ------------------------------------------------------- crop and paste

def _sample_axis(length: int, n_out: int, lo, hi):
    i = torch.arange(n_out, dtype=torch.float32, device=lo.device)
    x = lo.float()[:, None] + i * (hi - lo).float()[:, None] / float(n_out - 1)
    x = x.clamp(0.0, float(length - 1))
    x0 = x.floor().long()
    return x0, (x0 + 1).clamp_max(length - 1), x - x0.float()


def _bilinear_at(f: torch.Tensor, y0, y1, wy, x0, x1, wx) -> torch.Tensor:
    """f (B, H, W, C) at each item's rows (B, h) and columns (B, w): rows
    first, then columns."""
    item = torch.arange(f.shape[0], device=f.device)
    rows = (f[item[:, None], y0] * (1.0 - wy)[..., None, None]
            + f[item[:, None], y1] * wy[..., None, None])
    i3 = item[:, None, None]
    r3 = torch.arange(rows.shape[1], device=f.device)[None, :, None]
    wx = wx[:, None, :, None]
    return (rows[i3, r3, x0[:, None, :]] * (1.0 - wx)
            + rows[i3, r3, x1[:, None, :]] * wx)


def crop(img: torch.Tensor, roi: torch.Tensor, out_h: int, out_w: int):
    """img (B, H, W, C) cropped to each ROI and resized (align corners)."""
    h, w = img.shape[1:3]
    rmin, rmax, cmin, cmax = roi.unbind(-1)
    return _bilinear_at(img, *_sample_axis(h, out_h, rmin, rmax),
                        *_sample_axis(w, out_w, cmin, cmax))


def paste(probs: torch.Tensor, roi: torch.Tensor, hc: int, wc: int):
    """probs (B, h, w, C) resized onto each ROI of a zero (hc, wc) canvas."""
    b, h, w, _ = probs.shape
    dev = probs.device
    rmin, rmax, cmin, cmax = (v[:, None] for v in roi.float().unbind(-1))
    r = torch.arange(hc, dtype=torch.float32, device=dev)
    c = torch.arange(wc, dtype=torch.float32, device=dev)
    rh, rw = rmax - rmin, cmax - cmin
    sy = torch.where(rh < 1.0, 0.0, (r - rmin) * (h - 1) / rh.clamp_min(1.0))
    sx = torch.where(rw < 1.0, 0.0, (c - cmin) * (w - 1) / rw.clamp_min(1.0))
    inside = (((r >= rmin) & (r <= rmax))[:, :, None]
              & ((c >= cmin) & (c <= cmax))[:, None, :])
    sy, sx = sy.clamp(0.0, h - 1), sx.clamp(0.0, w - 1)
    y0, x0 = sy.floor().long(), sx.floor().long()
    out = _bilinear_at(probs, y0, (y0 + 1).clamp_max(h - 1), sy - y0.float(),
                       x0, (x0 + 1).clamp_max(w - 1), sx - x0.float())
    return torch.where(inside[..., None], out, 0.0)


def crop_points(points: torch.Tensor, roi: torch.Tensor, ch: int, cw: int):
    """Canvas clicks -> crop coordinates, then the horizontally flipped
    copy after them: (2B, 2N, 3)."""
    rmin, rmax, cmin, cmax = (v[:, None] for v in roi.unbind(-1))
    y, x, order = points.unbind(-1)
    valid = order >= 0
    ny = ch * (y - rmin) / (rmax - rmin + 1).float()
    nx = cw * (x - cmin) / (cmax - cmin + 1).float()
    t = torch.stack([torch.where(valid, ny, -1.0),
                     torch.where(valid, nx, -1.0), order], -1)
    tf = torch.stack([t[..., 0], torch.where(valid, cw - t[..., 1] - 1, -1.0),
                      order], -1)
    return torch.cat([t, tf], 0)


def iou(gt: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
    gt_pos, keep = gt == 1, gt != -1
    pm = probs[..., 0] > PROB_THRESH
    inter = (pm & gt_pos & keep).flatten(1).sum(1)
    union = ((pm | gt_pos) & keep).flatten(1).sum(1)
    return inter.float() / union.float().clamp_min(1.0)


# ----------------------------------------------------------------- round

@torch.no_grad()
def click_round(P: vpu.Params, cfg: dict, before: State) -> State:
    """One round from the state `before`: returns the state after it
    (points, not_clicked, counters, roi, has_roi, prev_probs) and "iou"."""
    st = put_click(before, *oracle_click(before))
    st["roi"] = update_roi(st)
    st["has_roi"] = torch.ones_like(st["has_roi"])
    st.update(forward_round(P, cfg, st))
    return st


def forward_round(P: vpu.Params, cfg: dict, st: State,
                  reverse: bool = False) -> State:
    """Crop, flip, model, flip back, sigmoid and paste for the ROI and
    clicks in `st`: {"prev_probs", "logits" (B, crop, crop, 1)}."""
    ch, cw = cfg["backbone"]["img_size"]
    b = st["points"].shape[0]
    net_in = torch.cat([st["image"], st["prev_probs"]], -1)
    x = crop(net_in, st["roi"], ch, cw)
    x = torch.cat([x, x.flip(2)], 0)
    pts = crop_points(st["points"], st["roi"], ch, cw)
    logits = vpu.forward(P, cfg, x, pts, reverse)
    logits = 0.5 * vpu.Num(cfg["dtype"]).r(logits[:b] + logits[b:].flip(2))
    hc, wc = st["gt"].shape[-2:]
    return {"prev_probs": paste(torch.sigmoid(logits), st["roi"], hc, wc),
            "logits": logits}
