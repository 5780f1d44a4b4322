"""Visualization helpers — qualitative panels for eval dumps and the
trainer's image dumps (a copy of pvpuformer_tpu/utils/vis.py: the same
pixels), plus `write_png`, a PNG encoder on zlib alone.

Numpy re-implementations of `isegm/utils/vis.py` (no cv2; PIL only inside
`annotate_iou_noc`, imported there):
  * draw_probmap (vis.py:61): colormap of a probability map;
  * draw_with_blend_and_clicks (vis.py:119): alpha-blend the mask color over
    the image + green/red click disks;
  * draw_with_blend_and_prompts (vis.py:246): same + box outlines / scribble
    polylines;
  * get_boundaries (vis.py:103): 3x3-ellipse-erosion instance boundaries;
  * visualize_instances (vis.py:8): palette + boundary overlay;
  * draw_heatmap (vis.py:353): hot-colormap blend;
  * error_map / draw_with_error (vis.py:213, evaluate_vpumodel.py:370-373):
    FN/FP error panels with prompt overlays;
  * annotate_iou_noc (evaluate_vpumodel.py:378-383): IoU/NoC text stamps;
  * visualize_mask / per-instance palette.
"""
from __future__ import annotations

import struct
import zlib
from functools import lru_cache
from pathlib import Path

import numpy as np


@lru_cache()
def _palette(n: int = 256) -> np.ndarray:
    """VOC-style color palette (deterministic per-instance colors)."""
    pal = np.zeros((n, 3), np.uint8)
    for i in range(n):
        c, j = i, 0
        while c:
            pal[i, 0] |= ((c >> 0) & 1) << (7 - j)
            pal[i, 1] |= ((c >> 1) & 1) << (7 - j)
            pal[i, 2] |= ((c >> 2) & 1) << (7 - j)
            c >>= 3
            j += 1
    return pal


def visualize_mask(mask: np.ndarray) -> np.ndarray:
    """Instance-id mask -> RGB via the palette."""
    return _palette()[np.clip(mask, 0, 255).astype(np.int32)]


def _hot(x: np.ndarray) -> np.ndarray:
    """COLORMAP_HOT ramp (black -> red -> yellow -> white), x in [0, 1] ->
    float RGB in [0, 255]. Piecewise-linear fit of cv2 5.0's LUT (cv2
    interpolates a 64-entry base table, which adds sub-1% kinks; this ramp
    stays within 9/255 of it everywhere — tests/test_vis.py)."""
    v = np.clip(x, 0.0, 1.0) * 255.0
    r = np.clip(v * 2.4917 + 0.24, 0, 255)
    g = np.clip((v - 101.81) * 2.4902, 0, 255)
    b = np.clip((v - 203.65) * 4.9665, 0, 255)
    return np.stack([r, g, b], axis=-1)


def draw_probmap(probs: np.ndarray) -> np.ndarray:
    """vis.py:61: probability map -> COLORMAP_HOT uint8 image (the
    reference's `cv2.applyColorMap(x*255, COLORMAP_HOT)`), so probability
    panels are visually comparable to the reference's eval dumps."""
    return np.round(_hot(np.asarray(probs, np.float32))).astype(np.uint8)


def _disk(h: int, w: int, cy: float, cx: float, radius: int) -> np.ndarray:
    yy, xx = np.mgrid[:h, :w]
    return (yy - cy) ** 2 + (xx - cx) ** 2 <= radius ** 2


def _line_pixels(x0: int, y0: int, x1: int, y1: int):
    """Thickness-1 8-connected line, pixel-exact vs cv2.line for the marker
    strokes below: step along the major axis; the minor coordinate rounds
    halves DOWN (cv2's LineIterator convention — verified against cv2 5.0
    in tests/test_vis.py)."""
    import math

    n = max(abs(x1 - x0), abs(y1 - y0))
    if n == 0:
        return [(x0, y0)]
    return [(math.ceil(x0 + k * (x1 - x0) / n - 0.5) if abs(x1 - x0) < n
             else x0 + k * (1 if x1 > x0 else -1),
             math.ceil(y0 + k * (y1 - y0) / n - 0.5) if abs(y1 - y0) < n
             else y0 + k * (1 if y1 > y0 else -1))
            for k in range(n + 1)]


def _marker_pixels(x: int, y: int, order: int, size: int = 4):
    """cv2.drawMarker stroke pixels for the reference's click-order coding
    (vis.py:70-78): order 0 cross, 1 diamond, 2 star, 3 triangle-up,
    >3 square; markerSize=4, thickness=1."""
    s = size // 2
    cross = [((x - s, y), (x + s, y)), ((x, y - s), (x, y + s))]
    tilted = [((x - s, y - s), (x + s, y + s)),
              ((x + s, y - s), (x - s, y + s))]
    diamond = [((x, y - s), (x + s, y)), ((x + s, y), (x, y + s)),
               ((x, y + s), (x - s, y)), ((x - s, y), (x, y - s))]
    triangle = [((x - s, y + s), (x + s, y + s)),
                ((x + s, y + s), (x, y - s)), ((x, y - s), (x - s, y + s))]
    square = [((x - s, y - s), (x + s, y - s)), ((x + s, y - s), (x + s, y + s)),
              ((x + s, y + s), (x - s, y + s)), ((x - s, y + s), (x - s, y - s))]
    lines = {0: cross, 1: diamond, 2: cross + tilted,
             3: triangle}.get(order, square)
    pts = set()
    for (ax, ay), (bx, by) in lines:
        pts.update(_line_pixels(ax, ay, bx, by))
    return pts


def draw_points(image: np.ndarray, points, color, radius: int = 3,
                marker_size: int = 4) -> np.ndarray:
    """vis.py:65-86 draw_points: (y, x) points -> filled disks; (y, x, order)
    points -> order-coded markers (cross/diamond/star/triangle per click
    index, square beyond), so one can read WHICH click came when off
    the panel, like the reference's training dumps (trainer.py:584-585)."""
    out = image.copy()
    h, w = out.shape[:2]
    for p in np.atleast_2d(np.asarray(points, np.float64)):
        if len(p) == 0 or p[0] < 0:
            continue
        if len(p) >= 3:
            for px, py in _marker_pixels(int(p[1]), int(p[0]), int(p[2]),
                                         marker_size):
                if 0 <= py < h and 0 <= px < w:
                    out[py, px] = color
        else:
            out[_disk(h, w, float(p[0]), float(p[1]), radius)] = color
    return out


def draw_with_blend_and_clicks(image: np.ndarray, mask=None, alpha: float = 0.6,
                               clicks_list=None, pos_color=(0, 255, 0),
                               neg_color=(255, 0, 0),
                               radius: int = 4,
                               order_markers: bool = False) -> np.ndarray:
    """vis.py:119: blend mask color over image + click disks.

    clicks_list: either reference-style objects with .is_positive/.coords or
    an (2N, 3) array of (y, x, order) with the first half positive.
    order_markers=True draws the reference trainer's order-coded markers
    (trainer.py:584 feeds (y, x, indx) rows to draw_points) instead of
    disks; requires order info (the 3-column array form)."""
    result = image.astype(np.float32).copy()
    h, w = result.shape[:2]
    if mask is not None:
        mask = np.asarray(mask)
        colors = visualize_mask(mask.astype(np.int32)).astype(np.float32)
        on = mask > 0
        result[on] = (1 - alpha) * result[on] + alpha * colors[on]

    if clicks_list is not None:
        entries = []
        arr = np.asarray(clicks_list) if not (
            len(clicks_list) and hasattr(clicks_list[0], "coords")) else None
        if arr is not None and arr.ndim == 2 and arr.shape[1] == 3:
            n = arr.shape[0] // 2
            for i, (y, x, order) in enumerate(arr):
                if order >= 0:
                    entries.append((i < n, y, x, order))
        else:
            for c in clicks_list:
                order = getattr(c, "indx", None)
                entries.append((c.is_positive, *c.coords,
                                -1 if order is None else order))
        result = np.clip(result, 0, 255).astype(np.uint8)
        for is_pos, y, x, order in entries:
            if y < 0 or x < 0:
                continue
            color = pos_color if is_pos else neg_color
            if order_markers and order >= 0:
                result = draw_points(result, [(y, x, order)], color)
            else:
                result[_disk(h, w, float(y), float(x), radius)] = color
        return result
    return np.clip(result, 0, 255).astype(np.uint8)


def draw_box(image: np.ndarray, box, color=(255, 255, 255),
             thickness: int = 3) -> np.ndarray:
    """Box outline; box = (x_center, y_center, width, height)."""
    out = image.copy()
    h, w = out.shape[:2]
    xc, yc, bw, bh = [int(v) for v in box[:4]]
    x0, x1 = xc - bw // 2, xc + bw // 2
    y0, y1 = yc - bh // 2, yc + bh // 2
    t = thickness // 2
    yy, xx = np.mgrid[:h, :w]
    outer = (xx >= x0 - t) & (xx <= x1 + t) & (yy >= y0 - t) & (yy <= y1 + t)
    inner = (xx >= x0 + t + 1) & (xx <= x1 - t - 1) & \
        (yy >= y0 + t + 1) & (yy <= y1 - t - 1)
    out[outer & ~inner] = color
    return out


def draw_scribble(image: np.ndarray, samples, color=(255, 255, 0),
                  thickness: int = 3) -> np.ndarray:
    """Polyline from dense (col, row) samples."""
    out = image.copy()
    h, w = out.shape[:2]
    cols = np.clip(np.asarray(samples)[:, 0].astype(int), 0, w - 1)
    rows = np.clip(np.asarray(samples)[:, 1].astype(int), 0, h - 1)
    stroke = np.zeros((h, w), bool)
    stroke[rows, cols] = True
    t = max(thickness // 2, 1)
    pad = np.pad(stroke, t)
    acc = np.zeros((h, w), bool)
    for dy in range(-t, t + 1):
        for dx in range(-t, t + 1):
            acc |= pad[t + dy:t + dy + h, t + dx:t + dx + w]
    out[acc] = color
    return out


def draw_with_blend_and_prompts(image: np.ndarray, mask=None, alpha=0.6,
                                clicks_list=None, boxes=None, scribbles=None,
                                radius: int = 4) -> np.ndarray:
    """vis.py:246: clicks + box outlines + scribble strokes."""
    out = draw_with_blend_and_clicks(image, mask=mask, alpha=alpha,
                                     clicks_list=clicks_list, radius=radius)
    if boxes is not None:
        for box in np.atleast_2d(np.asarray(boxes)):
            if np.any(box[:4]):
                out = draw_box(out, box)
    if scribbles is not None:
        scr = np.asarray(scribbles)
        if scr.ndim == 3:
            scr = scr[0]
        if np.any(scr):
            out = draw_scribble(out, scr)
    return out


# ---------------------------------------------------------------------------
# boundary / instance / heatmap helpers (vis.py:8-23, 103-116, 353-361)
# ---------------------------------------------------------------------------

# cv2.getStructuringElement(MORPH_ELLIPSE, (3, 3)) — the plus-shaped kernel
# the reference erodes with (vis.py:111)
_ELLIPSE3 = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], bool)


def _erode(mask: np.ndarray, iterations: int = 1) -> np.ndarray:
    """Binary erosion with the 3x3 ellipse kernel (= cv2.erode semantics:
    out-of-image neighbours count as foreground, so borders survive when the
    in-image neighbourhood does)."""
    out = mask.astype(bool)
    h, w = out.shape
    for _ in range(iterations):
        pad = np.pad(out, 1, constant_values=True)
        acc = np.ones((h, w), bool)
        for dy, dx in ((-1, 0), (0, -1), (0, 0), (0, 1), (1, 0)):
            acc &= pad[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
        out = acc
    return out


def get_boundaries(instances_masks: np.ndarray,
                   boundaries_width: int = 1) -> np.ndarray:
    """vis.py:103-116: per-instance boundary pixels — each object minus its
    `boundaries_width`-step erosion, OR-ed over objects."""
    boundaries = np.zeros(instances_masks.shape[:2], bool)
    for obj_id in np.unique(instances_masks):
        if obj_id == 0:
            continue
        obj = instances_masks == obj_id
        inner = _erode(obj, iterations=boundaries_width)
        boundaries |= obj ^ (inner & obj)
    return boundaries


def visualize_instances(imask: np.ndarray, bg_color=255,
                        boundaries_color=None, boundaries_width: int = 1,
                        boundaries_alpha: float = 0.8) -> np.ndarray:
    """vis.py:8-23: palette-colored instance map, optionally with alpha-
    blended boundary strokes."""
    result = _palette()[np.clip(imask, 0, 255).astype(np.int32)].copy()
    if bg_color is not None:
        result[imask == 0] = bg_color
    if boundaries_color is not None:
        b = get_boundaries(imask, boundaries_width)
        t = result.astype(np.float32)
        t[b] = boundaries_color
        result = (t * boundaries_alpha
                  + (1 - boundaries_alpha) * result).astype(np.uint8)
    return result.astype(np.uint8)


def draw_heatmap(img: np.ndarray, mask=None, alpha: float = 0.5) -> np.ndarray:
    """vis.py:353-361: hot-colormap of the (binary) mask blended additively
    over the image."""
    result = img.copy()
    if mask is not None:
        x = mask.astype(np.float32)
        heat = _hot(x / max(x.max(), 1e-6))
        result = np.clip(heat * alpha + img, 0, 255).astype(np.uint8)
    return result


# ---------------------------------------------------------------------------
# error maps + text annotation (vis.py:213-244, evaluate_vpumodel.py:360-427)
# ---------------------------------------------------------------------------

def error_map(gt_mask: np.ndarray, pred_mask: np.ndarray,
              fn_color=(255, 0, 0), fp_color=(0, 0, 255)) -> np.ndarray:
    """evaluate_vpumodel.py:370-373: under-segmentation (FN) red,
    over-segmentation (FP) blue, black elsewhere."""
    out = np.zeros((*gt_mask.shape, 3), np.uint8)
    out[(gt_mask > 0) & ~pred_mask] = fn_color
    out[(gt_mask < 1) & pred_mask] = fp_color
    return out


def draw_with_error(gt_mask: np.ndarray, pred_mask: np.ndarray,
                    clicks_list=None, boxes=None, scribbles=None,
                    prompt_type: int = 0, radius: int = 4) -> np.ndarray:
    """vis.py:213-244 draw_with_error: the FN/FP error map with the prompt
    of the round drawn on top (clicks for type 0, box outline for 1,
    scribble stroke for 2)."""
    out = error_map(gt_mask, pred_mask)
    if prompt_type == 0 and clicks_list is not None:
        out = draw_with_blend_and_clicks(out, clicks_list=clicks_list,
                                         radius=radius)
    elif prompt_type == 1 and boxes is not None:
        for box in np.atleast_2d(np.asarray(boxes)):
            if np.any(box[:4]):
                out = draw_box(out, box, color=(192, 0, 0))   # vis.py:307
    elif prompt_type == 2 and scribbles is not None:
        scr = np.asarray(scribbles)
        if scr.ndim == 3:
            scr = scr[0]
        if np.any(scr):
            out = draw_scribble(out, scr, color=(192, 0, 0))  # vis.py:319
    return out


def annotate_iou_noc(image: np.ndarray, iou: float, noc: int,
                     color=(255, 255, 255)) -> np.ndarray:
    """evaluate_vpumodel.py:378-383: stamp 'NoC=k' / 'IoU=p%' onto the
    panel (PIL text in place of cv2.putText)."""
    from PIL import Image, ImageDraw
    img = Image.fromarray(np.ascontiguousarray(image))
    d = ImageDraw.Draw(img)
    d.text((2, 8), f"NoC={noc}", fill=tuple(color))
    d.text((2, 28), f"IoU={iou * 100:.2f}%", fill=tuple(color))
    return np.asarray(img)


def eval_panel(image: np.ndarray, gt_mask: np.ndarray, probs: np.ndarray,
               iou: float, click_indx: int, clicks_list=None, boxes=None,
               scribbles=None, prompt_type: int = 0,
               prob_thresh: float = 0.49) -> np.ndarray:
    """One click's 2x3 qualitative panel row, matching the reference's
    eval dump layout (evaluate_vpumodel.py:360-427):
      [gt blend (strong) | gt blend (light) | pred blend + prompts]
      [error map + prompts | prob map | pred mask + IoU/NoC text]
    """
    pred_mask = probs > prob_thresh

    def blend(mask, alpha):
        return draw_with_blend_and_prompts(
            image, mask=mask.astype(np.int32), alpha=alpha,
            clicks_list=clicks_list if prompt_type == 0 else None,
            boxes=boxes if prompt_type == 1 else None,
            scribbles=scribbles if prompt_type == 2 else None)

    gt_strong = blend(gt_mask > 0, 0.7)
    gt_light = blend(gt_mask > 0, 0.5)
    pred_blend = blend(pred_mask, 0.6)
    err = draw_with_error(gt_mask, pred_mask, clicks_list=clicks_list,
                          boxes=boxes, scribbles=scribbles,
                          prompt_type=prompt_type)
    prob_map = draw_probmap(probs)
    pm = (np.repeat(pred_mask[..., None], 3, axis=2) * 255).astype(np.uint8)
    pm = annotate_iou_noc(pm, iou, click_indx + 1)

    row1 = np.concatenate([gt_strong, gt_light, pred_blend], axis=1)
    row2 = np.concatenate([err, prob_map, pm], axis=1)
    return np.concatenate([row1, row2], axis=0)


def write_png(path, image: np.ndarray) -> None:
    """Write a uint8 (H, W, 3) RGB or (H, W) grey image as an 8-bit PNG
    (no interlace, filter 0 on every row), with zlib and crc32 alone."""
    img = np.ascontiguousarray(image, dtype=np.uint8)
    if img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"write_png takes (H, W) or (H, W, 3), got "
                         f"{img.shape}")
    h, w = img.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, -1)],
                          axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2 if img.ndim == 3 else 0, 0, 0, 0)
    Path(path).write_bytes(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                           + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                           + chunk(b"IEND", b""))
