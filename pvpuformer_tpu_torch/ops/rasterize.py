"""Box and scribble prompts drawn into the coordinate-feature channels, on the
device (pvpuformer_tpu/ops/rasterize.py), batched over the leading axis.

  * box outline: cv2.rectangle(thickness=3) is 5 px wide on axis-aligned
    lines with round caps clipping the outer corners to a radius-2 disk;
  * scribble: the curve arrives as dense samples; its thickness-3 stroke is
    the dilation of the scattered samples by the radius-2 disk, an OR of 13
    static shifts.

Drawn pixels OR into the disk channels (the reference converts through
uint8 * 255 and back, a logical OR with the 0/1 disks). The 0/1 mask is
cast to the coord dtype first, so a bf16 forward stays bf16.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def box_outline_mask(h: int, w: int, boxes: torch.Tensor) -> torch.Tensor:
    """boxes (B, 4) of (x_center, y_center, width, height) -> (B, h, w) 0/1
    f32, cv2.rectangle((x0, y0), (x1, y1), thickness=3) with
    x0 = xc - w // 2 etc. (is_model.py:107-109)."""
    xc, yc, bw, bh = boxes.to(torch.int32).unbind(-1)
    x0, x1 = xc - bw // 2, xc + bw // 2
    y0, y1 = yc - bh // 2, yc + bh // 2
    yy = torch.arange(h, dtype=torch.int32, device=boxes.device)[None, :, None]
    xx = torch.arange(w, dtype=torch.int32, device=boxes.device)[None, None, :]
    x0, x1, y0, y1 = (v[:, None, None] for v in (x0, x1, y0, y1))
    ex = torch.maximum(x0 - xx, xx - x1).clamp_min(0)
    ey = torch.maximum(y0 - yy, yy - y1).clamp_min(0)
    outer = (ex * ex + ey * ey) <= 4
    inner = (xx >= x0 + 3) & (xx <= x1 - 3) & (yy >= y0 + 3) & (yy <= y1 - 3)
    return (outer & ~inner).float()


def polyline_mask(h: int, w: int, samples: torch.Tensor) -> torch.Tensor:
    """samples (B, S, 2) of (col, row) dense curve samples -> (B, h, w) 0/1
    f32 mask of a thickness-3 cv2 stroke: the scattered samples dilated by
    the radius-2 disk (13 shifts, bit-identical to a conv > 0)."""
    b = samples.shape[0]
    cols = samples[..., 0].to(torch.int32).clamp(0, w - 1)
    rows = samples[..., 1].to(torch.int32).clamp(0, h - 1)
    base = torch.zeros(b, h * w, dtype=torch.uint8, device=samples.device)
    base.scatter_(1, (rows * w + cols).long(), 1)
    base = base.view(b, h, w)
    pad = F.pad(base, (2, 2, 2, 2))
    acc = base
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            if dy * dy + dx * dx <= 4 and (dy, dx) != (0, 0):
                acc = acc | pad[:, 2 + dy:2 + dy + h, 2 + dx:2 + dx + w]
    return acc.float()


def draw_box_into_coords(coords: torch.Tensor, boxes: torch.Tensor,
                         num_points: int) -> torch.Tensor:
    """coords (B, H, W, 2) pos/neg disk channels; boxes (B, 5) whose last
    entry is the slot (< num_points: positive channel). ISModel.draw_box
    (is_model.py:97-121)."""
    _, h, w, _ = coords.shape
    boxes = boxes.float()
    mask = box_outline_mask(h, w, boxes[:, :4])
    neg = boxes[:, 4] >= num_points                           # channel 1
    sel = torch.stack([~neg, neg], -1).to(coords.dtype)[:, None, None, :]
    drawn = torch.maximum(coords, mask[..., None].to(coords.dtype))
    return coords * (1 - sel) + drawn * sel


def draw_scribble_into_coords(coords: torch.Tensor,
                              scribbles: torch.Tensor) -> torch.Tensor:
    """scribbles (B, S, 2) of (col, row) samples, drawn into the positive
    channel (is_model.py:123-146 always writes channel 0)."""
    _, h, w, _ = coords.shape
    mask = polyline_mask(h, w, scribbles.float())
    pos = torch.maximum(coords[..., 0], mask.to(coords.dtype))
    return torch.stack([pos, coords[..., 1]], -1)
