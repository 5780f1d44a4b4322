"""PPuE prompt encoding (pvpuformer_tpu/ops/ppue.py): clicks, boxes and
scribbles.

Each click (y, x, order) becomes a pair of 1-D Gaussian profiles plus a
3-bit type label: the FIRST profile (length W) is indexed by the ROW
coordinate, as in the reference. A box (x_c, y_c, w, h, slot) puts the
COLUMN profile first (is_vpu_model.py:266-273); a scribble row encodes the
curve's distance from the rect's min edges. Rows labelled -1 become the
not-a-point vector [0 ... 0, 0, 0, 1]. The box and scribble rows replace one
click row BEFORE the num_max_points padding (their slots index the
unpadded 2N layout).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class PPuEConfig:
    input_h: int = 448
    input_w: int = 448
    sigma: float = 3.0
    heighten_peak: bool = True
    upsampling_scale: int = 4
    input_over_output_stride: int = 4

    @property
    def output_h(self) -> int:
        return int(self.input_h * self.upsampling_scale
                   / self.input_over_output_stride)

    @property
    def output_w(self) -> int:
        return int(self.input_w * self.upsampling_scale
                   / self.input_over_output_stride)

    @property
    def vec_dim(self) -> int:
        return self.output_w + self.output_h + 3


def _not_a_point(cfg: PPuEConfig, device) -> torch.Tensor:
    """[0 ... 0, 0, 0, 1], built on the device (an item assignment would
    copy a host scalar: a host sync inside every click)."""
    return (torch.arange(cfg.vec_dim, device=device)
            == cfg.vec_dim - 1).float()


def _in_img(p0, p1, w: int, h: int):
    return (p0 >= 0) & (p0 <= w) & (p1 >= 0) & (p1 <= h)


def _gauss_profile(length: int, center: torch.Tensor, sigma, radius,
                   heighten: bool) -> torch.Tensor:
    """(...,) int centres -> (..., length) exp(-d^2 / 2 sigma^2), |d| <= radius.
    `sigma` and `radius` are Python numbers or (...,) tensors."""
    idx = torch.arange(length, dtype=torch.float32, device=center.device)
    d = idx - center.float()[..., None]
    if torch.is_tensor(sigma):
        g = torch.exp(-(d * d) / (2.0 * sigma.float().square())[..., None])
        g = torch.where(d.abs() <= radius.float()[..., None], g, 0.0)
    else:
        g = torch.exp(-(d * d) / (2.0 * sigma * sigma))
        g = torch.where(d.abs() <= radius, g, 0.0)
    if heighten:
        g = g + (d == 0).float()
    return g


def ppue_click(points: torch.Tensor, cfg: PPuEConfig = PPuEConfig(),
               num_max_points: Optional[int] = None) -> torch.Tensor:
    """(B, 2N, 3) points -> (B, 2*num_max_points, W+H+3) prompt queries."""
    b, twon, _ = points.shape
    n = twon // 2
    nmax = num_max_points or n
    pts = points.float()
    scale = cfg.upsampling_scale / cfg.input_over_output_stride
    a = torch.trunc(pts[..., 0] * scale).to(torch.int32)
    c = torch.trunc(pts[..., 1] * scale).to(torch.int32)
    radius = int(cfg.sigma * 3)
    valid = (_in_img(a - radius, c - radius, cfg.output_w, cfg.output_h)
             | _in_img(a + radius + 1, c + radius + 1, cfg.output_w,
                       cfg.output_h)).float()[..., None]
    v0 = _gauss_profile(cfg.output_w, a, cfg.sigma, radius,
                        cfg.heighten_peak) * valid
    v1 = _gauss_profile(cfg.output_h, c, cfg.sigma, radius,
                        cfg.heighten_peak) * valid
    is_pos = (torch.arange(twon, device=points.device) < n).float()
    type_lbl = torch.stack([is_pos, 1.0 - is_pos, torch.zeros_like(is_pos)],
                           -1).expand(b, twon, 3)
    vec = torch.cat([v0, v1, type_lbl], -1)
    vec = torch.where((pts[..., 2] == -1)[..., None],
                      _not_a_point(cfg, points.device), vec)
    return _pad_slots(vec, cfg, n, nmax)


def _pad_slots(vec: torch.Tensor, cfg: PPuEConfig, n: int,
               nmax: int) -> torch.Tensor:
    """(B, 2N, D) -> (B, 2*nmax, D): not-a-point rows after each half."""
    if nmax == n:
        return vec
    pad = _not_a_point(cfg, vec.device).expand(vec.shape[0], nmax - n,
                                               cfg.vec_dim)
    return torch.cat([vec[:, :n], pad, vec[:, n:], pad], 1)


def _replace_row(vec: torch.Tensor, slot: torch.Tensor,
                 row: torch.Tensor) -> torch.Tensor:
    """vec[b, slot[b]] = row[b]; a slot outside [0, 2N) replaces nothing
    (jax.nn.one_hot gives a zero row there)."""
    onehot = (torch.arange(vec.shape[1], device=vec.device)
              == slot[:, None]).to(vec.dtype)[..., None]
    return vec * (1.0 - onehot) + row[:, None, :] * onehot


def _box_vec(cfg: PPuEConfig, boxes: torch.Tensor) -> torch.Tensor:
    """(B, 5) f32 boxes (x_c, y_c, w, h, slot) -> (B, W+H) profile pairs
    (GaussianVector_box.gen_guassian_vector, ops.py:138-202): the FIRST
    profile is the column profile; kernel (side // 2 * 2 - 1) taps, sigma =
    radius // 3 (integer), zero when sigma == 0 or the box is all zero."""
    xc, yc, bw, bh = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    nonnull = (xc + yc + bw + bh) != 0
    kw = (bw.to(torch.int32) // 2) * 2 - 1
    radius_w = (kw - 1) // 2
    sigma_w = radius_w // 3
    kh = (bh.to(torch.int32) // 2) * 2 - 1
    radius_h = (kh - 1) // 2
    sigma_h = radius_h // 3
    ok = nonnull & (sigma_w > 0) & (sigma_h > 0)
    scale = cfg.upsampling_scale / cfg.input_over_output_stride
    cx = torch.trunc(xc * scale).to(torch.int32)
    cy = torch.trunc(yc * scale).to(torch.int32)
    valid = (_in_img(cx - radius_w, cy - radius_h, cfg.output_w, cfg.output_h)
             | _in_img(cx + radius_w + 1, cy + radius_h + 1, cfg.output_w,
                       cfg.output_h))
    okf = (ok & valid).float()[:, None]
    v0 = _gauss_profile(cfg.output_w, cx, sigma_w.clamp_min(1), radius_w,
                        False)
    v1 = _gauss_profile(cfg.output_h, cy, sigma_h.clamp_min(1), radius_h,
                        False)
    return torch.cat([v0 * okf, v1 * okf], -1)


def ppue_box(points: torch.Tensor, boxes: torch.Tensor,
             cfg: PPuEConfig = PPuEConfig(),
             num_max_points: Optional[int] = None) -> torch.Tensor:
    """Click encoding with row `boxes[:, 4]` replaced by the box vector
    (`_guassinvector_box`, is_vpu_model.py:233-291): type [1, 0, 0] if the
    slot is < N else [0, 1, 0]."""
    n = points.shape[1] // 2
    vec = ppue_click(points, cfg, num_max_points=None)     # (B, 2N, D)
    boxes = boxes.float()
    slot = boxes[:, 4].to(torch.int32)
    pos = (slot < n).float()[:, None]
    lbl = torch.cat([pos, 1.0 - pos, torch.zeros_like(pos)], -1)
    row = torch.cat([_box_vec(cfg, boxes), lbl], -1)
    vec = _replace_row(vec, slot, row)
    return _pad_slots(vec, cfg, n, num_max_points or n)


def _scribble_vec(cfg: PPuEConfig, scribbles: torch.Tensor,
                  rects: torch.Tensor) -> torch.Tensor:
    """(B, S, 2) samples of (col, row) + rects (col_c, row_c, col_ext,
    row_ext) -> (B, W+H): per axis bucket exp(-d_edge^2 / 2 sigma^2), d_edge
    the curve's distance from the rect's min edge on the other axis. Where
    several samples fall in one bucket the last one wins, as XLA's scatter
    applies its updates in order; here that is a deterministic max over
    sample indices, the same on every device."""
    xc, yc, bw, bh = rects.unbind(-1)
    nonnull = (scribbles.sum((1, 2)) + rects.sum(-1)) != 0
    row_top = (yc - bh // 2)[:, None]
    col_left = (xc - bw // 2)[:, None]
    sigma2 = 2.0 * cfg.sigma * cfg.sigma
    cols = torch.trunc(scribbles[..., 0]).to(torch.int32)
    rows = torch.trunc(scribbles[..., 1]).to(torch.int32)
    qx = torch.exp(-(rows.float() - row_top).square() / sigma2)
    qy = torch.exp(-(cols.float() - col_left).square() / sigma2)

    def last_set(length, idx, vals):
        b, s = idx.shape
        order = torch.arange(s, device=idx.device).expand(b, s)
        last = torch.full((b, length), -1, dtype=torch.long,
                          device=idx.device)
        last.scatter_reduce_(1, idx.clamp(0, length - 1).long(), order,
                             "amax")
        return torch.where(last >= 0, vals.gather(1, last.clamp_min(0)), 0.0)

    okf = nonnull.float()[:, None]
    return torch.cat([last_set(cfg.output_w, cols, qx) * okf,
                      last_set(cfg.output_h, rows, qy) * okf], -1)


def ppue_scribble(points: torch.Tensor, scribbles: torch.Tensor,
                  rects: torch.Tensor, cfg: PPuEConfig = PPuEConfig(),
                  num_max_points: Optional[int] = None) -> torch.Tensor:
    """Click encoding with the LAST valid positive slot replaced by the
    scribble vector (is_vpu_model.py:294-352). scribbles: (B, S, 2) curve
    samples (col, row); rects: (B, 4)."""
    b, twon, _ = points.shape
    n = twon // 2
    vec = ppue_click(points, cfg, num_max_points=None)
    prof = _scribble_vec(cfg, scribbles.float(), rects.float())
    lbl = (torch.arange(3, device=points.device) == 0).float().expand(b, 3)
    row = torch.cat([prof, lbl], -1)
    valid = points[:, :n, 2] != -1
    # last index with label != -1 (reference: scribble_index[...][-1][1])
    idx = (n - 1) - torch.argmax(valid.flip(1).to(torch.uint8), 1)
    idx = torch.where(valid.any(1), idx, twon)            # none: no row
    vec = _replace_row(vec, idx, row)
    return _pad_slots(vec, cfg, n, num_max_points or n)
