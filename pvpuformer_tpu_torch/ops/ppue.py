"""PPuE click encoding (pvpuformer_tpu/ops/ppue.py, `ppue_click` only).

Each click (y, x, order) becomes a pair of 1-D Gaussian profiles plus a
3-bit type label: the FIRST profile (length W) is indexed by the ROW
coordinate, as in the reference. Rows labelled -1 become the not-a-point
vector [0 ... 0, 0, 0, 1]. Box and scribble encoders are not ported yet.
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


def _in_img(p0, p1, w: int, h: int):
    return (p0 >= 0) & (p0 <= w) & (p1 >= 0) & (p1 <= h)


def _gauss_profile(length: int, center: torch.Tensor, sigma: float,
                   radius: int, heighten: bool) -> torch.Tensor:
    """(...,) int centres -> (..., length) exp(-d^2 / 2 sigma^2), |d| <= radius."""
    idx = torch.arange(length, dtype=torch.float32, device=center.device)
    d = idx - center.float()[..., None]
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
    not_a_point = torch.zeros(cfg.vec_dim, device=points.device)
    not_a_point[-1] = 1.0
    vec = torch.where((pts[..., 2] == -1)[..., None], not_a_point, vec)
    if nmax != n:
        pad = not_a_point.expand(b, nmax - n, cfg.vec_dim)
        vec = torch.cat([vec[:, :n], pad, vec[:, n:], pad], 1)
    return vec


def ppue_box(*args, **kwargs):
    raise NotImplementedError("ppue_box is not ported yet (ROADMAP Queue 1 "
                              "item 9: box and scribble prompts)")


def ppue_scribble(*args, **kwargs):
    raise NotImplementedError("ppue_scribble is not ported yet (ROADMAP "
                              "Queue 1 item 9: box and scribble prompts)")
