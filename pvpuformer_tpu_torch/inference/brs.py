"""BRS (backpropagating refinement) predictors
(pvpuformer_tpu/inference/brs.py; reference isegm/inference/predictors/
brs.py:9-307, brs_functors.py:9-109, brs_losses.py:6-28).

After each click, auxiliary variables are optimized with scipy's L-BFGS-B
so that the prediction agrees with the clicks:
  * f-BRS (`FeatureBRSPredictor`, VPU models): a per-channel scale and
    bias on a feature map: the ViT tokens ("tokens", f-BRS-A; the neck and head run
    per evaluation), the neck's four maps ("neck", f-BRS-B; the head runs)
    or the head's fused features ("head", f-BRS-C; only the classifier
    runs). The trunk runs once per click, without autograd.
  * RGB-BRS / DistMap-BRS (`InputBRSPredictor`): an additive perturbation
    of the RGB input (before ImageNet normalization, as JAX does) or of the
    two disk channels (`coord_bias`); every evaluation is a full forward
    and backward, through the attention backward kernel and the LN+MLP
    backward on the card.
The L-BFGS stays on the host (scipy, with JAX's m, factr, pgtol, maxfun and
early exits); each evaluation is one torch forward plus
`torch.autograd.grad` with respect to the optimized vector. The model's
parameters are frozen (`nn.param`), so no weight gradient is formed. The
ROI, crop and click machinery is the fused predictor's.

On the zoo models, `ZooFeatureBRSPredictor` inserts the scale and bias at
the reference's own points: HRNet "A" (the stride-4 concat of the branches;
OCR and classifier re-run) and "C" (the pre-classifier OCR features; the
classifier re-runs), DeepLab "after_c4" (ASPP, decoder and head re-run,
the skip cached), "after_aspp" and "after_deeplab". RGB-BRS and
DistMap-BRS run on every registered family through the registry's forward.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
from scipy.optimize import fmin_l_bfgs_b

from torch import nn as tnn

from .. import nn
from ..models.fpn import neck_forward
from ..models.registry import forward_for
from ..models.seg_head import _fuse, head_forward
from ..models.vpu import (VPUConfig, VPUModel, coord_features, prepare_input,
                          vpu_backbone_embed)
from ..models.zoo.deeplab import (DeeplabISConfig, deeplab_aspp_concat,
                                  deeplab_backbone, deeplab_decoder,
                                  deeplab_seg_head)
from ..models.zoo.hrnet import HRNetISConfig, _ocr, _ocr_pre_cls, hrnet_feats
from ..ops.edt import next_click_from_error
from ..ops.ppue import ppue_click
from ..ops.resize import bilinear_resize, roi_crop_resize, roi_paste_back
from .predictor import (Predictor, PredictorConfig, SessionState, _as_batch,
                        _put_user_click, _transform_points, _update_roi,
                        init_session, session)


def brs_mask_loss(result: torch.Tensor, pos_mask: torch.Tensor,
                  neg_mask: torch.Tensor, eps: float = 1e-5):
    """BRSMaskLoss (brs_losses.py:6-28) of sigmoid probs: (loss, max
    |pos diff|, max |neg diff|)."""
    pos_diff = (1.0 - result) * pos_mask
    pos_target = pos_diff.square().sum() / (pos_mask.sum() + eps)
    neg_diff = result * neg_mask
    neg_target = neg_diff.square().sum() / (neg_mask.sum() + eps)
    return (pos_target + neg_target, pos_diff.abs().max(),
            neg_diff.abs().max())


def click_maps(points: torch.Tensor, h: int, w: int, radius: int = 1):
    """_get_clicks_maps_nd (brs.py:23-43): (2r+1)^2 stamps at the valid
    clicks of points (B, 2N, 3) -> (pos, neg) maps (B, h, w) f32."""
    n = points.shape[1] // 2
    yy = torch.arange(h, dtype=torch.float32, device=points.device)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=points.device)[None, :]

    def one_half(pts):
        dy = (yy - pts[..., 0, None, None]).abs()
        dx = (xx - pts[..., 1, None, None]).abs()
        stamp = ((dy <= radius) & (dx <= radius)
                 & (pts[..., 2] >= 0)[..., None, None])
        return stamp.any(1).float()

    return one_half(points[:, :n]), one_half(points[:, n:])


def value_and_grad(objective: Callable, *args, argnum: int):
    """((value, aux), grad) of `objective(*args)` -> (value, aux) with
    respect to args[argnum], as `jax.value_and_grad(..., has_aux=True)`.
    Grad mode is on inside, whatever the caller's."""
    args = list(args)
    opt = args[argnum].detach().requires_grad_(True)
    args[argnum] = opt
    with torch.enable_grad():
        value, aux = objective(*args)
        grad, = torch.autograd.grad(value, opt)
    return (value.detach(), tuple(a.detach() for a in aux)), grad


# ---------------------------------------------------------------------------
# model pieces and the objectives
# ---------------------------------------------------------------------------

@torch.no_grad()
def _backbone_tokens(model: VPUModel, cfg: VPUConfig, crop: torch.Tensor,
                     pts: torch.Tensor):
    crop = crop.to(cfg.dtype)
    rgb, prev_mask = prepare_input(model, cfg, crop)
    coords = coord_features(cfg, rgb, prev_mask, pts)
    tokens = vpu_backbone_embed(model, cfg, rgb, coords)
    pv = ppue_click(pts, cfg.ppue, num_max_points=cfg.num_max_points)
    return tokens, pv.to(cfg.dtype)


@torch.no_grad()
def _neck_feats(model: VPUModel, cfg: VPUConfig, tokens, pv):
    ms, q_out = neck_forward(model.neck, cfg.neck, tokens, pv,
                             cfg.backbone.grid_size)
    return tuple(ms), q_out


@torch.no_grad()
def _head_fused(model: VPUModel, cfg: VPUConfig, tokens, pv):
    ms, _ = neck_forward(model.neck, cfg.neck, tokens, pv,
                         cfg.backbone.grid_size)
    return _fuse(model.head, cfg.head, ms)


def _loss(logits, pos, neg, with_flip: bool):
    """The click-consistency loss of (B, th, tw, 1) logits; with flip the
    pair is averaged first and only the originals' click maps count."""
    probs = torch.sigmoid(logits.float())[..., 0]
    if with_flip:
        probs = 0.5 * (probs[:1] + probs[1:].flip(2))
        pos, neg = pos[:1], neg[:1]
    return brs_mask_loss(probs, pos, neg)


def _modulate(feat, scale, bias):
    """feat * (1 + scale) + bias in f32, rounded back to the feature dtype."""
    return (feat.float() * (1.0 + scale) + bias).to(feat.dtype)


def _reg(scale, bias, reg_weight: float, reg_bias_weight: float):
    return reg_weight * (scale.square().sum()
                         + reg_bias_weight * bias.square().sum())


def _scale_bias_objective(model: VPUModel, cfg: VPUConfig, tokens, pv, opt,
                          pos, neg, reg_weight: float, reg_bias_weight: float,
                          with_flip: bool, th: int, tw: int):
    """f-BRS-A: scale / bias on the backbone tokens; neck and head re-run."""
    scale, bias = opt.chunk(2)
    ms, q_out = neck_forward(model.neck, cfg.neck,
                             _modulate(tokens, scale, bias), pv,
                             cfg.backbone.grid_size)
    seg, _ = head_forward(model.head, cfg.head, ms, q_out)
    logits = bilinear_resize(seg, th, tw, align_corners=True)
    loss, fmax_pos, fmax_neg = _loss(logits, pos, neg, with_flip)
    return (loss + _reg(scale, bias, reg_weight, reg_bias_weight),
            (logits, fmax_pos, fmax_neg))


def _neck_objective(model: VPUModel, cfg: VPUConfig, ms, q_out, opt, pos,
                    neg, reg_weight: float, reg_bias_weight: float,
                    with_flip: bool, th: int, tw: int):
    """f-BRS-B: scale / bias on the neck's four maps; the head re-runs."""
    dims = [m.shape[-1] for m in ms]
    total = sum(dims)
    scale_all, bias_all = opt[:total], opt[total:]
    mod, off = [], 0
    for m, d in zip(ms, dims):
        mod.append(_modulate(m, scale_all[off:off + d],
                             bias_all[off:off + d]))
        off += d
    seg, _ = head_forward(model.head, cfg.head, mod, q_out)
    logits = bilinear_resize(seg, th, tw, align_corners=True)
    loss, fmax_pos, fmax_neg = _loss(logits, pos, neg, with_flip)
    return (loss + _reg(scale_all, bias_all, reg_weight, reg_bias_weight),
            (logits, fmax_pos, fmax_neg))


def _head_objective(model: VPUModel, cfg: VPUConfig, fused, opt, pos, neg,
                    reg_weight: float, reg_bias_weight: float,
                    with_flip: bool, th: int, tw: int):
    """f-BRS-C: scale / bias on the head's fused features; only the
    classifier conv re-runs."""
    d = fused.shape[-1]
    scale, bias = opt[:d], opt[d:]
    seg = nn.conv1x1(model.head.conv_seg, _modulate(fused, scale, bias))
    logits = bilinear_resize(seg, th, tw, align_corners=True)
    loss, fmax_pos, fmax_neg = _loss(logits, pos, neg, with_flip)
    return (loss + _reg(scale, bias, reg_weight, reg_bias_weight),
            (logits, fmax_pos, fmax_neg))


# --- f-BRS on the zoo models: one trunk / tail split per insertion point ---

@torch.no_grad()
def _zoo_trunk(model: tnn.Module, cfg, crop, pts, insertion: str):
    """(feat, rest): `feat` gets the scale / bias, `rest` passes through to
    the tail."""
    crop = crop.to(cfg.dtype)
    if isinstance(cfg, HRNetISConfig):
        feats = hrnet_feats(model, cfg, crop, pts)
        if insertion == "A":
            return feats, ()
        return _ocr_pre_cls(model.ocr, feats)[0], ()
    if not isinstance(cfg, DeeplabISConfig):
        raise ValueError(f"f-BRS on a zoo model takes HRNet or DeepLab, not "
                         f"{type(cfg).__name__}")
    skip, c4 = deeplab_backbone(model, cfg, crop, pts)
    if insertion == "after_c4":
        return c4, (skip,)
    y = deeplab_aspp_concat(model, c4, skip)
    if insertion == "after_aspp":
        return y, ()
    return deeplab_decoder(model, y), ()


def _tail_hrnet_A(model, mod):
    return _ocr(model.ocr, mod)[0]


def _tail_hrnet_C(model, mod):
    return nn.conv1x1(model.ocr.cls, mod)


def _tail_deeplab_c4(model, mod, skip):
    y = deeplab_aspp_concat(model, mod, skip)
    return deeplab_seg_head(model, deeplab_decoder(model, y))


def _tail_deeplab_aspp(model, mod):
    return deeplab_seg_head(model, deeplab_decoder(model, mod))


def _tail_deeplab_head(model, mod):
    return deeplab_seg_head(model, mod)


_ZOO_TAILS = {"A": _tail_hrnet_A, "C": _tail_hrnet_C,
              "after_c4": _tail_deeplab_c4, "after_aspp": _tail_deeplab_aspp,
              "after_deeplab": _tail_deeplab_head}


def _zoo_objective(tail: Callable, model: tnn.Module, feat, rest, opt, pos,
                   neg, reg_weight: float, reg_bias_weight: float,
                   with_flip: bool, th: int, tw: int):
    """Scale / bias on a zoo model's insertion map; the tail re-runs."""
    d = feat.shape[-1]
    scale, bias = opt[:d], opt[d:]
    logits = bilinear_resize(tail(model, _modulate(feat, scale, bias), *rest),
                             th, tw, align_corners=True)
    loss, fmax_pos, fmax_neg = _loss(logits, pos, neg, with_flip)
    return (loss + _reg(scale, bias, reg_weight, reg_bias_weight),
            (logits, fmax_pos, fmax_neg))


def _input_objective(model: tnn.Module, cfg, crop, pts, delta, pos,
                     neg, reg_weight: float, with_flip: bool, th: int,
                     tw: int, target: str):
    """RGB-BRS / DistMap-BRS (brs.py:252-290) on any registered family:
    target "rgb" adds the delta to the image channels before normalization;
    "dmaps" adds it to the two disk channels (`coord_bias`). A full
    forward."""
    reg = reg_weight * delta.square().sum()
    nch = 3 if target == "rgb" else 2
    d = delta.reshape(1, th, tw, nch)
    if with_flip:
        d = torch.cat([d, d.flip(2)], 0)
    coord_bias = None
    if target == "rgb":
        crop = torch.cat([crop[..., :3] + d.to(crop.dtype), crop[..., 3:]], -1)
    else:
        coord_bias = d
    logits = forward_for(cfg)(model, cfg, crop, pts, prompt_type=0,
                              coord_bias=coord_bias)["instances"]
    loss, fmax_pos, fmax_neg = _loss(logits, pos, neg, with_flip)
    return loss + reg, (logits, fmax_pos, fmax_neg)


# ---------------------------------------------------------------------------
# predictors
# ---------------------------------------------------------------------------

def _round_inputs(cfg: PredictorConfig, st: SessionState):
    """One session's ROI decision, crop (flip pair) and zoomed clicks: the
    fused predictor's machinery (`_forward_round`), without the network
    click limit, as JAX's BRS round runs it."""
    sb = _as_batch(st)
    roi, has_roi = _update_roi(cfg, sb, sb.points)
    th, tw = cfg.target_size
    crop = roi_crop_resize(torch.cat([sb.image, sb.prev_probs], -1), roi,
                           th, tw)
    if cfg.with_flip:
        crop = torch.cat([crop, crop.flip(2)], 0)
    pts = _transform_points(sb.points, roi, (th, tw), cfg.with_flip)
    return crop, pts, roi, has_roi


class FeatureBRSPredictor:
    """f-BRS; a drop-in for `Predictor` in the evaluation loop and the
    controller. `insertion` "tokens" (A), "neck" (B) or "head" (C). The
    model is moved to `device` (None: the card) and cast, in place, as
    `Predictor` does."""

    _INSERTIONS = ("tokens", "neck", "head")

    def __init__(self, model: VPUModel, cfg: PredictorConfig,
                 reg_weight: float = 1e-3, reg_bias_weight: float = 10.0,
                 max_iters: int = 20, optimize_after_n_clicks: int = 1,
                 min_iou_diff: float = 0.01, insertion: str = "tokens",
                 device=None):
        if insertion not in self._INSERTIONS:
            raise ValueError(f"insertion {insertion!r} is not one of "
                             f"{self._INSERTIONS}")
        self.device = nn.resolve_device(device)
        self.model = nn.inference_model(model, cfg.model.dtype,
                                        self.device)
        self.cfg = cfg
        self.reg_weight = reg_weight
        self.reg_bias_weight = reg_bias_weight
        self.max_iters = max_iters
        self.optimize_after_n_clicks = optimize_after_n_clicks
        self.min_iou_diff = min_iou_diff
        self.insertion = insertion
        self.state: Optional[SessionState] = None
        self.opt_data: Optional[np.ndarray] = None
        self._undo: list = []
        self.evaluations = 0              # functor calls, for the logs

    def _canvas(self, h: int, w: int):
        b = self.cfg.canvas_bucket
        return (-(-h // b) * b, -(-w // b) * b)

    def set_input(self, image: np.ndarray, gt_mask: np.ndarray) -> None:
        self.state = init_session(image, gt_mask,
                                  self.cfg.model.num_max_points,
                                  self._canvas(*image.shape[:2]), self.device)
        self.opt_data = None
        self._undo = []

    def _push_undo(self) -> None:
        self._undo.append((self.state, None if self.opt_data is None
                           else self.opt_data.copy()))

    def _apply_click(self, is_pos, cy, cx) -> SessionState:
        return session(_put_user_click(_as_batch(self.state),
                                       is_pos.reshape(1), cy.reshape(1),
                                       cx.reshape(1)), 0)

    def next_click(self) -> float:
        """One oracle round (evaluation): the EDT click from the gt error
        masks, then the BRS-optimized forward."""
        self._push_undo()
        st, thr = self.state, self.cfg.prob_thresh
        pred = st.prev_probs[0, :, :, 0] > thr
        gt_pos = st.gt == 1
        not_ignore = st.gt != -1
        is_pos, cy, cx, _ = next_click_from_error(
            gt_pos & ~pred & not_ignore, ~gt_pos & pred & not_ignore,
            st.not_clicked)
        return self._optimize_round(self._apply_click(is_pos, cy, cx))

    def user_click(self, y: float, x: float, is_positive: bool) -> float:
        """One round with a user's click, rounded to the nearest pixel as
        JAX's BRS user click is (the fused predictor truncates); returns
        IoU against the session's gt (0 for a gt-less demo session)."""
        self._push_undo()
        dev = self.device
        i32 = dict(dtype=torch.int32, device=dev)
        return self._optimize_round(self._apply_click(
            torch.tensor(bool(is_positive), device=dev),
            torch.tensor(int(round(y)), **i32),
            torch.tensor(int(round(x)), **i32)))

    def _setup(self, crop, pts):
        """Run the trunk once: (objective(opt, pos, neg) -> (loss, aux),
        the optimized vector's size)."""
        model, mcfg = self.model, self.cfg.model
        tokens, pv = _backbone_tokens(model, mcfg, crop, pts)
        if self.insertion == "tokens":
            fn, res, size = _scale_bias_objective, (tokens, pv), \
                2 * tokens.shape[-1]
        elif self.insertion == "neck":
            ms, q_out = _neck_feats(model, mcfg, tokens, pv)
            fn, res, size = _neck_objective, (ms, q_out), \
                2 * sum(m.shape[-1] for m in ms)
        else:
            fused = _head_fused(model, mcfg, tokens, pv)
            fn, res, size = _head_objective, (fused,), 2 * fused.shape[-1]
        th, tw = self.cfg.target_size
        kw = (self.reg_weight, self.reg_bias_weight, self.cfg.with_flip,
              th, tw)

        def objective(opt, pos, neg):
            return fn(model, mcfg, *res, opt, pos, neg, *kw)
        return objective, size

    def _lbfgs(self, objective, x0: np.ndarray, pos, neg, iou_stop: bool):
        """scipy's L-BFGS-B over `objective` from x0 (JAX's m, factr, pgtol,
        maxfun = max_iters and early exits, brs_functors.py:60-72); returns
        the best point seen."""
        thr = self.cfg.prob_thresh
        best = {"loss": np.inf, "x": x0.copy()}
        last_mask = {"m": None}

        def functor(x):
            self.evaluations += 1
            opt = torch.from_numpy(np.asarray(x)).float().to(self.device)
            (loss, (logits, fp_, fn_)), grad = value_and_grad(
                objective, opt, pos, neg, argnum=0)
            f_val = float(loss)
            if f_val < best["loss"]:
                best["loss"] = f_val
                best["x"] = np.asarray(x, np.float64).copy()
            if float(fp_) < 1 - thr and float(fn_) < thr:
                return f_val, np.zeros_like(np.asarray(x))
            if iou_stop:
                m = (torch.sigmoid(logits[..., 0].float()) > thr).cpu().numpy()
                if last_mask["m"] is not None and self.min_iou_diff > 0:
                    inter = np.logical_and(m, last_mask["m"]).sum()
                    union = np.logical_or(m, last_mask["m"]).sum()
                    if union > 0 and inter / union > 1 - self.min_iou_diff:
                        return f_val, np.zeros_like(np.asarray(x))
                last_mask["m"] = m
            return f_val, grad.double().cpu().numpy().ravel()

        fmin_l_bfgs_b(func=functor, x0=x0, m=20, factr=0, pgtol=1e-8,
                      maxfun=self.max_iters)
        return best["x"]

    def _finish(self, st: SessionState, logits, roi, has_roi) -> float:
        """Paste the (flip-averaged) result into the session; IoU on the
        host."""
        if self.cfg.with_flip:
            logits = 0.5 * (logits[:1] + logits[1:].flip(2))
        hc, wc = st.gt.shape
        canvas = roi_paste_back(torch.sigmoid(logits.float()), roi, hc, wc)
        st = st._replace(prev_probs=canvas, roi=roi[0], has_roi=has_roi[0])
        self.state = st
        pm = canvas[0, :, :, 0].cpu().numpy() > self.cfg.prob_thresh
        gt = st.gt.cpu().numpy()
        inter = np.logical_and(pm, gt == 1)[gt != -1].sum()
        union = np.logical_or(pm, gt == 1)[gt != -1].sum()
        return float(inter / max(union, 1))

    @torch.no_grad()
    def _optimize_round(self, st: SessionState) -> float:
        crop, pts, roi, has_roi = _round_inputs(self.cfg, st)
        th, tw = self.cfg.target_size
        pos, neg = click_maps(pts, th, tw)
        objective, size = self._setup(crop, pts)
        if self.opt_data is None or self.opt_data.size != size:
            self.opt_data = np.zeros((size,), np.float32)
        if int(st.click_count) >= self.optimize_after_n_clicks:
            self.opt_data = self._lbfgs(
                objective, self.opt_data.astype(np.float64), pos, neg,
                iou_stop=True).astype(np.float32)
        opt = torch.from_numpy(self.opt_data).to(self.device)
        logits = objective(opt, pos, neg)[1][0]
        return self._finish(st, logits, roi, has_roi)

    def run_clicks(self, num_clicks: int) -> np.ndarray:
        return np.array([self.next_click() for _ in range(num_clicks)],
                        np.float32)

    def undo_click(self) -> None:
        if self._undo:
            self.state, self.opt_data = self._undo.pop()

    @property
    def probs(self) -> np.ndarray:
        h, w = int(self.state.img_h), int(self.state.img_w)
        return self.state.prev_probs[0, :h, :w, 0].cpu().numpy()

    @property
    def clicks(self) -> np.ndarray:
        return self.state.points[0].cpu().numpy()


class ZooFeatureBRSPredictor(FeatureBRSPredictor):
    """f-BRS at the reference's own insertion points of the zoo models:
    HRNet "A" / "C" (HRNetFeatureBRSPredictor) and DeepLab "after_c4" /
    "after_aspp" / "after_deeplab" (FeatureBRSPredictor)."""

    _INSERTIONS = ("A", "C", "after_c4", "after_aspp", "after_deeplab")

    def _setup(self, crop, pts):
        model, mcfg = self.model, self.cfg.model
        feat, rest = _zoo_trunk(model, mcfg, crop, pts, self.insertion)
        tail = _ZOO_TAILS[self.insertion]
        th, tw = self.cfg.target_size
        kw = (self.reg_weight, self.reg_bias_weight, self.cfg.with_flip,
              th, tw)

        def objective(opt, pos, neg):
            return _zoo_objective(tail, model, feat, rest, opt, pos, neg, *kw)
        return objective, 2 * feat.shape[-1]


class InputBRSPredictor(FeatureBRSPredictor):
    """RGB-BRS / DistMap-BRS (brs.py:247-307): L-BFGS over an input
    perturbation, reset every click; every evaluation is a full forward
    and backward. `optimize_target` "rgb" (a 3-channel image delta) or
    "dmaps" (a 2-channel disk delta). Any registered family: the forward
    is the registry's."""

    def __init__(self, model: tnn.Module, cfg: PredictorConfig,
                 optimize_target: str = "rgb", **kw):
        if optimize_target not in ("rgb", "dmaps"):
            raise ValueError(f"optimize_target {optimize_target!r} is not "
                             f"'rgb' or 'dmaps'")
        super().__init__(model, cfg, **kw)
        self.optimize_target = optimize_target

    @torch.no_grad()
    def _optimize_round(self, st: SessionState) -> float:
        cfg = self.cfg
        crop, pts, roi, has_roi = _round_inputs(cfg, st)
        th, tw = cfg.target_size
        pos, neg = click_maps(pts, th, tw)
        kw = (self.reg_weight, cfg.with_flip, th, tw, self.optimize_target)

        def objective(delta, pos, neg):
            return _input_objective(self.model, cfg.model, crop, pts, delta,
                                    pos, neg, *kw)

        nch = 3 if self.optimize_target == "rgb" else 2
        x = np.zeros((th * tw * nch,), np.float64)
        if int(st.click_count) >= self.optimize_after_n_clicks:
            x = self._lbfgs(objective, x, pos, neg, iou_stop=False)
        delta = torch.from_numpy(x).float().to(self.device)
        logits = objective(delta, pos, neg)[1][0]
        return self._finish(st, logits, roi, has_roi)


def get_predictor(model: tnn.Module, cfg: PredictorConfig,
                  brs_mode: str = "NoBRS", int8: bool = False, device=None,
                  **brs_kwargs):
    """predictors/__init__.py:9-99's factory: NoBRS, f-BRS-A/B/C, RGB-BRS
    and DistMap-BRS. f-BRS maps its letter to an insertion point per
    family: HRNet A / A / C, DeepLab after_c4 / after_aspp / after_deeplab,
    VPU tokens / neck / head; any other family has no f-BRS (ValueError,
    as in JAX). int8 is NoBRS only: BRS differentiates the forward, and
    int8 rounding has no useful gradient."""
    mode = brs_mode.lower()
    if mode == "nobrs":
        return Predictor(model, cfg, device=device, int8=int8)
    if int8:
        raise ValueError("int8 PTQ is NoBRS only: BRS optimizes through the "
                         "forward's gradient, which int8 rounding destroys")
    letter = {"f-brs-a": "a", "f-brs": "a", "f-brs-b": "b",
              "f-brs-c": "c"}.get(mode)
    if letter is not None:
        m = cfg.model
        if isinstance(m, HRNetISConfig):
            insertion = {"a": "A", "b": "A", "c": "C"}[letter]
        elif isinstance(m, DeeplabISConfig):
            insertion = {"a": "after_c4", "b": "after_aspp",
                         "c": "after_deeplab"}[letter]
        elif isinstance(m, VPUConfig):
            insertion = {"a": "tokens", "b": "neck", "c": "head"}[letter]
        else:
            raise ValueError(
                f"f-BRS has no insertion map for {type(m).__name__} (the "
                f"reference has DeepLab / HRNet only; VPU added) — use "
                f"NoBRS, RGB-BRS or DistMap-BRS")
        brs_kwargs.setdefault("insertion", insertion)
        klass = FeatureBRSPredictor if isinstance(m, VPUConfig) \
            else ZooFeatureBRSPredictor
        return klass(model, cfg, device=device, **brs_kwargs)
    if mode in ("rgb-brs", "input-brs", "distmap-brs"):
        brs_kwargs.setdefault(
            "optimize_target", "dmaps" if mode == "distmap-brs" else "rgb")
        return InputBRSPredictor(model, cfg, device=device, **brs_kwargs)
    raise ValueError(f"unknown BRS mode {brs_mode!r}")
