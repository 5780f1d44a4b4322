"""Training metrics (pvpuformer_tpu/engine/metrics.py).

AdaptiveIoU: an EMA-adapted binarization threshold (init 0.4, +/-0.025
hill-climb, beta 0.99) and the epoch-mean IoU at the adapted threshold. The
per-batch IoUs at the three candidate thresholds come from
`iou_at_thresholds`; the hill-climb and EMAs exist twice with the same
semantics:
  * `AdaptiveIoU`, the host class (tests, tools, checkpoints);
  * `adaptive_iou_step` over an `AdaptiveIoUState` of 0-d tensors on the
    device, which the training loop threads through its steps so that it
    never syncs on the metric.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def iou_at_thresholds(pred_logits: torch.Tensor, gt: torch.Tensor,
                      thresholds: torch.Tensor, ignore_label: float = -1.0):
    """Per-sample IoU of sigmoid(pred) > t for each threshold t.

    pred_logits / gt: (B, H, W, 1); thresholds: (T,). Returns (ious (T, B),
    valid (B,)): valid marks samples with a non-empty union and gt."""
    pred = torch.sigmoid(pred_logits.float())
    gt = gt.float()
    gt_mask = gt > 0.5
    ignore = gt == ignore_label
    pm = (pred[None] > thresholds.float().view(-1, 1, 1, 1, 1)) & ~ignore
    union = (pm | gt_mask).float().mean((2, 3, 4))
    inter = (pm & gt_mask).float().mean((2, 3, 4))
    ious = inter / union.clamp_min(1e-12)
    gt_nonempty = gt_mask.sum((1, 2, 3)) > 0
    return ious, (union[0] > 0) & gt_nonempty


class AdaptiveIoUState(NamedTuple):
    """AdaptiveIoU's scalars as 0-d f32 tensors on the device."""
    iou_thresh: torch.Tensor
    ema_iou: torch.Tensor
    epoch_iou_sum: torch.Tensor
    epoch_batch_count: torch.Tensor


def state_thresholds(state: AdaptiveIoUState,
                     thresh_step: float = 0.025) -> torch.Tensor:
    """[t, t-step, t+step] candidate thresholds for `iou_at_thresholds`."""
    t = state.iou_thresh
    return torch.stack([t, t - thresh_step, t + thresh_step])


def adaptive_iou_step(state: AdaptiveIoUState, ious: torch.Tensor,
                      valid: torch.Tensor, thresh_step: float = 0.025,
                      thresh_beta: float = 0.99, iou_beta: float = 0.9
                      ) -> AdaptiveIoUState:
    """One hill-climb + EMA update (metrics.py:52-61) on the device, with no
    host sync. ious: (3, B) at [t, t-step, t+step]; valid: (B,). A batch
    with no valid sample leaves the state as it was."""
    vf = valid.float()
    n = vf.sum()
    means = (ious * vf[None, :]).sum(1) / n.clamp_min(1.0)
    t = state.iou_thresh
    cand = torch.stack([t, t - thresh_step, t + thresh_step])
    best_iou, best_t = means[0], cand[0]
    for i in (1, 2):                      # reference scan order, strict >
        better = means[i] > best_iou
        best_iou = torch.where(better, means[i], best_iou)
        best_t = torch.where(better, cand[i], best_t)
    upd = n > 0
    return AdaptiveIoUState(
        iou_thresh=torch.where(
            upd, thresh_beta * t + (1.0 - thresh_beta) * best_t, t),
        ema_iou=torch.where(
            upd, iou_beta * state.ema_iou + (1.0 - iou_beta) * best_iou,
            state.ema_iou),
        epoch_iou_sum=torch.where(upd, state.epoch_iou_sum + best_iou,
                                  state.epoch_iou_sum),
        epoch_batch_count=torch.where(upd, state.epoch_batch_count + 1.0,
                                      state.epoch_batch_count))


class AdaptiveIoU:
    """Host-side EMA threshold adaptation (metrics.py:29-84)."""

    def __init__(self, init_thresh: float = 0.4, thresh_step: float = 0.025,
                 thresh_beta: float = 0.99, iou_beta: float = 0.9,
                 ignore_label: float = -1.0,
                 pred_output: str = "instances", gt_output: str = "instances"):
        self._iou_thresh = init_thresh
        self._thresh_step = thresh_step
        self._thresh_beta = thresh_beta
        self._iou_beta = iou_beta
        self._ignore_label = ignore_label
        self._ema_iou = 0.0
        self._epoch_iou_sum = 0.0
        self._epoch_batch_count = 0
        self.pred_outputs = (pred_output,)
        self.gt_outputs = (gt_output,)

    @property
    def name(self) -> str:
        return "AdaptiveIoU"

    @property
    def iou_thresh(self) -> float:
        return self._iou_thresh

    @property
    def thresh_step(self) -> float:
        return self._thresh_step

    @property
    def thresh_beta(self) -> float:
        return self._thresh_beta

    @property
    def iou_beta(self) -> float:
        return self._iou_beta

    def thresholds(self) -> np.ndarray:
        t = self._iou_thresh
        return np.array([t, t - self._thresh_step, t + self._thresh_step],
                        np.float32)

    def update_from_ious(self, ious: np.ndarray, valid: np.ndarray) -> None:
        """ious: (3, B) at [t, t-step, t+step]; valid: (B,). The hill-climb
        and EMAs (metrics.py:52-61) on the host."""
        if not np.any(valid):
            return
        means = np.asarray(ious)[:, np.asarray(valid)].mean(axis=1)
        cand = [self._iou_thresh, self._iou_thresh - self._thresh_step,
                self._iou_thresh + self._thresh_step]
        max_iou, best_thresh = means[0], cand[0]
        for i in (1, 2):
            if means[i] > max_iou:
                max_iou, best_thresh = means[i], cand[i]
        self._iou_thresh = (self._thresh_beta * self._iou_thresh
                            + (1 - self._thresh_beta) * best_thresh)
        self._ema_iou = self._iou_beta * self._ema_iou + \
            (1 - self._iou_beta) * max_iou
        self._epoch_iou_sum += max_iou
        self._epoch_batch_count += 1

    def update(self, pred_logits: torch.Tensor, gt: torch.Tensor) -> None:
        """Eager update from one batch of logits and gt (B, H, W, 1)."""
        thr = torch.from_numpy(self.thresholds()).to(pred_logits.device)
        ious, valid = iou_at_thresholds(pred_logits, gt, thr,
                                        self._ignore_label)
        self.update_from_ious(ious.cpu().numpy(), valid.cpu().numpy())

    def device_state(self, device=None) -> AdaptiveIoUState:
        """The host scalars as a state on `device` (threaded through
        `adaptive_iou_step` by the training loop without host syncs)."""
        def f(x):
            return torch.tensor(float(x), dtype=torch.float32, device=device)
        return AdaptiveIoUState(f(self._iou_thresh), f(self._ema_iou),
                                f(self._epoch_iou_sum),
                                f(self._epoch_batch_count))

    def ingest_state(self, state: AdaptiveIoUState) -> None:
        """Sync a device state back into the host object (one readback per
        scalar: call at epoch or log boundaries, never per step)."""
        self._iou_thresh = float(state.iou_thresh)
        self._ema_iou = float(state.ema_iou)
        self._epoch_iou_sum = float(state.epoch_iou_sum)
        self._epoch_batch_count = int(round(float(state.epoch_batch_count)))

    def get_epoch_value(self) -> float:
        if self._epoch_batch_count > 0:
            return self._epoch_iou_sum / self._epoch_batch_count
        return 0.0

    def reset_epoch_stats(self) -> None:
        self._epoch_iou_sum = 0.0
        self._epoch_batch_count = 0

    def log_states(self, log_fn, tag_prefix: str, global_step: int) -> None:
        log_fn(f"{tag_prefix}_ema_iou", self._ema_iou, global_step)
        log_fn(f"{tag_prefix}_iou_thresh", self._iou_thresh, global_step)
