"""The training loop: epochs, metrics, checkpoint schedule, logging
(pvpuformer_tpu/engine/trainer.py).

Re-derivation of ISTrainer's outer machinery (`isegm/engine/trainer.py:25-298`)
around `train_step`:
  * per batch, the host draws num_iters = randint(1, max_num_next_clicks)
    from `random.Random(f"{seed}-{epoch}")` (trainer.py:339), the same
    Python sequence as the JAX Trainer, and seeds the step's draws with
    `(seed << 20) ^ global_step`, as the JAX Trainer keys its step;
  * the AdaptiveIoU state and the per-key loss sums stay on the device, so
    the loop syncs the host only for the console line every `log_every`
    steps and at the end of an epoch;
  * checkpoints follow the piecewise interval schedule [(start_epoch,
    every), ...] (trainer.py:257-264): `last_checkpoint.npz` and numbered
    epoch files in the JAX format (utils/serialization.py);
  * scalars go to the console logger and, when torch's TensorBoard writer
    imports, to TensorBoard (SummaryWriterAvg, trainer.py:209-244).

The model and the optimizer are trained in place. The loader is any
iterable of numpy batch dicts with `set_epoch(epoch)`. There is no mesh:
one device, no data parallelism yet. The periodic image dump
(`image_dump_interval`) needs utils/vis, which is not ported.
"""
from __future__ import annotations

import logging
import random
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

import torch

from .. import nn
from ..models.vpu import VPUModel
from ..utils.serialization import (load_checkpoint, params_from_numpy,
                                   save_checkpoint)
from .metrics import AdaptiveIoU, adaptive_iou_step, state_thresholds
from .optimizer import TrainOptimizer
from .train_step import TrainConfig, eval_step, train_step

logger = logging.getLogger("pvpuformer_tpu_torch")


class _AvgWriter:
    """Window-averaged scalar logging (SummaryWriterAvg, isegm/utils/log.py:
    51-97): scalars, which may be device tensors, accumulate without a sync
    and flush as means every `period` steps."""

    def __init__(self, writer, period: int = 25):
        self._w = writer
        self._period = period
        self._acc = {}

    def add_scalar(self, tag, value, global_step, disable_avg=False):
        if disable_avg or self._period <= 1:
            self._w.add_scalar(tag, float(value), global_step)
            return
        s, n = self._acc.get(tag, (0.0, 0))
        s, n = s + value, n + 1
        if n >= self._period:
            self._w.add_scalar(tag, float(s) / n, global_step)
            s, n = 0.0, 0
        self._acc[tag] = (s, n)


def _interval_for_epoch(schedule, epoch: int) -> int:
    """checkpoint_interval as int or [(start, every), ...] (trainer.py:257)."""
    if isinstance(schedule, int):
        return schedule
    every = schedule[0][1]
    for start, e in schedule:
        if epoch >= start:
            every = e
    return every


class Trainer:
    def __init__(self, model: VPUModel, cfg: TrainConfig, tx: TrainOptimizer,
                 train_loader, val_loader=None, *,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_interval=10,
                 metrics: Optional[Sequence[AdaptiveIoU]] = None,
                 tb_dir: Optional[str] = None,
                 image_dump_interval: int = 0,
                 tb_dump_period: int = 25,
                 log_every: int = 25, seed: int = 0, device=None):
        """`device` None means the card (and raises without one); the model
        moves there, its parameters keep their identity (so `tx`, built by
        `make_optimizer(model)`, still holds them)."""
        if image_dump_interval > 0:
            raise NotImplementedError("image_dump_interval needs utils/vis, "
                                      "which is not ported yet")
        self.device = nn.resolve_device(device)
        self.model = model.to(self.device)
        self.cfg = cfg
        self.tx = tx
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.checkpoint_dir = Path(checkpoint_dir) if checkpoint_dir else None
        self.checkpoint_interval = checkpoint_interval
        self.metrics = list(metrics) if metrics is not None else [AdaptiveIoU()]
        self.val_metrics = [AdaptiveIoU() for _ in self.metrics]
        self.log_every = log_every
        self.seed = seed
        self.global_step = 0
        self.epoch = 0
        self._tb = None
        if tb_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = _AvgWriter(SummaryWriter(tb_dir),
                                      period=tb_dump_period)
            except ImportError:
                logger.warning("tensorboard unavailable; console logging only")

    def _log_scalar(self, tag: str, value) -> None:
        if self._tb is not None:
            self._tb.add_scalar(tag, value, self.global_step)

    def training(self, epoch: int) -> Dict[str, float]:
        self.train_loader.set_epoch(epoch)
        rng = random.Random(f"{self.seed}-{epoch}")
        for m in self.metrics:
            m.reset_epoch_stats()
        sums: Dict[str, torch.Tensor] = {}
        count = 0
        t0 = time.time()
        m = self.metrics[0]
        mstate = m.device_state(self.device)
        for i, batch in enumerate(self.train_loader):
            num_iters = rng.randint(1, self.cfg.max_num_next_clicks)
            gen = torch.Generator().manual_seed(
                (self.seed << 20) ^ self.global_step)
            thr = state_thresholds(mstate, thresh_step=m.thresh_step)
            logs, ious, valid = train_step(
                self.model, self.tx, batch, gen, thr, cfg=self.cfg,
                num_iters=num_iters, device=self.device)
            mstate = adaptive_iou_step(
                mstate, ious, valid, thresh_step=m.thresh_step,
                thresh_beta=m.thresh_beta, iou_beta=m.iou_beta)
            self.global_step += 1
            for k, v in logs.items():
                sums[k] = sums[k] + v if k in sums else v
            count += 1
            if (i + 1) % self.log_every == 0:
                logger.info("epoch %d step %d loss %.4f (%.2f s/it)",
                            epoch, i + 1, float(logs["loss"]),
                            (time.time() - t0) / (i + 1))
            self._log_scalar("Losses/loss", logs["loss"])
        m.ingest_state(mstate)
        means = {k: float(v) / max(count, 1) for k, v in sums.items()}
        means["AdaptiveIoU"] = m.get_epoch_value()
        logger.info("epoch %d done: loss %.4f iou %.4f", epoch,
                    means.get("loss", float("nan")), means["AdaptiveIoU"])
        return means

    def validation(self, epoch: int) -> Dict[str, float]:
        if self.val_loader is None:
            raise ValueError("validation needs a val_loader")
        for m in self.val_metrics:
            m.reset_epoch_stats()
        rng = random.Random(f"{self.seed}-{epoch}-val")
        sums: Dict[str, torch.Tensor] = {}
        count = 0
        m = self.val_metrics[0]
        mstate = m.device_state(self.device)
        for batch in self.val_loader:
            num_iters = rng.randint(1, self.cfg.max_num_next_clicks)
            gen = torch.Generator().manual_seed(epoch * 131071 + count)
            thr = state_thresholds(mstate, thresh_step=m.thresh_step)
            logs, ious, valid = eval_step(
                self.model, batch, gen, thr, cfg=self.cfg,
                num_iters=num_iters, device=self.device)
            mstate = adaptive_iou_step(
                mstate, ious, valid, thresh_step=m.thresh_step,
                thresh_beta=m.thresh_beta, iou_beta=m.iou_beta)
            for k, v in logs.items():
                sums[k] = sums[k] + v if k in sums else v
            count += 1
        m.ingest_state(mstate)
        means = {k: float(v) / max(count, 1) for k, v in sums.items()}
        means["AdaptiveIoU"] = m.get_epoch_value()
        logger.info("val epoch %d: loss %.4f iou %.4f", epoch,
                    means.get("loss", float("nan")), means["AdaptiveIoU"])
        return means

    def save(self, epoch: int, name: Optional[str] = None) -> None:
        if self.checkpoint_dir is None:
            return
        path = self.checkpoint_dir / (name or f"{epoch:03d}.npz")
        state = self.model.state_dict()
        opt = self.tx.state_dict()
        for p in (path, self.checkpoint_dir / "last_checkpoint.npz"):
            save_checkpoint(p, state, config=self.cfg, opt_state=opt,
                            step=self.global_step, extra={"epoch": epoch})
        logger.info("saved checkpoint %s", path)

    def resume(self, path) -> int:
        """Load parameters, optimizer state and counters in place; returns
        the epoch to continue from."""
        flat, _, step, extra = load_checkpoint(path, opt_state=True)
        self.model.load_state_dict(params_from_numpy(flat))
        if extra["opt_state"]:
            self.tx.load_state_dict(extra["opt_state"])
        self.global_step = step
        self.epoch = int(extra.get("epoch", -1)) + 1
        logger.info("resumed from %s at epoch %d step %d", path, self.epoch,
                    step)
        return self.epoch

    def run(self, num_epochs: int, start_epoch: Optional[int] = None,
            validation: bool = False) -> None:
        start = self.epoch if start_epoch is None else start_epoch
        for epoch in range(start, num_epochs):
            self.epoch = epoch
            self.training(epoch)
            if validation and self.val_loader is not None:
                self.validation(epoch)
            if (epoch + 1) % _interval_for_epoch(self.checkpoint_interval,
                                                 epoch) == 0 \
                    or epoch == num_epochs - 1:
                self.save(epoch)
