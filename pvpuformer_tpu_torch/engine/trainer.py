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
    imports, to TensorBoard (SummaryWriterAvg, trainer.py:209-244);
  * every `image_dump_interval` steps the first sample's qualitative panel
    (the JAX Trainer's array) is written to `vis_dir` as a PNG by the
    port's own encoder (the JAX Trainer writes a JPEG through PIL).

The model and the optimizer are trained in place. The loader is any
iterable of numpy batch dicts with `set_epoch(epoch)`.

Data parallelism (JAX trainer.py:75-111,130-160,274-291): with a `mesh`
(parallel/mesh.make_mesh, one rank per process under torch.distributed)
the loader yields this rank's rows of each global batch (`Loader`'s
process_index / process_count over the mesh's data ranks: the ranks of one
model group load the same rows), the parameters are placed by
`shard_params(model, mesh, param_mode)` ("replicated", "tp", "fsdp" or
"tp+fsdp"; the optimizer is rebound to FSDP's parameters, and keeps the
split blocks' parameters, cut in place), and `train_step` returns the
global batch's logs and metric inputs, so the AdaptiveIoU state is the
same on every rank and equals one process's. Rank 0 alone writes
checkpoints, TensorBoard and panels; a checkpoint holds the whole
parameters and Adam moments, as one process writes them, and `resume`
places them on the mesh again.
"""
from __future__ import annotations

import logging
import random
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .. import nn
from ..models.vpu import VPUModel
from ..parallel import dist
from ..parallel.mesh import (data_size, full_state_dict, is_sharded,
                             is_split, load_full_state_dict, shard_params)
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
                 vis_dir: Optional[str] = None,
                 image_dump_interval: int = 0,
                 tb_dump_period: int = 25,
                 log_every: int = 25, seed: int = 0, device=None,
                 mesh=None, param_mode: str = "replicated"):
        """`device` None means the card (and raises without one); the model
        moves there, its parameters keep their identity (so `tx`, built by
        `make_optimizer(model)`, still holds them) unless `param_mode`
        "fsdp" or "tp+fsdp" shards them over `mesh`, and `tx` is then
        rebound to the sharded parameters. Without a mesh every mode is one
        device's."""
        self.device = nn.resolve_device(device)
        self.mesh = mesh
        self.param_mode = param_mode
        pcount = getattr(train_loader, "pcount", None)
        if pcount is not None and pcount != data_size(mesh):
            raise ValueError(f"the loader shards batches over {pcount} "
                             f"processes, the mesh has {data_size(mesh)} "
                             f"ranks")
        self.model = model.to(self.device)
        names = {id(p): n for n, p in self.model.named_parameters()}
        shard_params(self.model, mesh, param_mode)
        if is_sharded(self.model):
            now = dict(self.model.named_parameters())
            tx.rebind({i: now[n] for i, n in names.items()})
        self.cfg = cfg
        self.tx = tx
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.checkpoint_dir = Path(checkpoint_dir) if checkpoint_dir else None
        self.checkpoint_interval = checkpoint_interval
        self.metrics = list(metrics) if metrics is not None else [AdaptiveIoU()]
        self.val_metrics = [AdaptiveIoU() for _ in self.metrics]
        self.vis_dir = Path(vis_dir) if vis_dir else None
        self.image_dump_interval = image_dump_interval
        self.log_every = log_every
        self.seed = seed
        self.global_step = 0
        self.epoch = 0
        self._tb = None
        if tb_dir and dist.is_master():
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
                num_iters=num_iters, device=self.device, mesh=self.mesh)
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
            if self.image_dump_interval > 0 and \
                    self.global_step % self.image_dump_interval == 0:
                self._dump_visualization(batch)
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
                num_iters=num_iters, device=self.device, mesh=self.mesh)
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

    @torch.no_grad()
    def dump_panel(self, batch) -> np.ndarray:
        """The first sample's qualitative panel (trainer.py:219-220,
        save_visualization at 556-592): [image + order-coded clicks | gt
        prob map | predicted prob map] over [blend with gt boundaries |
        predicted mask blend | FN/FP error map], from the current weights."""
        from ..utils.vis import (draw_probmap, draw_with_blend_and_clicks,
                                 error_map, get_boundaries)

        img = np.asarray(batch["image"][0])
        gt = np.asarray(batch["instances"][0, :, :, 0])
        pts = np.asarray(batch["points"][:1])
        dev = self.device
        image = torch.as_tensor(np.asarray(batch["image"][:1]), device=dev)
        net_in = torch.cat([image, torch.zeros_like(image[..., :1])], -1)
        out = self.model(net_in, torch.as_tensor(pts, device=dev),
                         cfg=self.cfg.model)
        pred = torch.sigmoid(out["instances"][0, :, :, 0].float()).cpu().numpy()

        image_u8 = np.clip(img * 255, 0, 255).astype(np.uint8)
        gt_disp = gt.copy()                 # ignore pixels at 0.25 (:588)
        gt_disp[gt_disp < 0] = 0.25
        row1 = np.concatenate([
            draw_with_blend_and_clicks(image_u8, clicks_list=pts[0],
                                       order_markers=True),
            draw_probmap(gt_disp),
            draw_probmap(pred),
        ], axis=1)
        gtb = (gt > 0.5).astype(np.int32)
        blend = draw_with_blend_and_clicks(image_u8, mask=gtb,
                                           clicks_list=pts[0])
        blend[get_boundaries(gtb)] = (255, 255, 255)
        row2 = np.concatenate([
            blend,
            draw_with_blend_and_clicks(image_u8,
                                       mask=(pred > 0.5).astype(int) * 2),
            error_map(gtb, pred > 0.5),
        ], axis=1)
        return np.concatenate([row1, row2], axis=0)

    def _dump_visualization(self, batch) -> None:
        """Rank 0's first sample; under FSDP or tensor parallelism every
        rank runs the forward (its parameter gathers and the split blocks'
        reductions are collectives) and rank 0 writes."""
        if self.vis_dir is None or not (dist.is_master()
                                        or is_sharded(self.model)
                                        or is_split(self.model)):
            return
        from ..utils.vis import write_png
        panel = self.dump_panel(batch)
        if dist.is_master():
            self.vis_dir.mkdir(parents=True, exist_ok=True)
            write_png(self.vis_dir / f"{self.global_step:06d}.png", panel)

    def save(self, epoch: int, name: Optional[str] = None) -> None:
        """Rank 0 writes the whole parameters and optimizer state (gathered
        from every rank under FSDP, so every rank calls this)."""
        if self.checkpoint_dir is None:
            return
        path = self.checkpoint_dir / (name or f"{epoch:03d}.npz")
        state = full_state_dict(self.model)
        opt = self.tx.state_dict()
        if dist.is_master():
            for p in (path, self.checkpoint_dir / "last_checkpoint.npz"):
                save_checkpoint(p, state, config=self.cfg, opt_state=opt,
                                step=self.global_step,
                                extra={"epoch": epoch})
            logger.info("saved checkpoint %s", path)
        dist.synchronize()

    def resume(self, path) -> int:
        """Load parameters, optimizer state and counters in place (each
        rank its shards); returns the epoch to continue from."""
        flat, _, step, extra = load_checkpoint(path, opt_state=True)
        load_full_state_dict(self.model, params_from_numpy(flat))
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
