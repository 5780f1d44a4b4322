"""Batched multi-session evaluation, the throughput mode
(pvpuformer_tpu/inference/batched.py).

B sessions of one canvas shape run as one batch: every click round is one
`batched_click_step` over the stacked states (`predictor.stack_states`), so
the oracle's EDT is one min-plus launch for all B sessions and the flip-TTA
forward runs at batch 2B with the launches of one session. Every prompt
mode runs so; each session draws its own sequential session's prompt
noise. Sessions are grouped by canvas bucket; each group's last chunk is
padded to the batch size with copies of its last session, whose results
are dropped. A chunk's rounds run through `graphs.click_rounds`: replayed
from a captured round on the card, the eager `batched_click_scan`
elsewhere.

With a `mesh` (parallel/mesh.make_mesh, one rank per process), each rank
runs B / D sessions of every chunk (rank p rows [p B / D, (p + 1) B / D),
as JAX shards a chunk over its data axis) on its replica of the model, and
one all-reduce per chunk brings every session's IoU curve and clicks to
every rank, in dataset order. B must divide by D.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from torch import nn as tnn

from ..models import registry
from ..nn import inference_model, resolve_device
from ..parallel.dist import gather_rows
from ..parallel.mesh import data_group, data_size, shard_batch, shard_params
from . import graphs
from .predictor import (NOISE_SEED, PredictorConfig, SessionState,
                        init_session, stack_states)
from .predictor import batched_click_scan  # noqa: F401  (the eager scan)


def resolve_batched_cfg(cfg: PredictorConfig) -> PredictorConfig:
    """The batched mode's configuration: the unchunked EDT with the dense
    pass-1 form (bit-identical to the single-session defaults,
    tests/test_torch_ops.py). The mode takes the ViT-backed families (VPU,
    PlainVit) only: JAX's `resolve_batched_cfg` reads
    `cfg.model.backbone`, which a zoo config has not."""
    if registry.crop_size(cfg.model) is None:
        raise ValueError(
            f"the batched mode takes ViT-backed models (VPUConfig, "
            f"PlainVitConfig), not {type(cfg.model).__name__}: run its "
            f"sessions one at a time (Predictor, evaluate_dataset)")
    return dataclasses.replace(cfg, edt_chunk=None, edt_rows="dense")


class BatchedEvaluator:
    """Evaluate a dataset B sessions at a time. The model is moved to
    `device` (None: the card; device="cpu" for the CPU) and cast once to
    the config's compute dtype, in place, as `Predictor` does; `int8` runs
    a quantized copy (`nn.inference_model`). With a `mesh` the ranks share
    each chunk (rank 0's parameters are broadcast once); after `evaluate`,
    `clicks` holds each session's final (2N, 3) clicks in dataset order."""

    def __init__(self, model: tnn.Module, cfg: PredictorConfig,
                 batch_size: int = 8, device=None, int8: bool = False,
                 mesh=None):
        if batch_size % data_size(mesh):
            raise ValueError(f"batch size {batch_size} over "
                             f"{data_size(mesh)} ranks: B must divide by D")
        self.cfg = resolve_batched_cfg(cfg)
        self.device = resolve_device(device)
        self.model = shard_params(
            inference_model(model, cfg.model.dtype, self.device, int8), mesh)
        self.batch_size = batch_size
        self.mesh = mesh
        self.clicks: List[np.ndarray] = []

    def _canvas(self, h: int, w: int) -> Tuple[int, int]:
        b = self.cfg.canvas_bucket
        return (-(-h // b) * b, -(-w // b) * b)

    @torch.no_grad()
    def evaluate(self, dataset, max_clicks: int = 20,
                 max_iou_thr: float = 0.95, min_clicks: int = 1
                 ) -> Tuple[List[np.ndarray], float, Dict[str, float]]:
        """Returns (per-object IoU curves in dataset order, cut at the first
        threshold crossing as `evaluate_sample` cuts them, elapsed seconds,
        stats {objects_per_sec, clicks_per_sec})."""
        n = self.cfg.model.num_max_points
        groups: Dict[Tuple[int, int], List[Tuple[int, SessionState]]] = {}
        order = 0
        for index in range(len(dataset)):
            sample = dataset.get_sample(index)
            canvas = self._canvas(*sample.image.shape[:2])
            for obj_id in sample.objects_ids:
                st = init_session(sample.image, sample.gt_mask(obj_id), n,
                                  canvas, self.device)
                groups.setdefault(canvas, []).append((order, st))
                order += 1

        curves: List = [None] * order
        self.clicks = [None] * order
        start = time.time()
        total_clicks = 0
        for items in groups.values():
            for lo in range(0, len(items), self.batch_size):
                chunk = items[lo:lo + self.batch_size]
                pad = self.batch_size - len(chunk)
                states = shard_batch(stack_states(
                    [st for _, st in chunk] + [chunk[-1][1]] * pad),
                    self.mesh)
                final, ious = graphs.click_rounds(
                    self.model, self.cfg, states, max_clicks,
                    torch.Generator().manual_seed(NOISE_SEED))
                pts = final.points
                rows = gather_rows(torch.cat(
                    [ious.float(), pts.reshape(len(pts), -1)], 1),
                    group=data_group(self.mesh)).cpu().numpy()
                ious = rows[:, :max_clicks]
                pts = rows[:, max_clicks:].reshape(len(rows), -1, 3)
                for (idx, _), curve, p in zip(chunk, ious, pts):
                    self.clicks[idx] = p
                    over = np.nonzero(curve[min_clicks - 1:] >= max_iou_thr)[0]
                    k = (over[0] + min_clicks) if len(over) else max_clicks
                    curves[idx] = curve[:k].astype(np.float32)
                    total_clicks += k
        elapsed = time.time() - start
        stats = {"objects_per_sec": order / max(elapsed, 1e-9),
                 "clicks_per_sec": total_clicks / max(elapsed, 1e-9)}
        return curves, elapsed, stats
