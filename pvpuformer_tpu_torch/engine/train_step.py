"""The iterloss training step (pvpuformer_tpu/engine/train_step.py).

Re-derives ISTrainer.batch_forward's iterloss branch
(`isegm/engine/trainer.py:310-491`). Per batch, num_iters rounds (drawn by
the caller); each round
  1. has a prompt type in {0 click, 1 box} (trainer.py:367), drawn on the
     host, so the box work is a Python branch: connected components run
     only on box rounds;
  2. at round 0 synthesizes boxes from the initial error masks without
     touching the points (trainer.py:369-376);
  3. forwards (image ++ detached prev mask) with the PPuE prompts of the
     round's type (`vpu_forward`; JAX traces the type and computes every
     variant, a host int needs only the one it selects), and with the
     batch's `captions` (B, context_length) token ids where it has them
     (caption co-training: the text tower runs inside every round's
     forward, so each round's backward reaches it and frees its graph);
  4. sums NFL * w + Dice * w + 2 * BCE(P2CL, ed mask) * w, w =
     iterloss_weights[round] (trainer.py:399-419), and runs that round's
     backward at once: the gradients accumulate in `.grad`;
  5. prev = sigmoid(instances), detached (trainer.py:427-431);
  6. next click, per-slot ed-mask labels and boxes from the new error masks
     (engine/prompt_sim), all on the device;
  7. optional prev-mask dropout (trainer.py:455-457).

The per-round backward is exactly JAX's `with_grads=True` path: no gradient
crosses rounds (prev, the points and the ed mask are detached), so the
summed per-round gradients equal the gradient of the summed loss, and each
round's graph is freed before the next forward. `TrainConfig.remat` (JAX's
jax.checkpoint per round) is read for the header but has no meaning here.

Every random draw of a step is an argument, made by `_train_noise` from a
CPU `torch.Generator` and moved to the card with a pinned non-blocking copy:
torch cannot reproduce `jax.random`, so a test hands the port JAX's draws.

Data parallelism (`mesh`, parallel/mesh.py): each rank holds its rows of
the global batch. The step draws the global batch's noise (the same draws
on every rank: the same generator seed) and keeps this rank's rows, so W
ranks run what one process runs on the global batch; the prompt types and
num_iters are global, so every rank runs the same rounds and collectives.
The gradients are reduced once per step, after the last round's backward:
"replicated" sums them over the ranks and divides by W in one all-reduce
(`reduce_gradients`), which equals JAX's psum of the global-batch mean;
under FSDP only the last round's backward reduce-scatters (the earlier
rounds accumulate unsharded), and the one all-reduce takes the 0-d leaves
FSDP leaves replicated. The logs, IoUs and valid flags come back for
the global batch, through one more all-reduce.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch

from .. import nn
from ..inference.predictor import BOX_OFFSET, _gumbel, _to_device
from ..models.vpu import VPUConfig, VPUModel
from ..parallel.mesh import (data_group, data_rank, data_size,
                             reduce_gradients, set_grad_sync)
from . import losses as L
from .metrics import iou_at_thresholds
from .optimizer import TrainOptimizer
from .prompt_sim import (get_next_prompts, next_clicks, synth_boxes,
                         update_ed_mask)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Field names match the JAX TrainConfig so that a checkpoint header
    reads back in both packages. `remat` is kept for that and ignored."""
    model: VPUConfig
    max_num_next_clicks: int = 3
    iterloss_weights: Tuple[float, ...] = (1.0, 2.0, 3.0)
    instance_loss_weight: float = 1.0               # NFL
    instance_aux_loss_weight: float = 1.0           # Dice
    instance_aux3_loss_weight: float = 2.0          # P2CL BCE
    nfl_alpha: float = 0.5
    nfl_gamma: float = 2.0
    pred_thresh: float = 0.49
    use_random_clicks: bool = True
    use_iterloss: bool = True                       # False = RITM iter-mask
    pclout: bool = False
    as_allmask: bool = False
    prev_mask_drop_prob: float = 0.0
    remat: bool = True


def _train_noise(cfg: TrainConfig, gen: torch.Generator, b: int, h: int,
                 w: int, num_iters: int) -> Dict[str, Any]:
    """Every random draw of one step, on the host from `gen`:
      "prompt_types": num_iters ints in {0, 1} (a Python list);
      "gumbel": (G, B, H, W) Gumbel noise of the next-click draws, one per
        click round (num_iters - 1 on the iterloss path, num_iters on the
        itermask path);
      "init_gumbel": (B, H, W), only without `use_random_clicks`;
      "box_offsets": (num_iters, B, 4) int32 box jitter, round k's boxes
        (in [-10, 0], [0, 10], [-10, 0], [0, 10]);
      "drop_u": (num_iters - 1, B) uniforms of the prev-mask dropout."""
    clicks = num_iters if not cfg.use_iterloss else num_iters - 1
    noise = {"prompt_types": torch.randint(0, 2, (num_iters,),
                                           generator=gen).tolist()}
    noise["gumbel"] = _gumbel((clicks, b, h, w), gen)
    if not cfg.use_random_clicks:
        noise["init_gumbel"] = _gumbel((b, h, w), gen)
    neg = torch.tensor([BOX_OFFSET, 0, BOX_OFFSET, 0])
    noise["box_offsets"] = (torch.randint(0, BOX_OFFSET + 1,
                                          (num_iters, b, 4), generator=gen)
                            - neg).int()
    noise["drop_u"] = torch.rand((max(num_iters - 1, 0), b), generator=gen)
    return noise


# the batch axis of each draw of `_train_noise`
_NOISE_BATCH_AXIS = {"gumbel": 1, "init_gumbel": 0, "box_offsets": 1,
                     "drop_u": 1}


def _step_noise(cfg: TrainConfig, gen: torch.Generator, b: int, h: int,
                w: int, num_iters: int, mesh) -> Dict[str, Any]:
    """This rank's draws: `_train_noise` at the global batch (b rows per
    rank), rows [rank * b, (rank + 1) * b) of each; the prompt types are
    global. The host's draw grows with the number of ranks."""
    n = data_size(mesh)
    noise = _train_noise(cfg, gen, b * n, h, w, num_iters)
    if n == 1:
        return noise
    lo = data_rank(mesh) * b
    return {k: v if k == "prompt_types"
            else v.narrow(_NOISE_BATCH_AXIS[k], lo, b)
            for k, v in noise.items()}


def _noise_on(noise: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
    return {k: v if isinstance(v, list) else _to_device(v, device)
            for k, v in noise.items()}


def _round_losses(cfg: TrainConfig, out: Dict[str, torch.Tensor],
                  gt: torch.Tensor, ed_mask: torch.Tensor, w: float,
                  logs: Dict[str, torch.Tensor], k: int) -> torch.Tensor:
    """The three configured losses of one round (trainer.py:399-419); the
    logs get detached 0-d tensors."""
    nfl_v, nfl_aux = L.normalized_focal_loss(
        out["instances"], gt, alpha=cfg.nfl_alpha, gamma=cfg.nfl_gamma,
        with_aux=True)
    nfl = nfl_v.mean()
    logs[f"instance_loss_{k}_{int(w)}"] = nfl.detach()
    valid = nfl_aux["no_ignore"]
    logs[f"nfl_mult_mean_{k}"] = (
        torch.where(valid, nfl_aux["sample_mult"], 0.0).sum()
        / valid.sum().clamp_min(1)).detach()
    logs[f"nfl_beta_pmax_{k}"] = nfl_aux["beta_pmax"].mean().detach()
    total = cfg.instance_loss_weight * nfl * w

    dice = L.dice_loss(out["instances"], gt, use_sigmoid=True,
                       naive_dice=True).mean()
    logs[f"instance_aux_loss_{k}_{int(w)}"] = dice.detach()
    total = total + cfg.instance_aux_loss_weight * dice * w

    if cfg.instance_aux3_loss_weight > 0 and \
            out.get("instances_aux") is not None:
        bce = L.sigmoid_bce_loss(out["instances_aux"], ed_mask.float(),
                                 from_sigmoid=True).mean()
        logs[f"instance_aux3_loss_{k}_{int(w)}"] = bce.detach()
        total = total + cfg.instance_aux3_loss_weight * bce * w
    return total


def _iterloss_loop(p: VPUModel, cfg: TrainConfig,
                   batch: Dict[str, torch.Tensor], noise: Dict[str, Any],
                   num_iters: int, with_grads: bool):
    """The round loop. with_grads=False: (total, aux), one joint graph.
    with_grads=True: each round runs its own backward into `.grad` and the
    returned total is detached."""
    image = batch["image"]
    captions = batch.get("captions")
    gt = batch["instances"].float()
    points = batch["points"].float()
    scribbles = batch["scribbles"].float()
    rects = batch["scribble_rects"].float()
    b, h, w, _ = image.shape
    n = points.shape[1] // 2
    dev = image.device

    gtm = gt[..., 0] > 0.5
    # ed_mask_label init: first N slots = gt, last N = ~gt (trainer.py:329-331)
    ed_mask = torch.cat([gtm[..., None].expand(b, h, w, n),
                         (~gtm)[..., None].expand(b, h, w, n)], -1)
    prev = torch.zeros((b, h, w, 1), device=dev)

    if not cfg.use_random_clicks:
        # trainer.py:333-338: discard the sampler's clicks, take one click
        # from the error mask of the empty prediction
        points = torch.full_like(points, -1.0)
        points, _ = next_clicks(prev[..., 0], gt[..., 0], points,
                                noise["init_gumbel"],
                                pred_thresh=cfg.pred_thresh)

    if not cfg.use_iterloss:
        return _itermask_forward(p, cfg, image, gt, points, prev, noise,
                                 num_iters)

    types = noise["prompt_types"]
    no_boxes = torch.zeros((b, 5), dtype=torch.int32, device=dev)
    scr = (scribbles[:, None], rects[:, None])
    total = torch.zeros((), device=dev)
    logs: Dict[str, torch.Tensor] = {}
    prompt_type = types[0]
    boxes = no_boxes
    if prompt_type == 1:
        # boxes from the initial error masks; points / ed mask untouched
        boxes = get_next_prompts(prev[..., 0], gt[..., 0], points, ed_mask,
                                 None, noise["box_offsets"][0],
                                 pred_thresh=cfg.pred_thresh,
                                 as_allmask=cfg.as_allmask,
                                 update_points=False)[1]
    for k in range(num_iters):
        net_input = torch.cat([image, prev.to(image.dtype)], -1)
        out = p(net_input, points, boxes.float(), scr, prompt_type,
                cfg=cfg.model, captions=captions)
        round_total = _round_losses(cfg, out, gt, ed_mask,
                                    cfg.iterloss_weights[k], logs, k)
        instances = out["instances"].detach()
        del out
        if with_grads:
            # FSDP reduce-scatters after the step's last backward only
            set_grad_sync(p, k == num_iters - 1)
            round_total.backward()          # frees this round's graph
            round_total = round_total.detach()
        total = total + round_total

        prev = instances.float() if cfg.pclout else \
            torch.sigmoid(instances.float())

        if k < num_iters - 1:
            next_type = types[k + 1]
            new_points, info = next_clicks(prev[..., 0], gt[..., 0], points,
                                           noise["gumbel"][k],
                                           pred_thresh=cfg.pred_thresh)
            boxes = no_boxes
            if next_type == 1:
                boxes = synth_boxes(gt[..., 0], info.fn_mask, info.fp_mask,
                                    points, noise["box_offsets"][k + 1],
                                    as_allmask=cfg.as_allmask)
            points = new_points
            ed_mask = update_ed_mask(ed_mask, info)
            prompt_type = next_type
            if cfg.prev_mask_drop_prob > 0:
                keep = noise["drop_u"][k] >= cfg.prev_mask_drop_prob
                prev = prev * keep[:, None, None, None]

    logs["loss"] = total.detach()
    return total, {"logs": logs, "final_instances": instances,
                   "points": points}


def _itermask_forward(p: VPUModel, cfg: TrainConfig, image, gt, points,
                      prev, noise, num_iters: int):
    """RITM iter-mask branch (trainer.py:459-491): num_iters click rounds
    without gradients, then one supervised forward on the final state;
    loss = NFL + Dice. Captions are not read here, as in JAX
    (train_step.py:307-318 forwards without them)."""
    for i in range(num_iters):
        with torch.no_grad():
            net_input = torch.cat([image, prev.to(image.dtype)], -1)
            out = p(net_input, points, cfg=cfg.model)
            prev = torch.sigmoid(out["instances"].float())
            points, _ = next_clicks(prev[..., 0], gt[..., 0], points,
                                    noise["gumbel"][i],
                                    pred_thresh=cfg.pred_thresh)
    net_input = torch.cat([image, prev.to(image.dtype)], -1)
    out = p(net_input, points, cfg=cfg.model)
    nfl = L.normalized_focal_loss(out["instances"], gt, alpha=cfg.nfl_alpha,
                                  gamma=cfg.nfl_gamma).mean()
    dice = L.dice_loss(out["instances"], gt, use_sigmoid=True,
                       naive_dice=True).mean()
    total = cfg.instance_loss_weight * nfl + \
        cfg.instance_aux_loss_weight * dice
    logs = {"instance_loss": nfl.detach(), "instance_aux_loss": dice.detach(),
            "loss": total.detach()}
    return total, {"logs": logs, "final_instances": out["instances"].detach(),
                   "points": points}


def _place(batch: Dict[str, Any], device: torch.device
           ) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays or tensors on `device`."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v)) \
            if isinstance(v, np.ndarray) else v
        out[k] = _to_device(t, device) if t.device.type == "cpu" \
            else t.to(device)
    return out


def iterloss_forward(p: VPUModel, cfg: TrainConfig,
                     batch: Dict[str, torch.Tensor], noise: Dict[str, Any],
                     num_iters: int):
    """Loss + aux of one batch as one differentiable graph (no backward
    inside). batch: image (B, H, W, 3) in [0, 1], instances (B, H, W, 1),
    points (B, 2N, 3), scribbles (B, S, 2), scribble_rects (B, 4), and
    optionally captions (B, context_length) int token ids, on the model's
    device; `noise` from `_train_noise` on that device."""
    return _iterloss_loop(p, cfg, batch, noise, num_iters, with_grads=False)


def _global_results(logs: Dict[str, torch.Tensor], ious: torch.Tensor,
                    valid: torch.Tensor, mesh):
    """This rank's logs (means over its rows), metric IoUs (3, b) and valid
    flags (b,) -> the global batch's: the logs' mean over the ranks, the
    (3, W b) IoUs and (W b,) flags in rank order. One all-reduce of one
    buffer in which each rank wrote its share (zeros elsewhere)."""
    n = data_size(mesh)
    if n == 1:
        return logs, ious, valid
    keys = list(logs)
    b = valid.shape[0]
    lo = data_rank(mesh) * b
    buf = torch.zeros(len(keys) + 4 * n * b, device=ious.device)
    buf[:len(keys)] = torch.stack([logs[k].float() for k in keys]) / n
    rows = buf[len(keys):].view(4, n * b)
    rows[:3, lo:lo + b] = ious
    rows[3, lo:lo + b] = valid.float()
    torch.distributed.all_reduce(buf, group=data_group(mesh))
    return ({k: buf[i] for i, k in enumerate(keys)}, rows[:3],
            rows[3] > 0.5)


def train_step(p: VPUModel, tx: TrainOptimizer, batch: Dict[str, Any],
               gen: torch.Generator, metric_thresholds: torch.Tensor, *,
               cfg: TrainConfig, num_iters: int, device=None, mesh=None):
    """One optimization step, in place on `p` and `tx`. `gen` (a CPU
    `torch.Generator`, seeded alike on every rank) makes the step's random
    draws; `device` None means the card (and raises without one). With a
    `mesh` (parallel/mesh.make_mesh), `batch` holds this rank's rows of the
    global batch and `p` is placed by `shard_params`. Returns (logs, metric
    ious (3, B), metric valid (B,)) of the global batch, all on the device:
    nothing here syncs the host."""
    dev = nn.resolve_device(device)
    batch = _place(batch, dev)
    b, h, w, _ = batch["image"].shape
    noise = _noise_on(_step_noise(cfg, gen, b, h, w, num_iters, mesh), dev)
    loss, aux = _iterloss_loop(p, cfg, batch, noise, num_iters,
                               with_grads=cfg.use_iterloss)
    if not cfg.use_iterloss:
        set_grad_sync(p, True)
        loss.backward()
    reduce_gradients(tx.params, mesh)
    tx.step()
    ious, valid = iou_at_thresholds(aux["final_instances"],
                                    batch["instances"].float(),
                                    metric_thresholds)
    return _global_results(aux["logs"], ious, valid, mesh)


@torch.no_grad()
def eval_step(p: VPUModel, batch: Dict[str, Any], gen: torch.Generator,
              metric_thresholds: torch.Tensor, *, cfg: TrainConfig,
              num_iters: int, device=None, mesh=None):
    """Validation: the same rounds, no gradient, no update
    (trainer.py:266-298). Returns (logs, ious, valid) of the global batch;
    `mesh` as in `train_step`."""
    dev = nn.resolve_device(device)
    batch = _place(batch, dev)
    b, h, w, _ = batch["image"].shape
    noise = _noise_on(_step_noise(cfg, gen, b, h, w, num_iters, mesh), dev)
    _, aux = iterloss_forward(p, cfg, batch, noise, num_iters)
    ious, valid = iou_at_thresholds(aux["final_instances"],
                                    batch["instances"].float(),
                                    metric_thresholds)
    return _global_results(aux["logs"], ious, valid, mesh)
