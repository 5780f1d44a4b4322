"""Optimizers: Adam / AdamW / SGD with MultiStepLR, per-parameter lr
multipliers, BEiT layer-wise lr decay and gradient accumulation
(pvpuformer_tpu/engine/optimizer.py), on `torch.optim`.

The JAX package builds an optax chain; here the same update is a torch
optimizer with one param group per distinct (lr scale, weight decay):
  * torch Adam's weight decay is L2 added to the gradient BEFORE the
    moments: the chain's `add_decayed_weights` + `scale_by_adam` (not
    AdamW's decoupled decay; "adamw" only decays every leaf when layer-wise
    decay is off, as in JAX);
  * the BEiT layer-wise scales (layer_decay^(depth + 1 - layer_id) over the
    backbone) and `lr_mult` become each group's lr factor;
  * `decay_mask` (>= 2-D backbone / neck / head parameters) sets the
    groups' `weight_decay`;
  * `multistep_lr` is a function of the number of optimizer updates, as
    optax's `scale_by_schedule` counts them;
  * `with_grad_accumulation` averages the gradients of `every` steps with
    `optax.MultiSteps`' running mean and leaves the parameters unchanged in
    between.
A parameter that got no gradient (one the forward does not use) gets a zero
gradient, as in JAX, so weight decay and the moments still apply to it.
Under FSDP the parameters and the moments are `DTensor` shards, and under
tensor parallelism a split block's leaves and their moments are each model
rank's part (the parameter's `tp_cut`): the state is written and read as
whole tensors in JAX's layout, so a checkpoint made on W ranks loads on one
process and the other way round.
"""
from __future__ import annotations

import re
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from ..parallel.mesh import full_tensor, placed_like


def _cut(p: torch.Tensor):
    """The parameter's cut over the mesh's "model" axis, if any."""
    return getattr(p, "tp_cut", None)


def multistep_lr(base_lr: float, milestones: Sequence[int], gamma: float,
                 steps_per_epoch: int) -> Callable[[int], float]:
    """torch MultiStepLR as a function of the update count."""
    boundaries = sorted(int(m) * steps_per_epoch for m in milestones)

    def schedule(count: int) -> float:
        lr = base_lr
        for b in boundaries:
            if count >= b:
                lr = lr * gamma
        return lr

    return schedule


def vit_layer_id(path: str, depth: int) -> int:
    """BEiT layer id of a backbone parameter name (lr_decay.py:76-85)."""
    if re.match(r"^(pos_embed|cls_token|patch_embed)", path):
        return 0
    m = re.match(r"^blocks\.(\d+)", path)
    if m:
        return int(m.group(1)) + 1
    return depth + 1


def layerwise_scales(model: torch.nn.Module, depth: int,
                     layer_decay: float = 0.75) -> Dict[str, float]:
    """Per-parameter lr scale: layer_decay^(depth + 1 - layer_id) on the
    backbone, 1.0 elsewhere (lr_decay.py:22-23)."""
    out = {}
    for name, _ in model.named_parameters():
        if name.startswith("backbone."):
            lid = vit_layer_id(name[len("backbone."):], depth)
            out[name] = layer_decay ** (depth + 1 - lid)
        else:
            out[name] = 1.0
    return out


def decay_mask(model: torch.nn.Module) -> Dict[str, bool]:
    """Weight decay on >= 2-D backbone / neck / head parameters, none on 1-D
    ones (norms, biases) (lr_decay.py:29-35, extended model-wide)."""
    return {name: name.startswith(("backbone.", "neck.", "head."))
            and p.ndim >= 2 for name, p in model.named_parameters()}


class TrainOptimizer:
    """A torch optimizer with the learning-rate schedule and gradient
    accumulation of the JAX chain; each param group carries its lr factor
    as "lr_scale". Call `step()` once per training step, after the step's
    gradients are in `.grad`; it clears them. A parameter replaced after
    construction (FSDP's `fully_shard` does so) is swapped in by
    `rebind`."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 schedule: Callable[[int], float], every: int = 1):
        self.optimizer = optimizer
        self.schedule = schedule
        self.every = max(int(every), 1)
        self.updates = 0              # optimizer updates applied
        self.mini_step = 0            # gradients accumulated since the last
        self.params = [p for g in optimizer.param_groups for p in g["params"]]
        self._acc = None

    def rebind(self, swap: Dict[int, torch.Tensor]) -> None:
        """Swap parameters: `swap` maps id(old parameter) to its new object
        (the optimizer must hold no state yet)."""
        if self.optimizer.state or self._acc is not None:
            raise RuntimeError("rebind an optimizer before its first step")
        for g in self.optimizer.param_groups:
            g["params"] = [swap.get(id(p), p) for p in g["params"]]
        self.params = [swap.get(id(p), p) for p in self.params]

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> bool:
        """Apply (or accumulate) the gradients; True when the parameters
        changed."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.every > 1:
            if self._acc is None:
                self._acc = [torch.zeros_like(p) for p in self.params]
            n = self.mini_step
            for a, p in zip(self._acc, self.params):
                a.add_((p.grad - a) / (n + 1))          # MultiSteps' mean
            if n < self.every - 1:
                self.mini_step += 1
                self.zero_grad()
                return False
            for a, p in zip(self._acc, self.params):
                p.grad = a                  # the mean replaces the gradient
            self._acc = None
            self.mini_step = 0
        lr = self.schedule(self.updates)
        for g in self.optimizer.param_groups:
            g["lr"] = lr * g["lr_scale"]
        self.optimizer.step()
        self.updates += 1
        self.zero_grad()
        return True

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The state as a flat {name: whole tensor} (checkpoint leaves; under
        FSDP a collective: call it on every rank)."""
        out = {"updates": torch.tensor(self.updates),
               "mini_step": torch.tensor(self.mini_step)}
        index = {id(p): i for i, p in enumerate(self.params)}
        for p, st in self.optimizer.state.items():
            for k, v in st.items():
                out[f"state/{index[id(p)]}/{k}"] = full_tensor(
                    torch.as_tensor(v), _cut(p))
        if self._acc is not None:
            for i, (a, p) in enumerate(zip(self._acc, self.params)):
                out[f"acc/{i}"] = full_tensor(a, _cut(p))
        return out

    def load_state_dict(self, flat: Dict[str, torch.Tensor]) -> None:
        self.updates = int(flat["updates"])
        self.mini_step = int(flat["mini_step"])
        self.optimizer.state.clear()
        for name, v in flat.items():
            parts = name.split("/")
            if parts[0] == "state":
                p = self.params[int(parts[1])]
                v = torch.as_tensor(v)
                self.optimizer.state[p][parts[2]] = (
                    v.clone() if parts[2] == "step"
                    else placed_like(v, p, _cut(p)).clone())
        accs = [k for k in flat if k.startswith("acc/")]
        if accs:
            self._acc = [placed_like(flat[f"acc/{i}"], p, _cut(p)).clone()
                         for i, p in enumerate(self.params)]


def make_optimizer(model: torch.nn.Module, opt_name: str = "adam",
                   lr: float = 5e-5,
                   betas: Tuple[float, float] = (0.9, 0.999),
                   eps: float = 1e-8,
                   milestones: Sequence[int] = (),
                   gamma: float = 0.1,
                   steps_per_epoch: int = 1,
                   layerwise_decay: bool = False,
                   layer_decay: float = 0.75,
                   weight_decay: float = 0.02,
                   backbone_depth: Optional[int] = None,
                   lr_mult: Optional[Dict[str, float]] = None,
                   momentum: float = 0.9) -> TrainOptimizer:
    """The training optimizer over every parameter of `model` (which it
    marks as requiring gradients), with JAX `make_optimizer`'s arguments;
    `lr_mult` maps parameter names to lr multipliers (JAX `lr_mult_tree`)."""
    name = opt_name.lower()
    if name not in ("adam", "adamw", "sgd"):
        raise ValueError(f"unknown optimizer {opt_name!r}")
    names = [n for n, _ in model.named_parameters()]
    scales = {n: 1.0 for n in names}
    if layerwise_decay:
        if backbone_depth is None:
            backbone_depth = len(model.backbone.blocks)
        scales = layerwise_scales(model, backbone_depth, layer_decay)
    if lr_mult is not None:
        scales = {n: s * lr_mult.get(n, 1.0) for n, s in scales.items()}
    if layerwise_decay and weight_decay > 0:
        mask = decay_mask(model)
        decay = {n: weight_decay if mask[n] else 0.0 for n in names}
    elif name == "adamw" and weight_decay > 0:
        decay = {n: weight_decay for n in names}
    else:
        decay = {n: 0.0 for n in names}

    groups: Dict[Tuple[float, float], list] = {}
    for n, p in model.named_parameters():
        p.requires_grad_(True)
        groups.setdefault((scales[n], decay[n]), []).append(p)
    # TrainOptimizer sets each group's lr to schedule(updates) * lr_scale
    # before every update
    param_groups = [{"params": ps, "lr": lr * s, "lr_scale": s,
                     "weight_decay": wd} for (s, wd), ps in groups.items()]
    if name == "sgd":
        opt = torch.optim.SGD(param_groups, lr=lr, momentum=momentum)
    else:
        opt = torch.optim.Adam(param_groups, lr=lr, betas=betas, eps=eps)
    schedule = multistep_lr(lr, milestones, gamma, steps_per_epoch)
    return TrainOptimizer(opt, schedule)


def with_grad_accumulation(tx: TrainOptimizer, every: int) -> TrainOptimizer:
    """Gradient accumulation (trainer.py:188-202 `accumulate_grads`): an
    update every `every` steps from the mean of their gradients; the
    schedule counts updates, as the reference steps its scheduler."""
    if every <= 1:
        return tx
    return TrainOptimizer(tx.optimizer, tx.schedule, every)
