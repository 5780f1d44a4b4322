"""The ("data", "model") mesh and its placements
(pvpuformer_tpu/parallel/mesh.py) on torch.distributed.

The reference trains with NCCL DDP (`isegm/utils/exp.py:29-32`,
`isegm/utils/distributed.py:50-67`); the JAX package puts a `Mesh` and
sharding annotations on its jitted step. Here:
  * `make_mesh(n, model_parallel=M)` is a `DeviceMesh` of shape (W / M, M)
    over the ranks with axes ("data", "model"), JAX's layout: rank d*M + m
    sits at data coordinate d, model coordinate m. Without a process group
    it is None, JAX's one-device mesh: nothing to shard;
  * `shard_batch` gives this rank's rows of a global batch: data rank p
    holds rows [p * local, (p + 1) * local) (the layout of
    tests/mp_train_worker.py:global_batch_order); the ranks of one model
    group hold the same rows;
  * `shard_params` broadcasts rank 0's parameters (one coalesced
    collective) and then places them by mode:
      - "replicated" keeps full copies;
      - "tp" cuts every backbone ViT `Block` over "model" (parallel/tp.py:
        qkv by heads and fc1 by columns, their biases with them; proj and
        fc2 by rows), the leaves that JAX's `_tp_spec` names, with JAX's
        fallback: a half whose heads or hidden width do not divide by M
        stays whole. Every other leaf (the neck, the DMA transformer, the
        head, a text tower) stays replicated;
      - "fsdp" applies FSDP2's `fully_shard` over "data" to every ViT
        `Block` and to the model root. Its placement (dim 0 of every
        parameter over "data") differs from JAX's `_fsdp_spec` (the
        largest dim of leaves of at least 2^16 elements); the trajectory
        is the same. FSDP2 takes no 0-d parameter (the head's
        `logit_scale`): such leaves stay replicated beside the shards;
      - "tp+fsdp" is "tp" and then "fsdp" over "data" on each rank's
        parts. JAX leaves its tensor-parallel leaves unsharded by FSDP;
        this placement shards them too, and the trajectory is the same.
    The training step reduces the gradients of every parameter that FSDP
    does not own once per step over "data" (`reduce_gradients`); the
    block's own collectives make a replicated leaf's gradient the same on
    every model rank.
  * `full_state_dict` / `load_full_state_dict` (and the optimizer's state,
    engine/optimizer.py) read and write whole leaves in JAX's layout,
    gathered over "data" (FSDP) and over "model" (qkv's columns back in
    (3, H, hd) order), so a checkpoint of any placement loads in one
    process and in any other.
JAX's activation-sharding hints (`constrain_acts`, `activation_sharding`)
are GSPMD layout hints and have no counterpart.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional

import torch
import torch.distributed as tdist
from torch import nn as tnn

from . import dist
from .tp import Cut, Split, gather, local_part

MODES = ("replicated", "tp", "fsdp", "tp+fsdp")
# a backbone Block's leaves that tensor parallelism cuts, by the half they
# belong to (JAX `_tp_spec`'s weights, and qkv's and fc1's biases)
TP_LEAVES = {"attn": {"attn.qkv.w": "qkv", "attn.qkv.b": "qkv",
                      "attn.proj.w": "rows"},
             "mlp": {"mlp.fc1.w": "cols", "mlp.fc1.b": "cols",
                     "mlp.fc2.w": "rows"}}


def check_mode(mode: str) -> None:
    """Raise for an unknown parameter mode."""
    if mode not in MODES:
        raise ValueError(f"unknown param_mode {mode!r} (one of {MODES})")


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1):
    """A ("data", "model") `DeviceMesh` of shape (W / M, M) over the ranks
    of the default process group (n_devices, when given, must be their
    number W), M = model_parallel; None without a process group (then
    n_devices may only be None or 1, and M only 1). M must divide W, as
    JAX's assert has it. Its device type is where the ranks' tensors live
    (`dist.device_type`: "cuda" under NCCL, or under gloo when the ranks
    share a card, which gloo reduces through the host)."""
    from torch.distributed.device_mesh import DeviceMesh
    m = int(model_parallel)
    if not dist.initialized():
        if n_devices not in (None, 1) or m != 1:
            raise RuntimeError(
                f"a mesh of {n_devices or m} devices (model_parallel={m}) "
                f"needs a process group of that many ranks: start under "
                f"torch.distributed.run")
        return None
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"a mesh of {n} devices in a process group of "
                         f"{world} ranks: the mesh spans the whole group")
    if m < 1 or n % m:
        raise ValueError(f"model_parallel={m} does not divide the {n} "
                         f"devices of the mesh")
    return DeviceMesh(dist.device_type(), torch.arange(n).reshape(n // m, m),
                      mesh_dim_names=("data", "model"))


def data_group(mesh):
    return None if mesh is None else mesh.get_group("data")


def data_size(mesh) -> int:
    return 1 if mesh is None else mesh.size(0)


def data_rank(mesh) -> int:
    return 0 if mesh is None else mesh.get_local_rank("data")


def model_group(mesh):
    return None if mesh is None else mesh.get_group("model")


def model_size(mesh) -> int:
    return 1 if mesh is None else mesh.size(1)


def model_rank(mesh) -> int:
    return 0 if mesh is None else mesh.get_local_rank("model")


def _rows(x, rank: int, n: int):
    if isinstance(x, dict):
        return {k: _rows(v, rank, n) for k, v in x.items()}
    if isinstance(x, tuple):                      # NamedTuple batches
        return type(x)(*(_rows(v, rank, n) for v in x))
    b = x.shape[0]
    if b % n:
        raise ValueError(f"a batch of {b} rows over {n} ranks")
    return x[rank * (b // n):(rank + 1) * (b // n)]


def shard_batch(batch: Any, mesh) -> Any:
    """This rank's rows of a global batch (a dict, a NamedTuple of
    batch-leading tensors or arrays, or one of them): rank p takes rows
    [p * B / D, (p + 1) * B / D). B must divide by D."""
    if mesh is None:
        return batch
    return _rows(batch, data_rank(mesh), data_size(mesh))


def _coalesced(tensors: List[torch.Tensor], collective) -> None:
    """Run `collective(flat)` once per dtype on the tensors flattened into
    one buffer, and write the result back into them."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        collective(flat)
        off = 0
        for t in ts:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()


def is_sharded(model: tnn.Module) -> bool:
    from torch.distributed.fsdp import FSDPModule
    return isinstance(model, FSDPModule)


def is_split(model: tnn.Module) -> bool:
    """Whether `shard_params` split any block over "model" (its forward
    then runs collectives: every rank of the model group must call it)."""
    from ..models.vit import Block
    return any(isinstance(m, Block) and m.tp is not None
               for m in model.modules())


def _tp_split(model: tnn.Module, mesh) -> None:
    """Cut every backbone ViT `Block` over "model", in place: each split
    leaf keeps this rank's part (its `Parameter` object stays, so an
    optimizer built before still holds it), and the block gets its `tp`
    (`parallel.tp.Split`). JAX's divisibility fallback
    (pvpuformer_tpu/parallel/mesh.py:111-117): the attention half is split
    when the heads divide by M, the MLP half when the hidden width does."""
    from ..models.vit import Block
    size = model_size(mesh)
    if size == 1:
        return
    group, rank = model_group(mesh), model_rank(mesh)
    for name, blk in model.named_modules():
        if not isinstance(blk, Block) or "backbone" not in name:
            continue
        halves = {"attn": blk.num_heads % size == 0,
                  "mlp": blk.mlp.fc1.w.shape[1] % size == 0}
        params = dict(blk.named_parameters())
        for half, leaves in TP_LEAVES.items():
            if not halves[half]:
                continue
            for leaf, kind in leaves.items():
                if leaf in params:          # qkv may have no bias
                    p = params[leaf]
                    p.data = local_part(p.data, kind, rank, size)
        if halves["attn"] or halves["mlp"]:
            blk.tp = Split(group, rank, size, halves["attn"], halves["mlp"])


def _tp_mark(model: tnn.Module) -> None:
    """Set `tp_cut` (`parallel.tp.Cut`) on every parameter that a split
    block holds a part of (after FSDP, on FSDP's parameters)."""
    from ..models.vit import Block
    for blk in model.modules():
        split = blk.tp if isinstance(blk, Block) else None
        if split is None:
            continue
        params = dict(blk.named_parameters())
        for half, leaves in TP_LEAVES.items():
            if getattr(split, half):
                for leaf, kind in leaves.items():
                    if leaf in params:
                        params[leaf].tp_cut = Cut(kind, split.group,
                                                  split.rank, split.size)


def tp_cuts(model: tnn.Module) -> Dict[str, Cut]:
    """{parameter name: its `Cut`} of the leaves cut over "model"."""
    return {n: p.tp_cut for n, p in model.named_parameters()
            if getattr(p, "tp_cut", None) is not None}


@torch.no_grad()
def shard_params(model: tnn.Module, mesh, mode: str = "replicated"
                 ) -> tnn.Module:
    """Place the model's parameters on the mesh, in place (the model is
    returned): rank 0's values are broadcast to every rank, then "tp" and
    "tp+fsdp" cut the backbone's blocks over "model", and "fsdp" and
    "tp+fsdp" shard every ViT `Block` and the root over "data" with
    `fully_shard`, which replaces each parameter by a new `DTensor`
    parameter (an optimizer built before must be rebound:
    `TrainOptimizer.rebind`). With no mesh every mode leaves the model as
    it is."""
    check_mode(mode)
    if mesh is None:
        return model
    if dist.get_world_size() > 1:
        _coalesced([p.data for p in model.parameters()],
                   lambda flat: tdist.broadcast(flat, 0))
    if "tp" in mode:
        _tp_split(model, mesh)
    if "fsdp" in mode:
        from torch.distributed.fsdp import fully_shard
        from ..models.vit import Block
        dm = mesh["data"]
        for m in model.modules():
            if isinstance(m, Block):
                fully_shard(m, mesh=dm)
        fully_shard(model, mesh=dm, ignored_params={
            p for p in model.parameters() if p.ndim == 0})
    _tp_mark(model)
    return model


def set_grad_sync(model: tnn.Module, enabled: bool) -> None:
    """Under FSDP, whether the next backward reduce-scatters the gradients
    (False accumulates them unsharded on each rank); a no-op otherwise."""
    if is_sharded(model):
        model.set_requires_gradient_sync(enabled)


@torch.no_grad()
def reduce_gradients(params: Iterable[torch.Tensor], mesh) -> None:
    """The step's one gradient reduction for the parameters that FSDP does
    not own (all of them when replicated; `DTensor` shards are skipped, FSDP
    reduce-scatters theirs): each gradient summed over the ranks and divided
    by their number, through one all-reduce of the gradients flattened into
    one buffer (per dtype). A parameter with no gradient gets zeros first,
    as `TrainOptimizer.step` would give it, so every rank reduces the same
    buffer."""
    from torch.distributed.tensor import DTensor
    n = data_size(mesh)
    if n == 1:
        return
    grads = []
    for p in params:
        if isinstance(p, DTensor):
            continue
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        grads.append(p.grad)
    group = data_group(mesh)

    def mean(flat):
        tdist.all_reduce(flat, group=group)
        flat.div_(n)
    _coalesced(grads, mean)


def full_tensor(t: torch.Tensor, cut: Optional[Cut] = None
                ) -> torch.Tensor:
    """The whole tensor behind a `DTensor` (a collective: every rank of its
    mesh calls it in the same order) and, for a leaf cut over "model", the
    whole leaf gathered from the model ranks' parts (a collective over the
    model group); any other tensor as it is."""
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        t = t.full_tensor()
    if cut is not None and t.ndim > 0:
        t = gather(t, cut)
    return t


def placed_like(full, like: torch.Tensor, cut: Optional[Cut] = None
                ) -> torch.Tensor:
    """A whole tensor (or array) in `like`'s device, dtype and placement:
    for a leaf cut over "model" this rank's part, and for a `DTensor` this
    rank's shard of it, cut locally (no collective)."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    full = torch.as_tensor(full).detach().to(like.device, like.dtype)
    if cut is not None and full.ndim > 0:
        full = local_part(full, cut.kind, cut.rank, cut.size)
    if isinstance(like, DTensor):
        return distribute_tensor(full, like.device_mesh, like.placements,
                                 src_data_rank=None)
    return full


def full_state_dict(model: tnn.Module) -> Dict[str, torch.Tensor]:
    """`model.state_dict()` with every leaf whole: `DTensor`s gathered over
    "data", the leaves cut over "model" gathered into JAX's layout
    (collectives under FSDP or tensor parallelism: call it on every
    rank)."""
    cuts = tp_cuts(model)
    return {k: full_tensor(v, cuts.get(k)).detach()
            for k, v in model.state_dict().items()}


def load_full_state_dict(model: tnn.Module, flat: Dict[str, Any]) -> None:
    """Load whole tensors into a model, placed or not (strict, as
    `load_state_dict`): each rank keeps its part of each tensor."""
    own = model.state_dict()
    cuts = tp_cuts(model)
    model.load_state_dict({k: placed_like(v, own[k], cuts.get(k))
                           if k in own else v for k, v in flat.items()})
