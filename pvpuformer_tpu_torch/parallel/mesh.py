"""The ("data", "model") mesh and its placements
(pvpuformer_tpu/parallel/mesh.py) on torch.distributed.

The reference trains with NCCL DDP (`isegm/utils/exp.py:29-32`,
`isegm/utils/distributed.py:50-67`); the JAX package puts a `Mesh` and
sharding annotations on its jitted step. Here:
  * `make_mesh` is a `DeviceMesh` over the ranks with axes ("data",
    "model"); without a process group it is None, JAX's one-device mesh:
    nothing to shard;
  * `shard_batch` gives this rank's rows of a global batch: rank p holds
    rows [p * local, (p + 1) * local) (the layout of
    tests/mp_train_worker.py:global_batch_order);
  * `shard_params` broadcasts rank 0's parameters (one coalesced
    collective) and then, in "fsdp" mode, applies FSDP2's `fully_shard` to
    every ViT `Block` and to the model root. Its placement (dim 0 of every
    parameter over "data") differs from JAX's `_fsdp_spec` (the largest dim
    of leaves of at least 2^16 elements); the trajectory is the same.
    FSDP2 takes no 0-d parameter (the head's `logit_scale`): such leaves
    stay replicated beside the shards. "replicated" keeps full copies. The
    training step reduces the gradients of every parameter that FSDP does
    not own once per step (`reduce_gradients`).
Tensor parallelism ("tp", "tp+fsdp", model_parallel > 1) raises: JAX's
column / row split of qkv / fc1 and proj / fc2 (`_tp_spec`) cuts through
the fused LN+MLP kernel, which adds fc2's bias and the residual in its
epilogue. JAX's activation-sharding hints are GSPMD layout hints and have
no counterpart.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional

import torch
import torch.distributed as tdist
from torch import nn as tnn

from . import dist

MODES = ("replicated", "fsdp")
TP_MODES = ("tp", "tp+fsdp")
TP_ITEM = ("tensor parallelism is not ported (ROADMAP.md, Queue 1, "
           "\"Tensor parallelism\": it needs an LN+MLP kernel variant "
           "without fc2's bias and the residual)")


def check_mode(mode: str) -> None:
    """Raise for a parameter mode the port does not run."""
    if mode in TP_MODES:
        raise NotImplementedError(f"param_mode={mode!r}: " + TP_ITEM)
    if mode not in MODES:
        raise ValueError(f"unknown param_mode {mode!r} (one of {MODES})")


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1):
    """A ("data", "model") `DeviceMesh` over the ranks of the default
    process group (n_devices, when given, must be their number), or None
    without a process group (then n_devices may only be None or 1). Its
    device type is "cuda" under NCCL and "cpu" under gloo (which also
    reduces CUDA tensors, through the host)."""
    from torch.distributed.device_mesh import DeviceMesh
    if model_parallel != 1:
        raise NotImplementedError(f"model_parallel={model_parallel}: "
                                  + TP_ITEM)
    if not dist.initialized():
        if n_devices not in (None, 1):
            raise RuntimeError(
                f"a mesh of {n_devices} devices needs a process group of "
                f"{n_devices} ranks: start under torch.distributed.run")
        return None
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"a mesh of {n} devices in a process group of "
                         f"{world} ranks: the mesh spans the whole group")
    device_type = "cuda" if tdist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(n).reshape(n, 1),
                      mesh_dim_names=("data", "model"))


def data_group(mesh):
    return None if mesh is None else mesh.get_group("data")


def data_size(mesh) -> int:
    return 1 if mesh is None else mesh.size(0)


def data_rank(mesh) -> int:
    return 0 if mesh is None else mesh.get_local_rank("data")


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


@torch.no_grad()
def shard_params(model: tnn.Module, mesh, mode: str = "replicated"
                 ) -> tnn.Module:
    """Place the model's parameters on the mesh, in place (the model is
    returned): rank 0's values are broadcast to every rank, then "fsdp"
    shards every ViT `Block` and the root with `fully_shard`, which
    replaces each parameter by a new `DTensor` parameter (an optimizer
    built before must be rebound: `TrainOptimizer.rebind`). With no mesh
    every mode leaves the model as it is."""
    check_mode(mode)
    if mesh is None:
        return model
    group = data_group(mesh)
    if data_size(mesh) > 1:
        src = tdist.get_global_rank(group, 0)
        _coalesced([p.data for p in model.parameters()],
                   lambda flat: tdist.broadcast(flat, src, group=group))
    if mode == "fsdp":
        from torch.distributed.fsdp import fully_shard
        from ..models.vit import Block
        dm = mesh["data"]
        for m in model.modules():
            if isinstance(m, Block):
                fully_shard(m, mesh=dm)
        fully_shard(model, mesh=dm, ignored_params={
            p for p in model.parameters() if p.ndim == 0})
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


def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """The whole tensor behind a `DTensor` (a collective: every rank of its
    mesh calls it in the same order); any other tensor as it is."""
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        return t.full_tensor()
    return t


def placed_like(full, like: torch.Tensor) -> torch.Tensor:
    """A whole tensor (or array) in `like`'s device, dtype and placement:
    for a `DTensor` this rank's shard, cut locally (no collective)."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    full = torch.as_tensor(full).detach().to(like.device, like.dtype)
    if isinstance(like, DTensor):
        return distribute_tensor(full, like.device_mesh, like.placements,
                                 src_data_rank=None)
    return full


def full_state_dict(model: tnn.Module) -> Dict[str, torch.Tensor]:
    """`model.state_dict()` with every `DTensor` gathered whole (a
    collective under FSDP: call it on every rank)."""
    return {k: full_tensor(v).detach()
            for k, v in model.state_dict().items()}


def load_full_state_dict(model: tnn.Module, flat: Dict[str, Any]) -> None:
    """Load whole tensors into a model, sharded or not (strict, as
    `load_state_dict`): each rank keeps its shard of each tensor."""
    own = model.state_dict()
    model.load_state_dict({k: placed_like(v, own[k]) if k in own else v
                           for k, v in flat.items()})
