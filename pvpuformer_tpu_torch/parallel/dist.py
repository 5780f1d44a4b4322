"""Process-group helpers (pvpuformer_tpu/parallel/dist.py, itself the
reference's `isegm/utils/distributed.py:6-47`) over torch.distributed.

Without a process group these are what JAX's are on one process: rank 0,
world size 1, master, a no-op barrier and the identity reduction.
`init` starts the group from torchrun's environment (RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR / MASTER_PORT) with a finite timeout, so that a
broken collective fails instead of hanging.
"""
from __future__ import annotations

import datetime
import os
from typing import Dict, Optional

import torch
import torch.distributed as tdist

TIMEOUT_S = 120.0
_DEVICE = {"type": None}      # the device type `init` placed this rank on


def initialized() -> bool:
    return tdist.is_available() and tdist.is_initialized()


def get_rank(group=None) -> int:
    return tdist.get_rank(group) if initialized() else 0


def get_world_size(group=None) -> int:
    return tdist.get_world_size(group) if initialized() else 1


def is_master() -> bool:
    return get_rank() == 0


def synchronize() -> None:
    """A barrier over the ranks (distributed.py:14-23); a no-op on one
    process."""
    if get_world_size() > 1:
        tdist.barrier()


def init(device=None, backend: Optional[str] = None) -> torch.device:
    """Start the default process group from torchrun's environment and
    return this rank's device: `device` when given, else `cuda:LOCAL_RANK`
    (there is no fallback to the CPU: without a card that raises, as every
    entry point does). The backend is NCCL for a CUDA device and gloo for
    the CPU; `backend` overrides it only for callers that put several ranks
    on one card, which NCCL refuses (gloo reduces CUDA tensors through the
    host)."""
    from ..nn import resolve_device
    if device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.zeros((), device=dev)         # the context, before the mesh
    _DEVICE["type"] = dev.type
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if not initialized():
        kw = {"device_id": dev} if backend == "nccl" else {}
        tdist.init_process_group(
            backend, timeout=datetime.timedelta(seconds=TIMEOUT_S), **kw)
    return dev


def device_type() -> str:
    """Where this rank's tensors live, "cuda" or "cpu": the device type
    `init` returned; without it, "cuda" under NCCL, else "cpu"."""
    if _DEVICE["type"] is not None:
        return _DEVICE["type"]
    return "cuda" if initialized() and tdist.get_backend() == "nccl" \
        else "cpu"


def shutdown() -> None:
    if initialized():
        tdist.destroy_process_group()
    _DEVICE["type"] = None


def reduce_metrics(metrics: Dict[str, float]) -> Dict[str, float]:
    """The mean of a dict of scalars over the ranks (reduce_loss_dict,
    distributed.py:25-47); the identity on one process. Values may be
    floats or 0-d tensors on any device the backend reduces."""
    n = get_world_size()
    if n == 1:
        return dict(metrics)
    keys = sorted(metrics)
    vals = [torch.as_tensor(metrics[k], dtype=torch.float32) for k in keys]
    dev = next((v.device for v in vals if v.device.type != "cpu"),
               torch.device("cpu"))
    buf = torch.stack([v.to(dev).reshape(()) for v in vals])
    tdist.all_reduce(buf)
    return {k: float(v) for k, v in zip(keys, (buf / n).tolist())}


def gather_rows(t: torch.Tensor, group=None) -> torch.Tensor:
    """This rank's equal share of a tensor's rows -> the whole tensor,
    in rank order, on every rank and on t's device, read by no `.cpu()` or
    `.item()` here: each rank writes its rows into a zeroed global buffer
    and one all-reduce sums the buffers (gloo has no all_gather for CUDA
    tensors; this runs on every backend)."""
    n = get_world_size(group)
    if n == 1:
        return t
    r, b = get_rank(group), t.shape[0]
    buf = t.new_zeros((n * b,) + tuple(t.shape[1:]))
    buf[r * b:(r + 1) * b] = t
    tdist.all_reduce(buf, group=group)
    return buf
