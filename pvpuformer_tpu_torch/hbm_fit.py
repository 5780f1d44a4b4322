"""Device memory of the shipped recipe's training step
(scripts/hbm_fit.py in the port's idiom).

The shipped recipe trains at batch 32 with up to 3 iterloss rounds
(recipes/iSegNet/vpu_base448_cocolvis.py). For each num_iters this runs
one `train_step` of ViT-B at the crop, in bf16, on a synthetic batch and
prints the peak of `torch.cuda.max_memory_allocated`, the bytes the
allocator reserved and the card's total. PyTorch compiles nothing ahead of
time, so the probe runs the step; a variant that raises
`torch.cuda.OutOfMemoryError` is printed as not fitting, with the bytes it
asked for, and the next variant runs.

The port frees each round's graph before the next forward (its per-round
backward), so `TrainConfig.remat` is read and ignored: --remat and
--no-remat run the same program, as each printed line says.

    python -m pvpuformer_tpu_torch.hbm_fit [--batch 32] [--crop 448]
        [--iters 1 2 3] [--no-remat] [--device cpu]

Without --device it runs on the card, and raises where there is none; on
the CPU it runs the steps and measures no device memory.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List

import numpy as np
import torch

from .engine.optimizer import make_optimizer
from .engine.train_step import TrainConfig, train_step
from .models import vpu
from .nn import resolve_device

GIB = 2 ** 30
REMAT_NOTE = ("remat read and ignored: each round's graph is freed before "
              "the next forward, so --remat and --no-remat run the same "
              "program")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--crop", type=int, default=448)
    p.add_argument("--iters", type=int, nargs="+", default=[1, 2, 3])
    p.add_argument("--remat", dest="remat", action="store_true", default=True)
    p.add_argument("--no-remat", dest="remat", action="store_false")
    p.add_argument("--device", default="cuda",
                   help="torch device (default: the card; no fallback)")
    return p


def synthetic_batch(b: int, hw: int, n: int,
                    device) -> Dict[str, torch.Tensor]:
    """The JAX tool's batch, from default_rng(0): uniform bf16 image,
    thresholded uniform instances, 2n uniform points, empty scribbles."""
    rng = np.random.default_rng(0)
    batch = {
        "image": torch.from_numpy(rng.uniform(size=(b, hw, hw, 3))
                                  ).to(torch.bfloat16),
        "instances": torch.from_numpy(
            rng.uniform(size=(b, hw, hw, 1)) > 0.5).float(),
        "points": torch.from_numpy(
            rng.uniform(size=(b, 2 * n, 3)) * hw).float(),
        "scribbles": torch.zeros((b, 64, 2)),
        "scribble_rects": torch.zeros((b, 4)),
    }
    return {k: v.to(device) for k, v in batch.items()}


def main(argv=None) -> List[Dict]:
    """Prints a line per num_iters; returns them as dicts (num_iters, fits,
    step_ms, peak / reserved / total bytes or None, the error line)."""
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"

    b, hw = args.batch, args.crop
    mcfg = vpu.vpu_base_config(crop=(hw, hw), dtype=torch.bfloat16)
    cfg = TrainConfig(model=mcfg, remat=args.remat)
    model = vpu.init_vpu(mcfg, torch.Generator().manual_seed(0), dev)
    tx = make_optimizer(model, "adam", lr=5e-5, milestones=(190, 210),
                        gamma=0.1, steps_per_epoch=10, layerwise_decay=False)
    batch = synthetic_batch(b, hw, mcfg.num_max_points, dev)
    thr = torch.tensor([0.4], device=dev)
    total = torch.cuda.get_device_properties(dev).total_memory if cuda \
        else None

    out = []
    for ni in args.iters:
        head = f"ni={ni} remat={args.remat} b{b}"
        res = {"num_iters": ni, "fits": True, "step_ms": None, "peak": None,
               "reserved": None, "total": total, "error": None}
        if cuda:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        t = time.perf_counter()
        try:
            train_step(model, tx, batch, torch.Generator().manual_seed(1),
                       thr, cfg=cfg, num_iters=ni, device=dev)
            if cuda:
                torch.cuda.synchronize(dev)
        except torch.cuda.OutOfMemoryError as e:
            res["fits"] = False
            res["error"] = str(e).strip().splitlines()[0][:200]
        if not res["fits"]:
            # outside the except block: the exception's frames, which hold
            # the step's tensors, are gone, so their memory can be returned
            tx.zero_grad()
            torch.cuda.empty_cache()
            print(f"{head}: DOES NOT FIT — {res['error']} ({REMAT_NOTE})",
                  flush=True)
            out.append(res)
            continue
        res["step_ms"] = (time.perf_counter() - t) * 1e3
        if cuda:
            res["peak"] = torch.cuda.max_memory_allocated(dev)
            res["reserved"] = torch.cuda.max_memory_reserved(dev)
            mem = (f"peak {res['peak'] / GIB:.2f}G reserved "
                   f"{res['reserved'] / GIB:.2f}G of {total / GIB:.2f}G")
        else:
            mem = "device memory not measured on the CPU"
        print(f"{head}: {mem}, step {res['step_ms']:.1f} ms ({REMAT_NOTE})",
              flush=True)
        out.append(res)
    return out


if __name__ == "__main__":
    main()
