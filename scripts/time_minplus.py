"""Time the EDT min-plus kernel of a checkout on one NVIDIA GPU.

    python3 scripts/time_minplus.py [--root DIR]

Imports `pvpuformer_tpu_torch` from DIR (default: this checkout), builds its
kernels into DIR/build/, and at the click path's (896, 448) and the training
path's (28672, 448) shapes, on two inputs -- "squares" (chip_smoke.py phase
3's: squares of seeded integers below 300) and "discs" (the EDT's own input:
pass-1 rows of random discs, both error masks of 1 and 32 images) -- checks
the kernel against `minplus_rows_plain` bit for bit and times it: the
CUDA-event mean of 20 eager calls after 3 warm-ups (with the wrapper's host
cost) and the device time, 20 calls replayed from a CUDA graph between two
events. Prints one JSON line with the card's name and power limit.

To compare two checkouts, run them in one call, in turns (A, B, B, A).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch


def _event_ms(fn, iters=20):
    for _ in range(3):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(fn, iters=20):
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _discs(seed, b, h=448, w=448, n=12):
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    m = np.zeros((b, h, w), bool)
    for i in range(b):
        for _ in range(n):
            cy, cx, rad = r.integers(0, h), r.integers(0, w), r.integers(2, h // 8)
            m[i] |= (yy - cy) ** 2 + (xx - cx) ** 2 <= rad ** 2
    return m


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    root = Path(ap.parse_args().root).resolve()
    if not torch.cuda.is_available():
        print("time_minplus: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(root))
    from pvpuformer_tpu_torch.ops import edt, edt_minplus

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    out = {"root": str(root), "card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip(),
        "times": []}
    for rows in (896, 28672):
        images = rows // (2 * 448)
        inputs = {
            "squares": torch.randint(0, 300, (rows, 448), generator=g)
            .float().square(),
            "discs": edt._pass1(torch.from_numpy(
                _discs(images, 2 * images)), "scan").reshape(rows, 448)}
        for name, f in inputs.items():
            f = f.to(dev)
            call = lambda: edt_minplus.minplus_rows(f)  # noqa: E731
            if not torch.equal(call(), edt_minplus.minplus_rows_plain(f)):
                raise AssertionError(f"{name} ({rows}, 448): not bit-exact")
            out["times"].append({"shape": [rows, 448], "input": name,
                                 "event_ms": _event_ms(call),
                                 "device_ms": _device_ms(call)})
            print(out["times"][-1], file=sys.stderr, flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
