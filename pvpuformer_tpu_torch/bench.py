"""The port's north-star benchmark: p50 per-click latency, ViT-B@448, one GPU.

    python -m pvpuformer_tpu_torch.bench [--int8]

The protocol of the JAX package's root `bench.py`, on the card: ViT-B@448
bf16 from `init_vpu` seed 0, its random 448 x 448 image and gt box (rows
96:352, cols 128:320), 20-click oracle sessions with flip TTA. A measured
unit is ten sessions, each restarting from the same `init_session` state
on the card and run by `Predictor.run_clicks`, the shipped path: the
captured click round replayed 20 times (`inference/graphs.py`), one host
read of the session's IoU curve. Two warm-up units (the first captures the
round), then ten measured ones; the value is the median over the measured
units of the unit's host-clock time over its 200 clicks.

`--int8` measures the int8 PTQ serving path (`nn.quantize_params`, as
`Predictor(int8=True)` runs it) and appends `_int8` to the metric's name.

Prints the card's name and power limit, then as its last line one JSON
object {"metric", "value", "unit"}. There is no `vs_baseline`: the root
bench's 5 ms target is a TPU figure, and no card baseline exists yet.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time
from typing import List, Tuple

import numpy as np
import torch

from .inference.predictor import (NOISE_SEED, Predictor, PredictorConfig,
                                  SessionState, init_session)

CLICKS_PER_SESSION = 20
SESSIONS_PER_UNIT = 10
WARMUP = 2
MEASURE = 10


def protocol_sample() -> Tuple[np.ndarray, np.ndarray]:
    """The root bench's image and gt (bench.py:76-80)."""
    rng = np.random.default_rng(0)
    image = (rng.uniform(size=(448, 448, 3)) * 255).astype(np.uint8)
    gt = np.zeros((448, 448), np.float32)
    gt[96:352, 128:320] = 1.0
    return image, gt


def run_unit(pred: Predictor, state0: SessionState,
             sessions: int = SESSIONS_PER_UNIT,
             clicks: int = CLICKS_PER_SESSION) -> np.ndarray:
    """`sessions` oracle sessions of `clicks` rounds, each from `state0`
    (which no round writes) with the prompt draws restarted: the curves
    (sessions, clicks)."""
    curves = []
    for _ in range(sessions):
        pred.state = state0
        pred.gen.manual_seed(NOISE_SEED)
        curves.append(pred.run_clicks(clicks))
    return np.stack(curves)


def measure(pred: Predictor, state0: SessionState,
            sessions: int = SESSIONS_PER_UNIT,
            clicks: int = CLICKS_PER_SESSION, warmup: int = WARMUP,
            units: int = MEASURE) -> Tuple[List[float], np.ndarray]:
    """(ms per click of each measured unit, the last unit's curves)."""
    for _ in range(warmup):
        curves = run_unit(pred, state0, sessions, clicks)
    per_click = []
    for _ in range(units):
        t0 = time.perf_counter()
        curves = run_unit(pred, state0, sessions, clicks)   # host reads
        per_click.append((time.perf_counter() - t0) * 1e3
                         / (sessions * clicks))
    return per_click, curves


def result_line(per_click_ms: List[float], int8: bool) -> str:
    suffix = "_int8" if int8 else ""
    return json.dumps({
        "metric": f"p50_per_click_latency_ms_vitb448_gpu{suffix}",
        "value": float(np.percentile(per_click_ms, 50)),
        "unit": "ms"})


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--int8", action="store_true",
                   help="the int8 PTQ serving path; the metric's name gains "
                        "_int8")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("the benchmark measures the card: no CUDA device "
                         "is available")
    from .models.vpu import init_vpu, vpu_base_config

    dev = torch.device("cuda")
    mcfg = vpu_base_config(dtype=torch.bfloat16)
    model = init_vpu(mcfg, torch.Generator().manual_seed(0), dev)
    pcfg = PredictorConfig(model=mcfg, target_size=(448, 448), with_flip=True)
    pred = Predictor(model, pcfg, device=dev, int8=args.int8)
    image, gt = protocol_sample()
    state0 = init_session(image, gt, mcfg.num_max_points, (448, 448), dev)
    per_click, curves = measure(pred, state0)
    if not (np.isfinite(curves).all() and curves.shape
            == (SESSIONS_PER_UNIT, CLICKS_PER_SESSION)):
        raise SystemExit(f"bad IoU curves {curves}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}; ms per click of each unit: "
          f"{per_click}", flush=True)
    print(result_line(per_click, args.int8), flush=True)


if __name__ == "__main__":
    main()
