"""Readings of the comparison that decides `correct`, for the program as
the configuration states it and for its control, over many seeds in one
process, at the cell's own size and load.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 \
        [--seconds 4] [--sides program int8]

Sides: "program" (as the configuration states it, bf16) and "int8", the
control: the program's own path one step below bf16, `Predictor(int8=True)`
/ `BatchedEvaluator(int8=True)` (int8 weights and activations in the
linears' products, bf16 elsewhere). Each seed is one driver run (weights,
traffic, a short window, the check); prints one JSON line per seed and
side with every compared number, and the least and largest over the
seeds. The limits in limits/<cell>.json lie between the program's largest
reading and the control's smallest.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import check, harness, run  # noqa: E402

SIDES = ("program", "int8")


def readings(cell: str, seed: int, seconds: float, side: str, device,
             root: Path = ROOT) -> dict:
    """One run's aggregated readings: {name: value} plus "correct"."""
    args = run.parse(["--workload", cell, "--seed", str(seed), "--seconds",
                      str(seconds)])
    ctx = run.make_ctx(args, device, root, time.perf_counter(),
                       int8=side == "int8")
    result, checks = harness.load_driver(ctx.cell.mix, root).run(ctx)
    out = {k: v for k, (v, _, _) in checks.items()}
    out["correct"] = result["correct"]
    out["rounds_checked"] = len(ctx.readings)
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--sides", nargs="+", choices=SIDES, default=SIDES)
    a = p.parse_args(argv)
    cell = harness.find_cell(a.workload)
    device = harness.card(cell.chips)
    worst = {}
    for side in a.sides:
        for seed in a.seeds:
            r = readings(a.workload, seed, a.seconds, side, device)
            print(json.dumps({"cell": a.workload, "side": side,
                              "seed": seed, **r}), flush=True)
            w = worst.setdefault(side, {})
            for k, v in r.items():
                if k in check.AGGREGATE or k == "redrive_off":
                    w[k] = [min(w.get(k, [v, v])[0], v),
                            max(w.get(k, [v, v])[1], v)]
    print(json.dumps({"cell": a.workload, "min_max": worst}), flush=True)


if __name__ == "__main__":
    main()
