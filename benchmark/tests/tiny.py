"""A tiny copy of the benchmark for CPU tests: the harness, drivers,
readers and reference as they are, under a temporary root whose
BENCHMARK.json names a tiny f32 VPU configuration and tiny cells of each
traffic driver."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]

TINY = {
    "name": "tiny", "source": "tiny f32 VPU for CPU tests",
    "dtype": "float32",
    "backbone": {"img_size": [64, 64], "patch_size": [16, 16],
                 "embed_dim": 64, "depth": 4, "num_heads": 2,
                 "mlp_ratio": 4.0, "window_pixels": 32},
    "neck": {"out_dims": [16, 32, 48, 64], "hide_dim": 64,
             "two_way": {"depth": 3, "num_heads": 4, "mlp_dim": 64,
                         "attention_downsample_rate": 2, "ln_eps": 1e-05}},
    "head": {"channels": 32, "upsample": "x1"},
    "num_max_points": 6, "norm_radius": 5.0, "reduced": [], "assumed": {}}

CLICK_MIX = {
    "driver": "click_sessions", "clicks": 3, "with_flip": True,
    "target_size": [64, 64],
    "sizes": [{"dataset": "a", "hw": [40, 56], "sessions": 2},
              {"dataset": "b", "hw": [70, 50], "sessions": 1}],
    "object_area": [0.1, 0.4], "warmup_rounds": 2, "trace_sessions": 1}

NOC_MIX = {
    "driver": "noc_batched", "batch": 2, "clicks": 4, "with_flip": True,
    "target_size": [64, 64], "max_iou_thr": 0.9,
    "sizes": [{"dataset": "a", "hw": [40, 56], "objects": 3},
              {"dataset": "b", "hw": [70, 50], "objects": 2}],
    "object_area": [0.1, 0.4], "warmup_rounds": 2, "check_rounds": 3}

LIMITS = {"redrive_off": 0, "click_off": 0, "roi_off": 0, "iou_gap": 0,
          "prob_excess": 1e-4}


def tiny_root(tmp: Path) -> Path:
    """A root holding BENCHMARK.json and benchmark/ with the tiny cells
    `tiny_click` and `tiny_noc` added as new files."""
    shutil.copytree(ROOT / "benchmark", tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (tmp / "benchmark" / "configs" / "tiny.json").write_text(json.dumps(TINY))
    for name, mix in (("tiny_click_mix", CLICK_MIX),
                      ("tiny_noc_mix", NOC_MIX)):
        (tmp / "benchmark" / "traffic" / f"{name}.json").write_text(
            json.dumps(mix))
    bench["configs"].append({"name": "tiny", "source": "tiny",
                             "file": "benchmark/configs/tiny.json",
                             "reduced": [], "why": "CPU tests"})
    for cell, mix in (("tiny_click", "tiny_click_mix"),
                      ("tiny_noc", "tiny_noc_mix")):
        bench["workloads"].append({"name": cell, "config": "tiny",
                                   "traffic": mix, "chips": 1, "why": "test"})
        (tmp / "benchmark" / "limits" / f"{cell}.json").write_text(
            json.dumps(LIMITS))
        kind = "click" if "click" in cell else "noc"
        for m in bench["per_layer"] + bench["end_to_end"]:
            if "workloads" in m and any(kind in w for w in m["workloads"]):
                m["workloads"].append(cell)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


def run_cell(root: Path, cell: str, seed: int = 5, seconds: float = 0.5,
             trace: int = 0):
    """Drive a tiny cell on the CPU through the harness: (result, checks,
    ctx)."""
    import time
    from benchmark import harness, run
    args = run.parse(["--workload", cell, "--seed", str(seed), "--seconds",
                      str(seconds), "--trace", str(trace)])
    ctx = run.make_ctx(args, torch.device("cpu"), root, time.perf_counter())
    driver = harness.load_driver(ctx.cell.mix, root)
    result, checks = driver.run(ctx)
    return result, checks, ctx
