"""Interactive click sessions, one at a time, closed loop: the north star.

A session opens with `Predictor.set_input` (inside the window, outside any
round) and runs `clicks` oracle rounds through `Predictor.next_click`, each
timed on the host from the call to its IoU on the host. Sessions arrive in
the mix's fixed order of image sizes (`_data.schedule`), cycled; the seed
makes the pixels and the objects. The window closes at the first round end
past `--seconds`.

End-to-end: round_p50_ms and round_p95_ms over every round of the window,
and setup_s. Traced run: the same window, then `trace_sessions` more
sessions timed unprofiled, then traced on the device alone for the
per-layer readers, and one more traced with the host's ops to name the
idle gaps.
Correctness: every round of one session of each size, drawn from the seed
among the size's first two sessions, against the plain reference
(benchmark/check.py).
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import check, harness, weights
from benchmark.traffic import _data


class Mix:
    def __init__(self, mix: dict, seed: int):
        self.sizes = [tuple(s["hw"]) for s in mix["sizes"]]
        self.order = _data.schedule([s["sessions"] for s in mix["sizes"]])
        images = [[_data.image(_data.rng(seed, 2, k, j), h, w)
                   for j in range(_data.IMAGES)]
                  for k, (h, w) in enumerate(self.sizes)]
        self.items = []
        for i, k in enumerate(self.order):
            h, w = self.sizes[k]
            m = _data.object_mask(_data.rng(seed, 1, i), h, w,
                                  mix["object_area"])
            self.items.append((images[k][i % _data.IMAGES], m, k))
        pick = _data.rng(seed, 3)
        self.check = set()
        for k in range(len(self.sizes)):
            first = [i for i, kk in enumerate(self.order) if kk == k][:2]
            self.check.add(first[int(pick.integers(len(first)))])

    def __getitem__(self, i: int):
        return self.items[i % len(self.items)]


def _predictor(cell, model, device, int8: bool):
    from pvpuformer_tpu_torch.inference.predictor import (Predictor,
                                                         PredictorConfig)
    mix = cell.mix
    pcfg = PredictorConfig(model=model.cfg,
                           target_size=tuple(mix["target_size"]),
                           with_flip=mix["with_flip"])
    return Predictor(model, pcfg, device=device, int8=int8)


def run(ctx):
    """One run of the cell: (the result line's dict, the checks)."""
    cell, dev, clock = ctx.cell, ctx.device, ctx.clock
    mix = cell.mix
    clicks = mix["clicks"]
    from pvpuformer_tpu_torch.inference import graphs
    clock.mark("import program")
    harness.prepare(clock, dev)
    model, specs = harness.build_model(cell.config, ctx.seed, dev)
    clock.mark("weights")
    pred = _predictor(cell, model, dev, ctx.int8)
    data = Mix(mix, ctx.seed)
    clock.mark("traffic")
    for k in range(len(data.sizes)):                  # each canvas twice
        img, m, _ = data[data.order.index(k)]
        pred.set_input(img, m)
        for _ in range(mix["warmup_rounds"]):
            pred.next_click()
        ctx.sync()
        clock.mark(f"warm-up {tuple(pred.state.gt.shape)}")
    warm = dict(graphs.rounds)

    times: List[float] = []
    ious: List[float] = []
    kept: Dict[int, list] = {}
    i = 0
    ctx.log(f"before the window: {harness.smi()}")
    t_start = time.perf_counter()
    setup_s = t_start - clock.t0
    done = False
    while not done:
        img, m, _ = data[i]
        pred.set_input(img, m)
        states = kept.setdefault(i, [pred.state]) if i in data.check else None
        for _ in range(clicks):
            t = time.perf_counter()
            iou = pred.next_click()
            times.append(time.perf_counter() - t)
            ious.append(iou)
            if states is not None:
                states.append((pred.state, iou))
            if time.perf_counter() - t_start >= ctx.seconds:
                done = True
                break
        i += 1
    window_s = time.perf_counter() - t_start
    ctx.log(f"after the window: {harness.smi()}")
    peak = ctx.peak()
    grew = {k: graphs.rounds[k] - warm[k] for k in ("eager", "captured")}
    if dev.type == "cuda" and any(grew.values()):
        raise RuntimeError(f"rounds compiled inside the window: {grew}")
    t_ms = np.array(times) * 1e3
    ctx.log(f"rounds {len(times)} in {window_s:.3f} s over {i} sessions; "
            f"ms min / p50 / p95 / p99 / max "
            f"{np.percentile(t_ms, [0, 50, 95, 99, 100]).round(4).tolist()}")
    by_size: Dict[int, list] = {}
    for r, t in enumerate(t_ms):
        by_size.setdefault(data[r // clicks][2], []).append(t)
    ctx.log("p50 ms by size: " + ", ".join(
        f"{data.sizes[k]} {np.median(v):.4f} (n {len(v)})"
        for k, v in sorted(by_size.items())))

    result = {"correct": False, "attempted": len(times),
              "failed": int(sum(not np.isfinite(x) for x in ious))}
    if ctx.trace:
        rounds_meta = []

        def sessions(first: int, n: int, meta: list):
            for s in range(first, first + n):
                img, m, _ = data[s]
                with harness.span("bench.session_setup"):
                    pred.set_input(img, m)
                hc, wc = pred.state.gt.shape
                for _ in range(clicks):
                    with harness.span("bench.round"):
                        pred.next_click()
                    meta.append((hc, wc, 1))
        n = mix["trace_sessions"]
        t = time.perf_counter()
        sessions(i, n, [])
        ctx.sync()
        plain_s = time.perf_counter() - t
        _, tr = harness.traced(lambda: sessions(i, n, rounds_meta))
        _, named = harness.traced(lambda: sessions(i + n, 1, []), host=True)
        lctx = harness.LayerCtx(cell.config, 2 if mix["with_flip"] else 1,
                                len(times), window_s, tr, rounds_meta,
                                plain_s)
        result["metrics"] = harness.per_layer(cell, lctx, ctx.root)
        result["device"] = dict(harness.device_info(dev, 1, peak),
                                busy_s=tr.busy_s, window_s=tr.host_s)
        result["breakdown"] = {"device_ops": tr.top_ops(),
                               "idle_gaps": named.idle_gaps()}
    else:
        result["metrics"] = {
            "round_p50_ms": {"value": float(np.percentile(t_ms, 50)),
                             "unit": "ms"},
            "round_p95_ms": {"value": float(np.percentile(t_ms, 95)),
                             "unit": "ms"},
            "setup_s": {"value": setup_s, "unit": "s"}}
        result["device"] = harness.device_info(dev, 1, peak)

    # the program's state goes; the reference runs on what was kept
    del pred, model
    graphs.clear()
    ctx.empty_cache()
    t_check = time.perf_counter()
    P = weights.reference_params(specs, ctx.seed, dev,
                                 getattr(torch, cell.config["dtype"]))
    readings = []
    for seq in kept.values():
        before = seq[0]
        for after, iou in seq[1:]:
            readings += check.compare(
                P, cell.config, check.as_batch(before, True),
                check.as_batch(after, True), torch.tensor([iou]))
            before = after
    correct, checks = check.verdict(readings, ctx.limits)
    result["correct"] = correct
    ctx.log(f"setup split (s): {clock.split()}; setup_s {setup_s:.3f}; "
            f"check {time.perf_counter() - t_check:.3f} s over "
            f"{len(readings)} rounds of {len(kept)} sessions")
    ctx.readings = readings
    return result, checks
