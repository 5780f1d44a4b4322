"""Batched NoC evaluation: `BatchedEvaluator.evaluate` over the seed's
dataset, again and again, through the window.

The dataset holds `objects` objects of each image size, one per image, in
the mix's fixed order of sizes; the evaluator groups them by canvas and
runs chunks of `batch` sessions for `clicks` rounds (flip TTA, zoom-in),
each chunk one captured round replayed (inference/graphs.py). A call's
session set-up, chunk padding and host reads all fall in the window, which
closes at the first call end past `--seconds`.

End-to-end: clicks_per_s, the session rounds of every call over the
window, and setup_s. Traced run: one more call traced on the device
alone for the per-layer readers, then a call over a chunk of each canvas
traced with the host's ops to name the idle gaps.
Correctness: one chunk drawn from the seed is driven again round by round
through the same captured round (`graphs.click_rounds`, one click a call);
its curves and clicks must equal the window's, and rounds drawn from the
seed, every session of the batch, are held against the plain reference.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import check, harness, weights
from benchmark.traffic import _data


@dataclasses.dataclass
class Sample:
    image: np.ndarray
    mask: np.ndarray

    @property
    def objects_ids(self) -> List[int]:
        return [1]

    def gt_mask(self, obj_id: int) -> np.ndarray:
        return self.mask


class Dataset:
    """The evaluator's dataset surface (len, get_sample) over objects made
    from the seed; `get_sample` runs inside a span of its own."""

    def __init__(self, mix: dict, seed: int, stream: int,
                 per_size: List[int]):
        self.sizes = [tuple(s["hw"]) for s in mix["sizes"]]
        self.order = _data.schedule(per_size)
        images = [[_data.image(_data.rng(seed, stream, 2, k, j), h, w)
                   for j in range(_data.IMAGES)]
                  for k, (h, w) in enumerate(self.sizes)]
        self.samples = []
        for i, k in enumerate(self.order):
            h, w = self.sizes[k]
            m = _data.object_mask(_data.rng(seed, stream, 1, i), h, w,
                                  mix["object_area"])
            self.samples.append(Sample(images[k][i % _data.IMAGES], m))

    def __len__(self) -> int:
        return len(self.samples)

    def get_sample(self, index: int) -> Sample:
        with harness.span("bench.dataset_read"):
            return self.samples[index]


class Subset:
    """Some of a dataset's objects, as a dataset."""

    def __init__(self, ds: Dataset, index: List[int]):
        self.ds, self.index = ds, index

    def __len__(self) -> int:
        return len(self.index)

    def get_sample(self, i: int) -> Sample:
        return self.ds.get_sample(self.index[i])


def chunks(ds: Dataset, batch: int) -> List[List[int]]:
    """The dataset's object indices chunk by chunk, as the evaluator
    groups them: by canvas in order of first appearance, `batch` at a
    time."""
    groups: Dict[tuple, List[int]] = {}
    for i, s in enumerate(ds.samples):
        groups.setdefault(_data.canvas(*s.mask.shape), []).append(i)
    return [g[lo:lo + batch] for g in groups.values()
            for lo in range(0, len(g), batch)]


def run(ctx):
    """One run of the cell: (the result line's dict, the checks)."""
    cell, dev, clock = ctx.cell, ctx.device, ctx.clock
    mix = cell.mix
    clicks, batch = mix["clicks"], mix["batch"]
    from pvpuformer_tpu_torch.inference import graphs
    from pvpuformer_tpu_torch.inference.batched import BatchedEvaluator
    from pvpuformer_tpu_torch.inference.predictor import (NOISE_SEED,
                                                         PredictorConfig,
                                                         init_session,
                                                         stack_states)
    clock.mark("import program")
    harness.prepare(clock, dev)
    model, specs = harness.build_model(cell.config, ctx.seed, dev)
    clock.mark("weights")
    pcfg = PredictorConfig(model=model.cfg,
                           target_size=tuple(mix["target_size"]),
                           with_flip=mix["with_flip"])
    ev = BatchedEvaluator(model, pcfg, batch_size=batch, device=dev,
                          int8=ctx.int8)
    ds = Dataset(mix, ctx.seed, 0, [s["objects"] for s in mix["sizes"]])
    warm = Dataset(mix, ctx.seed, 1, [1] * len(mix["sizes"]))
    clock.mark("traffic")
    for k in range(len(warm)):                           # each key twice
        ev.evaluate(Subset(warm, [k]), max_clicks=mix["warmup_rounds"])
        ctx.sync()
        clock.mark("warm-up "
                   f"{_data.canvas(*warm.samples[k].mask.shape)} x {batch}")
    counts = dict(graphs.rounds)

    ctx.log(f"before the window: {harness.smi()}")
    t_start = time.perf_counter()
    setup_s = t_start - clock.t0
    calls, rounds, first = 0, 0, None
    call_s = []
    while True:
        t = time.perf_counter()
        curves, _, _ = ev.evaluate(ds, max_clicks=clicks,
                                   max_iou_thr=mix["max_iou_thr"])
        call_s.append(time.perf_counter() - t)
        calls += 1
        rounds += len(ds) * clicks
        if first is None:
            first = ([np.array(c) for c in curves],
                     [np.array(p) for p in ev.clicks])
        if time.perf_counter() - t_start >= ctx.seconds:
            break
    window_s = time.perf_counter() - t_start
    ctx.log(f"after the window: {harness.smi()}")
    peak = ctx.peak()
    grew = {k: graphs.rounds[k] - counts[k] for k in ("eager", "captured")}
    if dev.type == "cuda" and any(grew.values()):
        raise RuntimeError(f"rounds compiled inside the window: {grew}")
    ctx.log(f"{calls} calls of {len(ds)} objects x {clicks} rounds in "
            f"{window_s:.3f} s; s per call {np.round(call_s, 4).tolist()}")

    result = {"correct": False, "attempted": rounds,
              "failed": int(sum(not np.isfinite(c).all() for c in first[0]))}
    per_round = [(*_data.canvas(*ds.samples[c[0]].mask.shape), batch)
                 for c in chunks(ds, batch) for _ in range(clicks)]
    if ctx.trace:
        def one_call(data):
            with harness.span("bench.evaluate"):
                ev.evaluate(data, max_clicks=clicks,
                            max_iou_thr=mix["max_iou_thr"])
        _, tr = harness.traced(lambda: one_call(ds))
        # a chunk of each canvas, traced with the host's ops, names gaps
        firsts = {}
        for c in chunks(ds, batch):
            firsts.setdefault(_data.canvas(*ds.samples[c[0]].mask.shape), c)
        _, named = harness.traced(
            lambda: one_call(Subset(ds, sum(firsts.values(), []))),
            host=True)
        lctx = harness.LayerCtx(cell.config,
                                batch * (2 if mix["with_flip"] else 1),
                                calls * len(per_round), window_s, tr,
                                per_round, float(np.median(call_s)))
        result["metrics"] = harness.per_layer(cell, lctx, ctx.root)
        result["device"] = dict(harness.device_info(dev, 1, peak),
                                busy_s=tr.busy_s, window_s=tr.host_s)
        result["breakdown"] = {"device_ops": tr.top_ops(),
                               "idle_gaps": named.idle_gaps()}
    else:
        result["metrics"] = {
            "clicks_per_s": {"value": rounds / window_s, "unit": "clicks/s"},
            "setup_s": {"value": setup_s, "unit": "s"}}
        result["device"] = harness.device_info(dev, 1, peak)

    # drive one chunk again, one round a call, through the same graph
    t_check = time.perf_counter()
    pick = _data.rng(ctx.seed, 4)
    all_chunks = chunks(ds, batch)
    chunk = all_chunks[int(pick.integers(len(all_chunks)))]
    hw = _data.canvas(*ds.samples[chunk[0]].mask.shape)
    n = model.cfg.num_max_points
    states = stack_states(
        [init_session(ds.samples[j].image, ds.samples[j].mask, n, hw, dev)
         for j in chunk + [chunk[-1]] * (batch - len(chunk))])
    gen = torch.Generator().manual_seed(NOISE_SEED)
    seq = [(states, None)]
    with torch.no_grad():
        for _ in range(clicks):
            states, iou = graphs.click_rounds(ev.model, ev.cfg, states, 1,
                                              gen)
            seq.append((states, iou[:, 0]))
    curves = torch.stack([s[1] for s in seq[1:]], 1).cpu().numpy()
    off = 0
    for row, j in enumerate(chunk):
        w_curve, w_clicks = first[0][j], first[1][j]
        same = (np.array_equal(curves[row, :len(w_curve)], w_curve)
                and np.array_equal(seq[-1][0].points[row].cpu().numpy(),
                                   w_clicks))
        off += not same
    del ev, model
    graphs.clear()
    ctx.empty_cache()
    P = weights.reference_params(specs, ctx.seed, dev,
                                 getattr(torch, cell.config["dtype"]))
    picked = sorted({0, clicks - 1} | set(
        pick.choice(np.arange(1, clicks - 1), mix["check_rounds"] - 2,
                    replace=False).tolist()))
    readings = []
    for r in picked:
        before, after = seq[r][0], seq[r + 1]
        readings += check.compare(
            P, cell.config, check.as_batch(before, False),
            check.as_batch(after[0], False), after[1])[:len(chunk)]
    correct, checks = check.verdict(readings, ctx.limits)
    lim = ctx.limits["redrive_off"]
    checks = dict(redrive_off=(float(off), lim,
                               "sessions whose curve or clicks differ from "
                               "the window's"), **checks)
    result["correct"] = correct and off <= lim
    ctx.log(f"setup split (s): {clock.split()}; setup_s {setup_s:.3f}; "
            f"check {time.perf_counter() - t_check:.3f} s: chunk of "
            f"{len(chunk)} at {hw}, rounds {picked}")
    ctx.readings = readings
    return result, checks
