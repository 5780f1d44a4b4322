"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints one line; any failure raises and the exit code is not 0):
  1. environment: a CUDA device is required (no CPU path); the card's name
     and power limit from nvidia-smi; torch's precision flags are left as
     they come (the package pins its own precision);
  2. build: nvcc compiles pvpuformer_tpu_torch/csrc/*.cu into build/kernels/;
  3. kernels vs their plain PyTorch versions on the card, at the ViT-B@448
     click-, prompt- and training-path (batch 32) shapes, the batched
     sessions' shapes at B = 8 (B = 16's are the training shapes), and the
     ViT-L / ViT-H click shapes (head dims 64 and 80, LN+MLP at 1024 ->
     4096 and 1280 -> 5120) (and the CC
     kernels, bit-exact and bit-identical on repeat at iters 1, 2, 8 and 16,
     at every mask of CC_MASKS: a snake and a spiral that need more than 8
     rounds, 50176 components, ragged, empty, full, 1 x W and H x 1 masks,
     a 4096 x 4096 image; one CUDA kernel per call, counted with
     torch.profiler; the min-plus kernel bit-exact, bit-identical on repeat
     and one CUDA kernel per call at the click and training shapes, two
     ragged ones and the widest row, W = 8192, with values up to 2^24 - 1,
     with its device time at the path shapes; and whether torch's
     allow_bf16_reduced_precision_reduction changes a bf16 linear at the
     model's shapes), with the
     error beside its tolerance, the kernel time beside the plain time, the
     bound and, for attention, the time of torch's
     scaled_dot_product_attention, forward or backward (timed only, never
     used) and the kernel's ratio to it, and at the bf16 attention forward
     shapes the device time of kernel and SDPA (20 calls in a CUDA graph)
     beside the CUDA-event time of eager calls, which includes the Python
     wrapper's host cost; the fused attention forward is timed with its
     row-statistics write (as the training path runs it), the backward
     from those statistics (its eager time is its device time: the
     kernel outlasts its wrapper at the training shapes); LN+MLP at the
     click and training rows also bit-identical on repeat, with its device
     time beside that of the unfused chain of PyTorch calls (cuBLAS
     products, timed only), and its bf16 backward at the training rows
     against autograd through the plain version (one bf16 ulp of each
     gradient's largest entry), timed beside it;
  4. model parity: a 5-click f32 session at a tiny config on CUDA (kernels)
     vs on the CPU (plain versions), same port weights: identical clicks,
     IoU within 1e-5;
  5. the main path: ViT-B@448 bf16, seeded random weights, two 20-click
     sessions through `Predictor`, then 3 clicks with attn_impl="flash";
     IoUs finite in [0, 1], click counts, and every kernel's launch count
     equal to the wrapper calls the path makes;
  6. prompt parity: tiny f32 box / scribble sessions, all four (prompt_mode,
     as_multi_prompts) variants with deterministic prompts, CUDA vs the CPU:
     identical clicks, IoU within 1e-5;
  7. the prompt path: ViT-B@448 bf16 box / scribble sessions through
     `Predictor`, 5 clicks for each of the four variants (random prompts):
     IoUs finite in [0, 1] and every kernel's launch count equal to the
     wrapper calls the path makes, counted per variant; one more click of
     each variant and of the click path under torch's sync debug mode, and
     one more captured into a CUDA graph (a capture fails on any host
     sync);
  8. training parity: two f32 `train_step`s of the tiny config (batch 2,
     one step with a box round) on CUDA vs on the CPU, the same draws:
     loss, every gradient and the updated parameters within tolerance;
  9. the training path: ViT-B@448 bf16, the shipped recipe (batch 32, 24
     points, iterloss weights (1, 2, 3), Adam 5e-5), 3 `Trainer` steps with
     num_iters 1, 2 and 3 and at least one box round (an out-of-memory
     error fails the phase; no smaller batch is tried): losses finite,
     parameters changed, every kernel's launches (forward and backward)
     equal to what the drawn prompt types predict; ms per step, peak
     memory, the device-busy share of one more profiled step, and the host
     syncs of one more step under torch's sync debug mode;
 10. evaluation parity: `evaluate_dataset` and `BatchedEvaluator` (B = 2,
     the last chunk padded) on Synthetic(3, (64, 64)), 5 clicks, tiny
     config f32, CUDA vs the CPU: identical clicks, IoU within 1e-5,
     identical NoC lists; on each device batched = sequential;
 11. batched evaluation: ViT-B@448 bf16, seeded random weights, 21
     objects (16 of Synthetic 448 x 448, 5 of 300 x 500: two canvas
     buckets, padded chunks) x 20 clicks, through sequential
     `evaluate_dataset` and `BatchedEvaluator` at B = 8 and 16: objects/s,
     clicks/s, ms per click round and each kernel's launches per round,
     which must be the same for every B (depth fused attention, depth
     LN+MLP, one min-plus); curves finite in [0, 1] of the right length;
     the share of sessions whose clicks equal the sequential run's and the
     max |dIoU| (reported, not gated: bf16 products may round by the
     batch); one `batched_click_step` captured into a CUDA graph; the EDT
     pass-1 forms' times at B = 16's masks;
 12. presets: one 3-click bf16 session each of ViT-L@448 and ViT-H@448,
     random weights, launch counts equal to the wrapper calls;
 13. the training entry point: (a) `python -m pvpuformer_tpu_torch.train`
     on the tiny recipe (--debug --batch-size 8) and `python -m
     pvpuformer_tpu_torch.evaluate` on its checkpoint, each a process on
     the card in a temporary directory: exit codes 0, the experiment
     layout, checkpoint and log written, the NoC table printed; the tiny
     recipe's first 2 steps on CUDA vs the CPU from the same Loader batches
     and draws, losses within 1e-4; (b) the shipped recipe's own Trainer
     (`vpu_base448_cocolvis.build_trainer`) on the synthetic raw source at
     480 x 640, one epoch of 4 steps through `Loader` with 4 thread
     workers, one panel dumped and checkpoints written: the loader's
     records/s alone (threads and processes), ms per step, the share of
     each step's wall time spent waiting for its batch (a second epoch on
     process workers where it exceeds 5%), peak memory, and every kernel's
     launches equal to what the drawn num_iters and prompt types predict;
then one JSON line of kernel summaries, the card's name and power limit,
and, last, {"ok": true, "device": ...}.

    python3 chip_smoke.py --profile

instead runs phases 1-2 and then profiles ViT-B@448 bf16 clicks of the
click path and of the four prompt variants, and batched click rounds at B
= 8 and 16, with torch.profiler (CPU + CUDA activities): device time per
round by kernel group, launches per round, the device busy share under
the profiler, and the host-clock median of unprofiled rounds beside it.

No phase's depth was cut for time: the whole script, the build included,
took about 110 s on an NVIDIA H100 80GB HBM3 at 700 W before phase 13, of
its 1200 s limit.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import os
import subprocess
import sys
import time

import numpy as np

CLICKS = 20
FLASH_CLICKS = 3
PROMPT_CLICKS = 5
# (prompt_mode, as_multi_prompts) -> kernel calls per click at ViT-B@448
# with flip: (cc_labels, component_max, minplus_rows). synth_boxes and
# synth_scribbles each run one connected_regions_mask_batch (one call of
# each CC kernel); the multi-prompt protocol's extra error click adds one
# min-plus call to the oracle click's; the points-rewrite scribble runs one
# connected_regions_mask_batch, the box rewrite none.
PROMPT_VARIANTS = {(1, True): (1, 1, 2), (2, True): (2, 2, 2),
                   (1, False): (0, 0, 1), (2, False): (1, 1, 1)}

# NVIDIA H100 SXM datasheet peaks: dense bf16 tensor
# cores, f32 on the CUDA cores, HBM3 bytes/s
PEAK_BF16 = 989e12
PEAK_CUDA_CORE = 67e12
PEAK_BYTES = 3.35e12
# int32 min / max on the CUDA cores: 64 results per clock per SM on compute
# capability 9.0 (the CUDA C++ Programming Guide's throughput table, against
# 128 f32 FMAs), 132 SMs at the 1.98 GHz boost clock; the CC kernels' work
# is counted at this rate (PEAK_CUDA_CORE / 4)
PEAK_INT32 = 132 * 64 * 1.98e9
# int32 operations per pixel per flood round for a linear scan: the
# separable 3x3 max-pool 4, the mask select 1, on each axis a forward and a
# backward segmented max (max and select each) and their combine 5, the
# final mask 1. The Pallas CostEstimate's 60 is the TPU's log-step doubling.
CC_OPS = 16
CC_ITERS = (1, 2, 8, 16)
# int32 operations per element for the min-plus row pass as a linear lower
# envelope (csrc/edt_minplus.cu): the site's Y = c'^2 + f 1; the hull test
# (two differences of Y, two of the index, two products, one compare) 7, run
# once when the site is pushed and once when it is removed, 14; the column's
# value (c - c')^2 + f 2, and one compare with the next site's value (2 + 1),
# 5. The brute force's 2 W f32 operations per element are the TPU kernel's
# dense form, not the least work.
MINPLUS_OPS = 20


def _log(msg: str) -> None:
    print(msg, flush=True)


def _time_ms(fn, iters: int = 20) -> float:
    import torch
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(fn, iters: int = 20) -> float:
    """Device time per call: `iters` calls captured in one CUDA graph and
    replayed between two CUDA events, so the kernels run back to back with
    no host launch cost between them (which _time_ms includes once a
    kernel is shorter than its Python wrapper)."""
    import torch
    fn()                                   # kernels loaded before capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound(ops: float, rate: float, nbytes: float):
    """The least time (ms) the card could take: the larger of the operations
    over their peak rate and the bytes over the memory rate."""
    t_ops, t_bytes = ops / rate * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _compare(name, kernel_fn, plain_fn, atol, rtol, exact=False):
    """Run a kernel and its plain version on the same inputs; raise on
    disagreement. Returns (max_abs_err, kernel ms, plain ms)."""
    import torch

    def flat(x):                  # a kernel with several outputs
        return torch.cat([t.reshape(-1) for t in x]) \
            if isinstance(x, tuple) else x

    got = flat(kernel_fn())
    torch.cuda.synchronize()
    want = flat(plain_fn())
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {got.shape}/{got.dtype} vs "
                             f"{want.shape}/{want.dtype}")
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (g - w).abs().max().item()
    if exact:
        ok = torch.equal(got, want)
        tol = "bit-exact"
    else:
        ok = bool(((g - w).abs() <= atol + rtol * w.abs()).all())
        tol = f"atol={atol} rtol={rtol}"
    ms, plain_ms = _time_ms(kernel_fn), _time_ms(plain_fn)
    _log(f"  {name}: max_abs_err={err:.3e} ({tol}) {'ok' if ok else 'FAIL'}"
         f"  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return err, ms, plain_ms


def phase_kernels(dev):
    """Phase 3: every kernel vs its plain version at the main-path shapes."""
    import torch
    import torch.nn.functional as F
    from pvpuformer_tpu_torch.ops import attention as fa
    from pvpuformer_tpu_torch.ops import cc, edt_minplus, fused_attention as fu
    from pvpuformer_tpu_torch.ops import fused_mlp
    from pvpuformer_tpu_torch import nn

    g = torch.Generator().manual_seed(0)
    # name -> max error over all cases; the summary shape's times, bound
    # and yardsticks (the JSON line's keys)
    err, times = {}, {}

    def record(name, r, main_shape, bound, library_ms=None, device=None,
               yardstick="SDPA", extra=None):
        err[name] = max(err.get(name, 0.0), r[0])
        _log(f"    bound {bound[0] * 1e3:.2f} us ({bound[1]})"
             + ("" if library_ms is None else
                f"  library (SDPA) {library_ms:.4f} ms, kernel / SDPA "
                f"{r[1] / library_ms:.2f}x"))
        kern_dev, lib_dev = device or (None, None)
        if kern_dev is not None and lib_dev is None:
            _log(f"    device time (CUDA graph): kernel {kern_dev:.4f} ms")
        elif kern_dev is not None:
            _log(f"    device time (CUDA graph): kernel {kern_dev:.4f} ms, "
                 f"{yardstick} {lib_dev:.4f} ms, kernel / {yardstick} "
                 f"{kern_dev / lib_dev:.2f}x")
        if main_shape:
            times[name] = {"ms": r[1], "plain_ms": r[2], "bound_ms": bound[0],
                           "bound_by": bound[1], "library_ms": library_ms,
                           "device_ms": kern_dev,
                           "library_device_ms": lib_dev, **(extra or {})}

    # (B, N, H, D): the click path's window blocks 8 windows x 12 heads,
    # global 2 x 12 heads, in bf16 and f32; the training path's at batch 32
    # (32 x 4 windows, 32 images), bf16, fused attention only (flash is not
    # on that path); the summary line reports times at the click path's
    # global shape in bf16. bf16 limits are ~2-3x each entry's measured
    # error (PERF.md, Findings)
    bf16_atol = {"fused_attention": 5e-3, "flash_attention": 1.5e-2}
    both = (("fused_attention",
             lambda q, k, v: fu.launch_attention_stats(q, k, v, 1.0 / 8.0)[0],
             fu.fused_attention_plain),
            ("flash_attention", fa.flash_attention, fa.flash_attention_plain))
    for label, shape, dts, impls in (
            ("window", (8, 196, 12, 64), (torch.bfloat16, torch.float32),
             both),
            ("global", (2, 784, 12, 64), (torch.bfloat16, torch.float32),
             both),
            ("train window", (128, 196, 12, 64), (torch.bfloat16,), both[:1]),
            ("train global", (32, 784, 12, 64), (torch.bfloat16,), both[:1]),
            # batched sessions, B = 8 (model batch 16; B = 16 gives the
            # training shapes), and the ViT-L / ViT-H click shapes (head
            # dims 64 and 80)
            ("B=8 window", (64, 196, 12, 64), (torch.bfloat16,), both[:1]),
            ("B=8 global", (16, 784, 12, 64), (torch.bfloat16,), both[:1]),
            ("ViT-L window", (8, 196, 16, 64), (torch.bfloat16,), both[:1]),
            ("ViT-L global", (2, 784, 16, 64), (torch.bfloat16,), both[:1]),
            ("ViT-H window", (8, 256, 16, 80), (torch.bfloat16,), both[:1]),
            ("ViT-H global", (2, 1024, 16, 80), (torch.bfloat16,), both[:1])):
        for dt in dts:
            q, k, v = (torch.randn(shape, generator=g).to(dev, dt)
                       for _ in range(3))
            b, n, h, d = shape
            elt = q.element_size()
            bound = _bound(4.0 * b * h * n * n * d,
                           PEAK_BF16 if dt == torch.bfloat16 else
                           PEAK_CUDA_CORE, 4.0 * b * h * n * d * elt)
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            bf16 = dt == torch.bfloat16
            sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, scale=1.0 / 8.0)
            lib_ms = _time_ms(sdpa)
            lib_dev = _device_ms(sdpa) if bf16 else None
            for name, kern, plain in impls:
                tol = (bf16_atol[name], 0.0) if bf16 else (1e-4, 1e-4)
                call = lambda: kern(q, k, v)  # noqa: E731
                r = _compare(f"{name} {label} {tuple(shape)} {dt}", call,
                             lambda: plain(q, k, v, 1.0 / 8.0), *tol)
                record(name, r, label == "global" and bf16, bound, lib_ms,
                       (_device_ms(call) if bf16 else None, lib_dev))
    # the attention backward at the training shapes, batch 32 (window
    # blocks 32 x 4 windows x 12 heads, global blocks 32 x 12 heads), bf16,
    # and at a small shape in f32; the bf16 limit is ~2.5x the error
    # measured on an H100 (3.9e-3), f32 as the forward. The bound counts
    # the five N x N x D products of the function (S, dV, dP, dQ, dK).
    # Kernel and plain version both start from the forward kernel's row
    # statistics, as the training path's backward does
    for label, shape, dt in (("window", (128, 196, 12, 64), torch.bfloat16),
                             ("global", (32, 784, 12, 64), torch.bfloat16),
                             ("small", (2, 100, 3, 32), torch.float32)):
        q, k, v, do = (torch.randn(shape, generator=g).to(dev, dt)
                       for _ in range(4))
        b, n, h, d = shape
        bf16 = dt == torch.bfloat16
        sc = d ** -0.5
        bound = _bound(10.0 * b * h * n * n * d,
                       PEAK_BF16 if bf16 else PEAK_CUDA_CORE,
                       7.0 * b * h * n * d * q.element_size())
        lib_ms = None
        if bf16:
            qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                          for x in (q, k, v))
            ot = F.scaled_dot_product_attention(qt, kt, vt, scale=sc)
            dot = do.transpose(1, 2).contiguous()
            sdpa_bwd = lambda: torch.autograd.grad(  # noqa: E731
                ot, (qt, kt, vt), dot, retain_graph=True)
            lib_ms = _time_ms(sdpa_bwd)
            del ot, sdpa_bwd
        st = fu.launch_attention_stats(q, k, v, sc)[1]
        r = _compare(f"fused_attention_bwd {label} {tuple(shape)} {dt}",
                     lambda: fu.launch_attention_bwd(q, k, v, do, sc, st),
                     lambda: fu.fused_attention_bwd_plain(q, k, v, do, sc, st),
                     *((1e-2, 0.0) if bf16 else (1e-4, 1e-4)))
        record("fused_attention_bwd", r, label == "global", bound, lib_ms)
    # the click path's flip batch (2 masks x 448 rows, both error masks),
    # the training path's next_clicks at batch 32 (2 x 32 x 448 rows), the
    # batched sessions' oracle at B = 8 and 16 (2 x B x 448 rows), edges,
    # and the widest row (MAX_W) with values up to the domain's 2^24 - 1;
    # bit-exact, one CUDA kernel per call; at the two path shapes the device
    # time (20 calls replayed from a CUDA graph). Bound: MINPLUS_OPS per
    # element at the int32 rate or the bytes; beside it, in the log only,
    # the brute force's 2 W f32 operations per element
    paths = ((896, 448), (28672, 448), (7168, 448), (14336, 448))
    for shape in paths + ((74, 53), (64, 1000), (2, 8192)):
        f = (torch.randint(0, 2 ** 24, shape, generator=g).float()
             if shape[1] == 8192 else
             torch.randint(0, 300, shape, generator=g).float().square()).to(dev)
        call = lambda: edt_minplus.minplus_rows(f)  # noqa: E731
        r = _compare(f"minplus_rows {shape}", call,
                     lambda: edt_minplus.minplus_rows_plain(f), 0, 0, exact=True)
        if not torch.equal(call(), call()):
            raise AssertionError(f"minplus_rows {shape}: repeat differs")
        kernels = _cuda_kernels(call)
        _log(f"    CUDA kernels per call (torch.profiler) {kernels}")
        if len(kernels) != 1:
            raise AssertionError(f"minplus_rows {shape}: {len(kernels)} CUDA "
                                 f"kernels per call, not one: {kernels}")
        rows, w = shape
        old = _bound(2.0 * rows * w * w, PEAK_CUDA_CORE, 8.0 * rows * w)
        _log(f"    old bound (brute force, 2 W f32 operations per element) "
             f"{old[0] * 1e3:.2f} us ({old[1]})")
        dev_ms = _device_ms(call) if shape in paths else None
        bound = _bound(MINPLUS_OPS * rows * w, PEAK_INT32, 8.0 * rows * w)
        record("minplus_rows", r, shape == (896, 448), bound,
               device=(dev_ms, None))
        if shape == (28672, 448):
            times["minplus_rows"].update(ms_train=r[1], plain_ms_train=r[2],
                                         device_ms_train=dev_ms,
                                         bound_ms_train=bound[0])
    # operands at the JAX kernel test's scale (weights and biases N(0, 0.05)):
    # the MLP term is then ~3x the residual, so dropping b1, b2, beta or 32
    # rows of a weight breaks the tolerance (PERF.md, Findings)
    # rows: the click path's flip batch (2 x 784 tokens), the training
    # path's batch 32 (32 x 784); the summary reports the click path's.
    # Beside the kernel: its device time and that of the unfused chain of
    # PyTorch calls in bf16 (layer_norm, linear, gelu, linear + residual:
    # cuBLAS products, timed only); at the training rows the backward
    # (`fused_ln_mlp_bwd`, bf16 operands, f32 parameters as the training
    # path has them) against autograd through the plain version, which is
    # also its time's yardstick
    mlp_extra = {}
    # (D, hidden, rows): ViT-B's click, batched B = 8 and training rows,
    # ViT-L's and ViT-H's click rows (2 x 784, 2 x 1024 tokens)
    for d, hid, rows in ((768, 3072, (1568, 16 * 784, 32 * 784)),
                         (1024, 4096, (1568,)), (1280, 5120, (2048,))):
        ln, mlp = nn.Norm(d), nn.Mlp(d, hid)
        with torch.no_grad():
            ln.scale.normal_(1.0, 0.1, generator=g)
            ln.bias.normal_(0.0, 0.1, generator=g)
            for p in mlp.parameters():
                p.normal_(0.0, 0.05, generator=g)
        if d == 768:
            params32 = [t.detach().to(dev) for t in (
                ln.scale, ln.bias, mlp.fc1.w, mlp.fc1.b, mlp.fc2.w, mlp.fc2.b)]
        ln.to(dev, torch.bfloat16)
        mlp.to(dev, torch.bfloat16)
        for m in rows:
            x = torch.randn((m, d), generator=g).to(dev, torch.bfloat16)
            call = lambda: fused_mlp.fused_ln_mlp(x, ln, mlp)  # noqa: E731
            r = _compare(
                f"fused_ln_mlp ({m},{d})->{hid} bf16", call,
                lambda: fused_mlp.fused_ln_mlp_plain(
                    x, ln.scale, ln.bias, mlp.fc1.w, mlp.fc1.b, mlp.fc2.w,
                    mlp.fc2.b, 1e-6), 0.06, 0.05)
            if not torch.equal(call(), call()):
                raise AssertionError("fused_ln_mlp: not bit-identical on "
                                     "repeat")
            chain = lambda: ln_mlp_chain(x, ln, mlp)  # noqa: E731
            dev_ms, chain_ms = _device_ms(call), _device_ms(chain)
            mlp_extra[m, d] = (dev_ms, chain_ms)
            record("fused_ln_mlp", r, (m, d) == (1568, 768),
                   _bound(4.0 * m * d * hid, PEAK_BF16,
                          2.0 * (2 * m * d + 2 * d * hid + hid + d)
                          + 4.0 * 2 * d),
                   device=(dev_ms, chain_ms), yardstick="cuBLAS chain",
                   extra={"chain_device_ms": chain_ms})
            del x
    d = 768
    m = 32 * 784
    x, gy = (torch.randn((m, d), generator=g).to(dev, torch.bfloat16)
             for _ in range(2))
    bwd_ms, recompute_ms = phase_mlp_bwd(x, params32, gy)
    times["fused_ln_mlp"].update(
        device_ms_train=mlp_extra[m, d][0],
        chain_device_ms_train=mlp_extra[m, d][1],
        bwd_ms_train=bwd_ms, recompute_bwd_ms_train=recompute_ms)
    del x, gy
    phase_bf16_reduction(dev, g)
    phase_cc(dev, g, record, times)
    return {name: dict(times[name], max_abs_err=err[name]) for name in err}


def phase_bf16_reduction(dev, g):
    """torch's allow_bf16_reduced_precision_reduction (True by default)
    must not change a bf16 `nn.linear` at the model's shapes, since the
    package does not pin it: its forward and its autograd backward (dx and
    dW, whose reduction runs over the tokens) at the click path's 1568 and
    the training path's 25088 tokens, the ViT-B qkv / proj widths and the
    24 prompt tokens of the neck, each way, bit-identical."""
    import types
    import torch
    from pvpuformer_tpu_torch import nn
    mm = torch.backends.cuda.matmul
    default = mm.allow_bf16_reduced_precision_reduction
    report = {}
    for m, k, n in ((1568, 768, 2304), (1568, 768, 768), (25088, 768, 2304),
                    (25088, 768, 768), (24, 768, 768)):
        x = torch.randn((m, k), generator=g).to(dev, torch.bfloat16)
        lin = nn.Linear(k, n, g=g).to(dev)      # f32 weights, bf16 compute
        dy = torch.randn((m, n), generator=g).to(dev, torch.bfloat16)
        outs = []
        for allow in (default, not default):
            mm.allow_bf16_reduced_precision_reduction = allow
            xx = x.clone().requires_grad_()
            w = lin.w.detach().clone().requires_grad_()
            y = nn.linear(types.SimpleNamespace(w=w, b=lin.b), xx)
            outs.append((y, *torch.autograd.grad(y, (xx, w), dy)))
        mm.allow_bf16_reduced_precision_reduction = default
        report[f"({m},{k})x({k},{n})"] = [
            "same" if torch.equal(a, b) else
            f"{(a.float() - b.float()).abs().max().item():.2e}"
            for a, b in zip(*outs)]
    _log(f"  allow_bf16_reduced_precision_reduction {default} vs "
         f"{not default}, bf16 linear [y, dx, dW]: {json.dumps(report)}")
    if any(v != "same" for row in report.values() for v in row):
        raise AssertionError("allow_bf16_reduced_precision_reduction changes "
                             "a bf16 linear: pin it in nn.linear")


def phase_cc(dev, g, record, times):
    """The CC kernels: bit-exact against their plain versions and
    bit-identical on repeat for every mask of cc_masks() at every iters of
    CC_ITERS; one CUDA kernel per call (torch.profiler); timed at 8 rounds
    at the prompt path's (2, 448, 448) masks (the error / gt masks of the
    flip batch) and the training path's (32, 448, 448), eagerly and as
    device time (20 calls replayed from a CUDA graph), beside the plain
    version and the bound."""
    import torch
    from pvpuformer_tpu_torch.ops import cc
    for label, masks in cc_masks().items():
        mt = torch.from_numpy(masks).to(dev)
        vals = torch.randint(0, 2 ** 20, masks.shape, dtype=torch.int32,
                             generator=g).to(dev)
        for iters in CC_ITERS:
            for fn, plain, args in (
                    (cc.cc_labels, cc.cc_labels_plain, (mt,)),
                    (cc.component_max, cc.component_max_plain, (mt, vals))):
                got = fn(*args, iters)
                again = fn(*args, iters)
                want = plain(*args, iters)
                torch.cuda.synchronize()
                if not (torch.equal(got, want) and torch.equal(got, again)):
                    raise AssertionError(
                        f"{fn.__name__} {label} {tuple(masks.shape)} iters "
                        f"{iters}: not bit-exact against the plain version "
                        f"or not bit-identical on repeat")
                del got, again, want
        _log(f"  cc_labels, component_max {label} {tuple(masks.shape)}: "
             f"bit-exact and bit-identical on repeat at iters {CC_ITERS}")
        if label not in ("path", "train"):
            continue
        px, iters = float(mt.numel()), 8
        for fn, plain, args, nbytes in (
                (cc.cc_labels, cc.cc_labels_plain, (mt,), px * (1 + 4)),
                (cc.component_max, cc.component_max_plain, (mt, vals),
                 px * (1 + 4 + 4))):
            call = lambda: fn(*args, iters)  # noqa: E731
            kernels = _cuda_kernels(call)
            _log(f"  {fn.__name__} {tuple(masks.shape)}: CUDA kernels per "
                 f"call (torch.profiler) {kernels}")
            if len(kernels) != 1:
                raise AssertionError(f"{fn.__name__}: {len(kernels)} CUDA "
                                     f"kernels per call, not one")
            r = _compare(f"{fn.__name__} {label} {tuple(masks.shape)}", call,
                         lambda: plain(*args, iters), 0, 0, exact=True)
            # CC_OPS per pixel per round at the int32 rate; beside it the
            # earlier figure (60 ops at the f32 rate), in the log only
            old = _bound(iters * 60 * px, PEAK_CUDA_CORE, nbytes)
            _log(f"    old bound (60 ops per pixel per round at the f32 "
                 f"rate) {old[0] * 1e3:.2f} us ({old[1]})")
            dev_ms = _device_ms(call)
            bound = _bound(iters * CC_OPS * px, PEAK_INT32, nbytes)
            record(fn.__name__, r, label == "path", bound,
                   device=(dev_ms, None))
            if label == "train":
                times[fn.__name__].update(ms_train=r[1], plain_ms_train=r[2],
                                          device_ms_train=dev_ms,
                                          bound_ms_train=bound[0])


def _cuda_kernels(fn, sessions: int = 3):
    """The names of the CUDA kernels one call of `fn` launches.

    The profiler can lose a session's kernels (a process's first session
    has come back empty on the H100), so each session brackets the call
    with a marker, one fill kernel launched before it and one after, each
    behind a synchronize. The call's kernels are those that start between
    the two markers; a session that lost either marker proves nothing and
    is taken again, at most `sessions` times."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    marker = torch.empty(1, device="cuda")
    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            marker.fill_(0.0)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
            marker.fill_(1.0)
            torch.cuda.synchronize()
        seen = sorted((e.time_range.start, e.name) for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA)
        if (len(seen) >= 2 and seen[0][1] == seen[-1][1]
                and "Fill" in seen[0][1]):
            return [name for _, name in seen[1:-1]]
    raise AssertionError(f"the profiler lost the markers in {sessions} "
                         f"sessions; the last saw {[n for _, n in seen]}")


def ln_mlp_chain(x, ln, mlp):
    """The LN+MLP half as a chain of PyTorch calls in x's dtype (cuBLAS
    products): the yardstick of the fused kernel, never called by the
    port."""
    import torch.nn.functional as F
    y = F.layer_norm(x, (x.shape[-1],), ln.scale, ln.bias, 1e-6)
    h = F.gelu(F.linear(y, mlp.fc1.w.t(), mlp.fc1.b), approximate="tanh")
    return x + F.linear(h, mlp.fc2.w.t(), mlp.fc2.b)


def phase_mlp_bwd(x, params, gy):
    """The bf16 LN+MLP backward at the training rows: `fused_ln_mlp_bwd`
    against autograd through the plain version (the recompute the backward
    ran before), each gradient within one bf16 ulp of its largest entry (as
    tests/test_torch_mlp_bwd.py). Returns both times (ms per call)."""
    import torch
    from pvpuformer_tpu_torch.ops import fused_mlp
    leaves = [t.clone().requires_grad_() for t in (x, *params)]

    def recompute():
        return torch.autograd.grad(
            fused_mlp.fused_ln_mlp_plain(*leaves, 1e-6), leaves, gy)

    got = fused_mlp.fused_ln_mlp_bwd(x, *params, 1e-6, gy)
    want = recompute()
    report = {}
    for name, a, w in zip(("dx", "dscale", "dbias", "dw1", "db1", "dw2",
                           "db2"), got, want):
        mx = float(w.float().abs().max())
        ulp = 2.0 ** (np.floor(np.log2(mx)) - 7) if mx > 0 else 0.0
        err = float((a.float() - w.float()).abs().max())
        report[name] = (round(err / ulp, 3) if ulp else err,
                        round(float((a != w).float().mean()), 5))
        if a.dtype != w.dtype or err > ulp:
            raise AssertionError(f"fused_ln_mlp_bwd {name}: error {err} "
                                 f"above one bf16 ulp of the largest entry")
    del got, want
    ms = _time_ms(lambda: fused_mlp.fused_ln_mlp_bwd(x, *params, 1e-6, gy))
    old_ms = _time_ms(recompute)
    _log(f"  fused_ln_mlp_bwd {tuple(x.shape)} bf16: error in bf16 ulps of "
         f"the largest entry, share of elements that differ: "
         f"{json.dumps(report)} (tol 1 ulp) ok  backward {ms:.4f} ms  "
         f"autograd through the plain version {old_ms:.4f} ms")
    return ms, old_ms


def cc_masks():
    """The CC kernels' test masks, by name (CC_MASKS)."""
    return {name: make() for name, make in CC_MASKS.items()}


def _blobs(seed, b, h, w, n, rad=None):
    """Random discs (like tests/test_engine.py:blobby_mask), radius 2 to
    `rad` (h // 8 by default), each drawn in its bounding box."""
    r = np.random.default_rng(seed)
    m = np.zeros((b, h, w), bool)
    for i in range(b):
        for _ in range(n):
            cy, cx = r.integers(0, h), r.integers(0, w)
            rr = int(r.integers(2, max(3, rad or h // 8)))
            y0, y1 = max(cy - rr, 0), min(cy + rr + 1, h)
            x0, x1 = max(cx - rr, 0), min(cx + rr + 1, w)
            yy, xx = np.mgrid[y0:y1, x0:x1]
            m[i, y0:y1, x0:x1] |= (yy - cy) ** 2 + (xx - cx) ** 2 <= rr ** 2
    return m


def _snake():
    """One component with 10 direction reversals (> 8 flood rounds)."""
    m = np.zeros((1, 40, 40), bool)
    for i in range(0, 40, 4):
        m[0, i, 1:39] = True
        m[0, i:i + 4, 38 if (i // 4) % 2 == 0 else 1] = True
    return m


def _spiral(n):
    """A square spiral one pixel wide with one-pixel gaps, walked inwards
    from the corner: one 8-connected component whose ~n/2 arms cross every
    row and column segment and pass boundary of the kernels' tiling and
    need far more than 16 flood rounds (labels stay partial)."""
    m = np.zeros((1, n, n), bool)
    r = c = d = 0
    steps = ((0, 1), (1, 0), (0, -1), (-1, 0))
    m[0, 0, 0] = True
    while True:
        for _ in range(2):                 # straight on, else turn right
            dr, dc = steps[d]
            r1, c1, r2, c2 = r + dr, c + dc, r + 2 * dr, c + 2 * dc
            if (0 <= r1 < n and 0 <= c1 < n and not m[0, r1, c1]
                    and not (0 <= r2 < n and 0 <= c2 < n and m[0, r2, c2])):
                r, c = r1, c1
                m[0, r, c] = True
                break
            d = (d + 1) % 4
        else:
            return m


def _lines(seed, b, h, w):
    """(b, h, w) masks of one row or one column: runs of random length."""
    r = np.random.default_rng(seed)
    return r.uniform(size=(b, h, w)) < 0.97


def _large():
    """(1, 4096, 4096), above L2 twice over: large discs joined by full
    rows and columns with a few gaps, so runs cross every pass of both
    phases."""
    m = _blobs(5, 1, 4096, 4096, 40, rad=600)
    for a in (7, 1000, 2047, 4095):
        m[0, a, :] = True
        m[0, :, a] = True
    m[0, 1000, 3000:3003] = False
    m[0, 2500:2502, 2047] = False
    return m


# name -> (B, H, W) bool masks: random discs at the prompt path's flip batch
# (2, 448, 448) and the training batch (32, 448, 448); a snake with 10
# reversals; 1345 components; 50176 one-pixel components; a ragged
# (3, 74, 53); an empty mask; a full mask (one run spans each line); a
# 448 x 448 spiral; 1 x W and H x 1 masks (one pass, and many passes at
# 8192); a 4096 x 4096 image
CC_MASKS = {
    "path": lambda: _blobs(0, 2, 448, 448, 12),
    "train": lambda: _blobs(2, 32, 448, 448, 12),
    "snake": _snake,
    "speckles": lambda: _speckles(),
    "dots": lambda: _dots(448),
    "ragged": lambda: _blobs(1, 3, 74, 53, 6),
    "empty": lambda: np.zeros((2, 448, 448), bool),
    "full": lambda: np.ones((2, 448, 448), bool),
    "spiral": lambda: _spiral(448),
    "row": lambda: _lines(3, 3, 1, 448),
    "column": lambda: _lines(4, 3, 448, 1),
    "long row": lambda: _lines(6, 2, 1, 8192),
    "long column": lambda: _lines(7, 2, 8192, 1),
    "large": _large,
}


def _dots(n):
    m = np.zeros((1, n, n), bool)
    m[0, ::2, ::2] = True
    return m


def _speckles():
    m = np.zeros((1, 64, 96), bool)
    m[0, 1:5, 1:5] = True
    m[0, 8::2, 1::2] = True
    return m


def tiny_config():
    from pvpuformer_tpu_torch.models.fpn import NeckConfig
    from pvpuformer_tpu_torch.models.seg_head import HeadConfig
    from pvpuformer_tpu_torch.models.two_way import TwoWayConfig
    from pvpuformer_tpu_torch.models.vit import ViTConfig
    from pvpuformer_tpu_torch.models.vpu import VPUConfig
    return VPUConfig(
        backbone=ViTConfig(img_size=(64, 64), patch_size=(16, 16),
                           embed_dim=64, depth=4, num_heads=2,
                           window_pixels=32),
        neck=NeckConfig(in_dim=64, out_dims=(16, 32, 48, 64), img_size=(64, 64),
                        hide_dim=64, two_way=TwoWayConfig(
                            depth=3, embedding_dim=64, num_heads=4, mlp_dim=64)),
        head=HeadConfig(in_channels=(16, 32, 48, 64), channels=32, d_model=64),
        num_max_points=6)


def phase_parity(dev):
    """Phase 4: tiny f32 session, CUDA kernels vs CPU plain versions."""
    import torch
    from pvpuformer_tpu_torch.inference.predictor import (Predictor,
                                                         PredictorConfig)
    from pvpuformer_tpu_torch.models.vpu import init_vpu

    cfg = PredictorConfig(model=tiny_config(), target_size=(64, 64),
                          min_crop_size=32)
    r = np.random.default_rng(7)
    image = (r.uniform(size=(60, 90, 3)) * 255).astype(np.uint8)
    gt = np.zeros((60, 90), np.float32)
    gt[14:50, 18:46] = 1.0
    out = {}
    for where in ("cpu", dev):
        model = init_vpu(cfg.model, torch.Generator().manual_seed(1), "cpu")
        pred = Predictor(model, cfg, device=where)
        pred.set_input(image, gt)
        out[str(where)] = (pred.run_clicks(5), pred.clicks)
    (iou_c, clk_c), (iou_g, clk_g) = out["cpu"], out[str(dev)]
    err = float(np.abs(iou_c - iou_g).max())
    ok = np.array_equal(clk_c, clk_g) and err <= 1e-5
    _log(f"  tiny f32 5-click session cuda vs cpu: clicks "
         f"{'identical' if np.array_equal(clk_c, clk_g) else 'DIFFER'}, "
         f"max |dIoU|={err:.2e} (tol 1e-5) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"parity: cpu ious {iou_c} clicks {clk_c}\n"
                             f"cuda ious {iou_g} clicks {clk_g}")


def phase_main(dev, card: str):
    """Phase 5: ViT-B@448 bf16 click sessions through the kernels."""
    import torch
    from pvpuformer_tpu_torch.inference.predictor import (Predictor,
                                                         PredictorConfig)
    from pvpuformer_tpu_torch.models.vpu import init_vpu, vpu_base_config
    mcfg = vpu_base_config(dtype=torch.bfloat16)
    model = init_vpu(mcfg, torch.Generator().manual_seed(0), dev)
    pcfg = PredictorConfig(model=mcfg, target_size=(448, 448), with_flip=True)
    rng = np.random.default_rng(0)
    image = (rng.uniform(size=(448, 448, 3)) * 255).astype(np.uint8)
    gt = np.zeros((448, 448), np.float32)
    gt[96:352, 128:320] = 1.0
    pred = Predictor(model, pcfg, device=dev)
    depth = mcfg.backbone.depth
    wrappers = _wrappers()

    def check_session(ious, n):
        if not (np.isfinite(ious).all() and ious.shape == (n,)
                and (ious >= 0).all() and (ious <= 1).all()):
            raise AssertionError(f"bad IoU curve {ious}")
        if int(pred.state.click_count) != n:
            raise AssertionError(f"click_count {int(pred.state.click_count)}")

    for w in wrappers:
        w.launches = 0
    t0 = time.perf_counter()
    pred.set_input(image, gt)
    ious = pred.run_clicks(CLICKS)                 # session 1 (warm-up)
    check_session(ious, CLICKS)
    first_s = time.perf_counter() - t0
    pred.set_input(image, gt)                      # session 2, timed per click
    per_click, ious2 = [], []
    for _ in range(CLICKS):
        t = time.perf_counter()
        ious2.append(pred.next_click())            # float(iou) syncs
        per_click.append((time.perf_counter() - t) * 1e3)
    check_session(np.asarray(ious2), CLICKS)
    counts = {w.__name__: w.launches for w in wrappers}
    clicks = 2 * CLICKS
    want = {"fused_attention": depth * clicks, "flash_attention": 0,
            "minplus_rows": clicks, "fused_ln_mlp": depth * clicks,
            "cc_labels": 0, "component_max": 0}
    flash_pred = Predictor(model, dataclasses.replace(pcfg, model=mcfg.replace(
        backbone=dataclasses.replace(mcfg.backbone, attn_impl="flash"))),
        device=dev)
    flash_pred.set_input(image, gt)
    ious3 = flash_pred.run_clicks(FLASH_CLICKS)
    if not (np.isfinite(ious3).all() and (ious3 >= 0).all()
            and (ious3 <= 1).all()):
        raise AssertionError(f"flash session IoUs {ious3}")
    torch.cuda.synchronize()
    total = {w.__name__: w.launches for w in wrappers}
    want_total = dict(want, flash_attention=depth * FLASH_CLICKS,
                      minplus_rows=clicks + FLASH_CLICKS,
                      fused_ln_mlp=depth * (clicks + FLASH_CLICKS))
    _log(f"  session 1: {CLICKS} clicks in {first_s:.2f} s (incl. warm-up), "
         f"final IoU {ious[-1]:.4f}; session 2 median {np.median(per_click):.3f}"
         f" ms/click ({card}); flash session IoU {ious3[-1]:.4f}")
    _log(f"  launches: {total} expected {want_total}")
    if total != want_total or counts != want:
        raise AssertionError("a kernel was launched a different number of "
                             "times than the main path calls its wrapper")
    return total, model


def _wrappers():
    from pvpuformer_tpu_torch.ops.attention import flash_attention
    from pvpuformer_tpu_torch.ops.cc import cc_labels, component_max
    from pvpuformer_tpu_torch.ops.edt_minplus import minplus_rows
    from pvpuformer_tpu_torch.ops.fused_attention import fused_attention
    from pvpuformer_tpu_torch.ops.fused_mlp import fused_ln_mlp
    return (fused_attention, flash_attention, minplus_rows, fused_ln_mlp,
            cc_labels, component_max)


def phase_prompt_parity(dev):
    """Phase 6: tiny f32 box / scribble sessions, CUDA vs the CPU."""
    import torch
    from pvpuformer_tpu_torch.inference.predictor import (Predictor,
                                                         PredictorConfig)
    from pvpuformer_tpu_torch.models.vpu import init_vpu

    r = np.random.default_rng(7)
    image = (r.uniform(size=(60, 90, 3)) * 255).astype(np.uint8)
    gt = np.zeros((60, 90), np.float32)
    gt[14:50, 18:46] = 1.0
    for mode, multi in PROMPT_VARIANTS:
        cfg = PredictorConfig(model=tiny_config(), target_size=(64, 64),
                              min_crop_size=32, prompt_mode=mode,
                              as_multi_prompts=multi,
                              deterministic_prompts=True)
        out = []
        for where in ("cpu", dev):
            model = init_vpu(cfg.model, torch.Generator().manual_seed(1),
                             "cpu")
            pred = Predictor(model, cfg, device=where)
            pred.set_input(image, gt)
            out.append((pred.run_clicks(5), pred.clicks))
        (iou_c, clk_c), (iou_g, clk_g) = out
        err = float(np.abs(iou_c - iou_g).max())
        same = np.array_equal(clk_c, clk_g)
        _log(f"  mode {mode} {'multi' if multi else 'points'}: clicks "
             f"{'identical' if same else 'DIFFER'}, max |dIoU|={err:.2e} "
             f"(tol 1e-5) {'ok' if same and err <= 1e-5 else 'FAIL'}")
        if not (same and err <= 1e-5):
            raise AssertionError(f"prompt parity mode {mode} multi {multi}: "
                                 f"cpu {iou_c} {clk_c}\ncuda {iou_g} {clk_g}")


def phase_prompts(dev, card: str, model):
    """Phase 7: ViT-B@448 bf16 box / scribble sessions through the kernels,
    the launch counts read per variant."""
    import torch
    from pvpuformer_tpu_torch.inference.predictor import (Predictor,
                                                         PredictorConfig,
                                                         _prompt_noise,
                                                         click_step)

    mcfg = model.cfg
    rng = np.random.default_rng(0)
    image = (rng.uniform(size=(448, 448, 3)) * 255).astype(np.uint8)
    gt = np.zeros((448, 448), np.float32)
    gt[96:352, 128:320] = 1.0
    depth = mcfg.backbone.depth
    wrappers = _wrappers()
    total = {w.__name__: 0 for w in wrappers}
    medians, preds = {}, []
    for (mode, multi), (n_cc, n_cm, n_mp) in PROMPT_VARIANTS.items():
        pred = Predictor(model, PredictorConfig(
            model=mcfg, target_size=(448, 448), with_flip=True,
            prompt_mode=mode, as_multi_prompts=multi), device=dev)
        pred.set_input(image, gt)
        noise_ms = []                 # the click's random draws, host side
        for _ in range(5):
            t = time.perf_counter()
            _prompt_noise(pred.cfg, torch.Generator().manual_seed(0), dev)
            noise_ms.append((time.perf_counter() - t) * 1e3)
        for w in wrappers:
            w.launches = 0
        per_click, ious = [], []
        for _ in range(PROMPT_CLICKS):
            t = time.perf_counter()
            ious.append(pred.next_click())             # float(iou) syncs
            per_click.append((time.perf_counter() - t) * 1e3)
        torch.cuda.synchronize()
        counts = {w.__name__: w.launches for w in wrappers}
        c = PROMPT_CLICKS
        want = {"fused_attention": depth * c, "flash_attention": 0,
                "minplus_rows": n_mp * c, "fused_ln_mlp": depth * c,
                "cc_labels": n_cc * c, "component_max": n_cm * c}
        ious = np.asarray(ious)
        name = f"mode {mode} {'multi' if multi else 'points'}"
        medians[name] = float(np.median(per_click))
        _log(f"  {name}: IoUs {np.round(ious, 4).tolist()}, median "
             f"{medians[name]:.3f} ms/click (first {per_click[0]:.1f} ms; "
             f"noise draw {np.median(noise_ms):.3f} ms on the host) "
             f"({card}); launches {counts}")
        if not (np.isfinite(ious).all() and (ious >= 0).all()
                and (ious <= 1).all()):
            raise AssertionError(f"{name}: bad IoU curve {ious}")
        if counts != want:
            raise AssertionError(f"{name}: launches {counts}, the path calls "
                                 f"the wrappers {want} times")
        for k, v in counts.items():
            total[k] += v
        _no_host_sync(pred)
        preds.append(pred)
    # the click path (prompt_mode 0) too
    pred = Predictor(model, PredictorConfig(model=mcfg, target_size=(448, 448),
                                            with_flip=True), device=dev)
    pred.set_input(image, gt)
    pred.next_click()
    _no_host_sync(pred)
    _log("  one more click of each variant and of the click path ran with no "
         "host sync (torch.cuda.set_sync_debug_mode('error'))")
    preds.append(pred)
    side = torch.cuda.Stream()
    for p in preds:
        _capture(lambda: click_step(p.model, p.cfg, p.state, p.gen), side)
    _log("  one more click_step of the click path and of each variant was "
         "captured into a CUDA graph (not replayed): no synchronizing call")
    return total, medians


def _capture(step, side):
    """One more `step()` (a click round) captured into a
    torch.cuda.CUDAGraph (not replayed), after a warm-up call, both on the
    stream `side`. A capture fails on any call that synchronizes with the
    host, so a clean one proves the round has none (the sync debug mode
    only bounds them). The prompt draws' pinned host copy (`_prompt_noise`)
    is accepted under capture as it is. One stream for every capture of a
    phase: torch keeps a cuBLAS workspace per stream (32 MiB each), which
    would otherwise stay allocated into phase 9's peak memory."""
    import torch
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    del graph
    torch.cuda.synchronize()


def _no_host_sync(pred):
    """One more click with torch's sync debug mode raising on any
    synchronizing call."""
    import torch
    from pvpuformer_tpu_torch.inference.predictor import click_step
    torch.cuda.set_sync_debug_mode("error")
    try:
        click_step(pred.model, pred.cfg, pred.state, pred.gen)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def _counts():
    """Every launch counter: the wrappers' forward counts and, under
    "<name>_bwd", the backward counts of the differentiable wrappers (the
    attention backward kernel; the dense flash and LN+MLP recomputes)."""
    out = {}
    for w in _wrappers():
        out[w.__name__] = w.launches
        if hasattr(w, "bwd_launches"):
            out[w.__name__ + "_bwd"] = w.bwd_launches
    return out


def _zero_counts():
    for w in _wrappers():
        w.launches = 0
        if hasattr(w, "bwd_launches"):
            w.bwd_launches = 0


def train_batch(b: int, hw: int, n: int, seed: int = 0):
    """A training batch (tests/test_engine.py:tiny_batch's layout): the
    phase 5 image and gt box scaled to hw, one positive click at the gt
    centre, empty scribbles; the same sample b times."""
    rng = np.random.default_rng(seed)
    image = rng.uniform(size=(hw, hw, 3)).astype(np.float32)
    gt = np.zeros((hw, hw, 1), np.float32)
    y0, y1, x0, x1 = (int(v * hw / 448) for v in (96, 352, 128, 320))
    gt[y0:y1, x0:x1] = 1.0
    points = np.full((2 * n, 3), -1.0, np.float32)
    points[0] = ((y0 + y1) // 2, (x0 + x1) // 2, 0)
    rep = lambda a: np.repeat(a[None], b, 0)  # noqa: E731
    return {"image": rep(image), "instances": rep(gt), "points": rep(points),
            "scribbles": np.zeros((b, 1000, 2), np.float32),
            "scribble_rects": np.zeros((b, 4), np.float32)}


def _box_seed(cfg, num_iters: int) -> int:
    """The first generator seed whose step draws a box round and a click
    round."""
    import torch
    from pvpuformer_tpu_torch.engine.train_step import _train_noise
    for seed in range(1 << 16):
        types = _train_noise(cfg, torch.Generator().manual_seed(seed), 1, 1,
                             1, num_iters)["prompt_types"]
        if {0, 1} <= set(types):
            return seed
    raise AssertionError("no seed draws a box round and a click round")


def phase_train_parity(dev):
    """Phase 8: two tiny f32 train steps on CUDA vs on the CPU, the same
    draws (the generator lives on the host). SGD, not Adam: Adam divides
    each gradient element by its own magnitude, so a near-zero gradient
    that differs in its last bits moves its parameter by up to lr; SGD
    keeps the parameter error proportional to the gradient error.
    Tolerances: loss 1e-4 (abs, ~15), every gradient 1e-4 x max(max |g|, 1)
    (the same f32 math summed in another order, through the plain f32
    kernels), parameters 1e-6."""
    import torch
    from pvpuformer_tpu_torch.engine.optimizer import make_optimizer
    from pvpuformer_tpu_torch.engine.train_step import TrainConfig, train_step
    from pvpuformer_tpu_torch.models.vpu import init_vpu

    cfg = TrainConfig(model=tiny_config())
    steps = [(3, _box_seed(cfg, 3)), (2, 1)]
    runs = {}
    for where in ("cpu", dev):
        model = init_vpu(cfg.model, torch.Generator().manual_seed(1), "cpu")
        model.to(where)
        tx = make_optimizer(model, "sgd", lr=5e-5, momentum=0.9)
        grads, losses = [], []
        step = tx.step

        def spy():
            grads.append({n: None if p.grad is None else p.grad.cpu()
                          for n, p in model.named_parameters()})
            return step()

        tx.step = spy
        thr = torch.tensor([0.4, 0.375, 0.425], device=where)
        for i, (ni, seed) in enumerate(steps):
            logs, _, _ = train_step(model, tx, train_batch(2, 64, 6, seed=i),
                                    torch.Generator().manual_seed(seed), thr,
                                    cfg=cfg, num_iters=ni, device=where)
            losses.append(float(logs["loss"]))
        runs[str(where)] = (losses, grads,
                            {n: p.detach().cpu()
                             for n, p in model.named_parameters()})
    (lc, gc, pc), (lg, gg, pg) = runs["cpu"], runs[str(dev)]
    loss_err = max(abs(a - b) for a, b in zip(lc, lg))
    grad_err, grad_scale = 0.0, 1.0
    for a, b in zip(gc, gg):
        if {n for n in a if a[n] is None} != {n for n in b if b[n] is None}:
            raise AssertionError("train parity: different parameters got "
                                 "no gradient")
        grad_scale = max([grad_scale] + [float(t.abs().max())
                                         for t in a.values() if t is not None])
        grad_err = max([grad_err] + [float((a[n] - b[n]).abs().max())
                                     for n in a if a[n] is not None])
    param_err = max(float((pc[n] - pg[n]).abs().max()) for n in pc)
    ok = (loss_err <= 1e-4 and grad_err <= 1e-4 * grad_scale
          and param_err <= 1e-6)
    _log(f"  tiny f32 train steps (num_iters 3 with a box round, then 2) "
         f"cuda vs cpu: losses {lg} vs {lc}, max |dloss| {loss_err:.2e} "
         f"(tol 1e-4), max |dgrad| {grad_err:.2e} (tol 1e-4 x "
         f"{grad_scale:.3g}), max |dparam| {param_err:.2e} (tol 1e-6) "
         f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("training parity: CUDA and CPU steps disagree")


TRAIN_BATCH = 32          # vpu_base448_cocolvis.py's batch size


class _Replay:
    """A loader that yields the same batches, held in memory, every epoch."""

    def __init__(self, batches):
        self.batches = list(batches)

    def set_epoch(self, epoch):
        pass

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)


def phase_train(dev, card: str):
    """Phase 9: the full-width training path through `Trainer`, at the
    recipe's batch of 32 (an out-of-memory error fails the phase)."""
    import random
    import torch
    from pvpuformer_tpu_torch.engine.train_step import TrainConfig, _train_noise
    from pvpuformer_tpu_torch.models.vpu import vpu_base_config

    cfg = TrainConfig(model=vpu_base_config(dtype=torch.bfloat16))

    def types(seed, step, ni):
        gen = torch.Generator().manual_seed((seed << 20) ^ step)
        return _train_noise(cfg, gen, 1, 1, 1, ni)["prompt_types"]

    def num_iters(seed):              # the Trainer's draw for epoch 0
        rng = random.Random(f"{seed}-0")
        return [rng.randint(1, cfg.max_num_next_clicks) for _ in range(3)]

    # a Trainer seed whose epoch 0 draws num_iters 1, 2, 3, with at least
    # one box round among the 6 rounds
    seed = next(s for s in range(1 << 16) if num_iters(s) == [1, 2, 3]
                and any(1 in types(s, i, i + 1) for i in range(3)))
    plan = [types(seed, i, i + 1) for i in range(3)]
    return _train_run(dev, card, cfg, seed, plan, TRAIN_BATCH)


def _train_run(dev, card, cfg, seed, plan, b):
    import warnings
    import torch
    from torch.profiler import ProfilerActivity, profile
    from pvpuformer_tpu_torch.engine import trainer as ttr
    from pvpuformer_tpu_torch.engine.optimizer import make_optimizer
    from pvpuformer_tpu_torch.engine.train_step import _train_noise, train_step
    from pvpuformer_tpu_torch.models.vpu import init_vpu

    mcfg = cfg.model
    depth = mcfg.backbone.depth
    model = init_vpu(mcfg, torch.Generator().manual_seed(0), dev)
    tx = make_optimizer(model, "adam", lr=5e-5)
    hw = mcfg.backbone.img_size[0]
    batch = train_batch(b, hw, mcfg.num_max_points)
    trainer = ttr.Trainer(model, cfg, tx, _Replay([batch] * 3), device=dev,
                          seed=seed, log_every=1000)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    step_ms, losses, iters = [], [], []

    def timed(*a, **kw):
        t = time.perf_counter()
        out = train_step(*a, **kw)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        losses.append(float(out[0]["loss"]))
        iters.append(kw["num_iters"])
        return out

    ttr.train_step = timed
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    try:
        trainer.training(0)
    finally:
        ttr.train_step = train_step
    counts = _counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    rounds = sum(len(t) for t in plan)
    boxes = sum(t.count(1) for t in plan)
    want = {"fused_attention": depth * rounds,
            "fused_attention_bwd": depth * rounds,
            "flash_attention": 0, "flash_attention_bwd": 0,
            "fused_ln_mlp": depth * rounds, "fused_ln_mlp_bwd": depth * rounds,
            "minplus_rows": sum(len(t) - 1 for t in plan),
            "cc_labels": boxes, "component_max": boxes}
    changed = sum(not torch.equal(p, before[n])
                  for n, p in model.named_parameters())
    del before
    _log(f"  batch {b}, num_iters {iters}, prompt types {plan}: losses "
         f"{[round(x, 4) for x in losses]}, ms per step "
         f"{[round(x, 1) for x in step_ms]} (the first includes warm-up), "
         f"peak memory {peak_gb:.2f} GiB, {changed} of "
         f"{len(list(model.parameters()))} parameter tensors changed ({card})")
    _log(f"  launches {counts} expected {want}")
    if iters != [1, 2, 3] or not np.isfinite(losses).all() or not changed:
        raise AssertionError("training path: bad num_iters, loss or update")
    if counts != want:
        raise AssertionError("a kernel was launched a different number of "
                             "times than the training path calls it")

    gen = lambda: torch.Generator().manual_seed(seed)  # noqa: E731
    thr = torch.tensor([0.4, 0.375, 0.425], device=dev)
    noise_ms = []
    for _ in range(3):
        t = time.perf_counter()
        _train_noise(cfg, gen(), b, hw, hw, 3)
        noise_ms.append((time.perf_counter() - t) * 1e3)
    # one more 3-round step under the profiler: device-busy share
    train_step(model, tx, batch, gen(), thr, cfg=cfg, num_iters=3, device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        train_step(model, tx, batch, gen(), thr, cfg=cfg, num_iters=3,
                   device=dev)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    groups, device_ms, top = {}, 0.0, []
    for e in prof.key_averages():
        us = e.self_device_time_total
        if e.device_type != torch.autograd.DeviceType.CUDA or us <= 0:
            continue
        g = next((grp for grp, key in KERNEL_GROUPS if key in e.key),
                 "other elementwise / reductions")
        groups[g] = groups.get(g, 0.0) + us / 1e3
        device_ms += us / 1e3
        top.append((round(us / 1e3, 2), e.count, e.key[:90]))
    _log(f"  profiled 3-round step: wall {wall:.1f} ms, device {device_ms:.1f}"
         f" ms, busy share {device_ms / wall:.3f}; device ms by group "
         f"{json.dumps({k: round(v, 2) for k, v in sorted(groups.items(), key=lambda kv: -kv[1])})}; "
         f"host noise draw {np.median(noise_ms):.1f} ms ({card})")
    _log(f"  f32 products group (sgemm / gemm_f32f32 kernels): "
         f"{groups.get('f32 products', 0.0):.2f} ms of the step's "
         f"{device_ms:.1f} device ms")
    _log(f"  top device kernels (ms, calls, name): "
         f"{json.dumps(sorted(top, reverse=True)[:12])}")
    # one more step under torch's sync debug mode: count the host syncs
    import traceback
    syncs = {}

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        frames = [f for f in traceback.extract_stack()
                  if "pvpuformer_tpu_torch" in f.filename]
        where = (f"{frames[-1].filename.split('pvpuformer_tpu_torch/')[-1]}:"
                 f"{frames[-1].lineno} {frames[-1].name}") if frames else \
            f"{filename}:{lineno}"
        syncs[where] = syncs.get(where, 0) + 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        shown = warnings.showwarning
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            train_step(model, tx, batch, gen(), thr, cfg=cfg, num_iters=3,
                       device=dev)
        finally:
            torch.cuda.set_sync_debug_mode("default")
            warnings.showwarning = shown
    torch.cuda.synchronize()
    _log(f"  host syncs in one 3-round step (sync debug mode 'warn'): "
         f"{sum(syncs.values())} {json.dumps(syncs)}")
    return counts


# kernel-name substrings -> group, first match wins (profile_paths)
EVAL_PARITY_CLICKS = 5    # phase 10, per object
EVAL_CLICKS = 20          # phase 11, per object
EVAL_BATCHES = (8, 16)    # phase 11's batch sizes
PRESET_CLICKS = 3         # phase 12, per preset


class _Concat:
    """Datasets one after the other."""

    def __init__(self, parts):
        self.index = [(p, i) for p in parts for i in range(len(p))]

    def __len__(self):
        return len(self.index)

    def get_sample(self, i):
        part, j = self.index[i]
        return part.get_sample(j)


def _recording_predictor(model, cfg, device):
    """A Predictor that keeps each session's final click slots (device
    tensors, read after the run)."""
    from pvpuformer_tpu_torch.inference.predictor import Predictor

    class Recording(Predictor):
        def run_clicks(self, num_clicks):
            out = super().run_clicks(num_clicks)
            self.log.append(self.state.points[0])
            return out
    pred = Recording(model, cfg, device=device)
    pred.log = []
    return pred


@contextlib.contextmanager
def _batched_points(dataset, bev):
    """Collect the final click slots of every batched_click_scan that
    `bev.evaluate(dataset, ...)` runs; the yielded list is filled, after
    the block, with one (2N, 3) tensor per object in dataset order (the
    chunks' padding dropped). The evaluator's order: canvas bucket by
    bucket, chunk by chunk."""
    from pvpuformer_tpu_torch.inference import batched
    log, out, scan = [], [], batched.batched_click_scan

    def recorded(*args):
        states, ious = scan(*args)
        log.append(states.points)
        return states, ious
    batched.batched_click_scan = recorded
    try:
        yield out
    finally:
        batched.batched_click_scan = scan
    groups, k = {}, 0
    for i in range(len(dataset)):
        sample = dataset.get_sample(i)
        canvas = bev._canvas(*sample.image.shape[:2])
        for _ in sample.objects_ids:
            groups.setdefault(canvas, []).append(k)
            k += 1
    order = []
    for items in groups.values():
        for lo in range(0, len(items), bev.batch_size):
            chunk = items[lo:lo + bev.batch_size]
            order += chunk + [None] * (bev.batch_size - len(chunk))
    slots = [p for chunk in log for p in chunk.cpu()]
    if len(slots) != len(order):
        raise AssertionError(f"{len(slots)} batched sessions, the evaluator "
                             f"order has {len(order)}")
    by_index = {i: p for i, p in zip(order, slots) if i is not None}
    out += [by_index[i] for i in sorted(by_index)]


def _click_order(points):
    """(2N, 3) click slots -> the session's clicks [(y, x, positive), ...]
    in the order they were made."""
    import torch
    n = points.shape[0] // 2
    positive = (torch.arange(2 * n) < n).to(points.dtype)[:, None]
    rows = torch.cat([points, positive], 1)
    p = rows[rows[:, 2] >= 0]
    return p[p[:, 2].argsort()][:, [0, 1, 3]].tolist()


def _curves_ok(curves, n_objects, max_clicks, thr=0.95):
    """Every curve finite, in [0, 1], cut at its first crossing of `thr`
    (full length when it never crosses)."""
    if len(curves) != n_objects:
        raise AssertionError(f"{len(curves)} curves for {n_objects} objects")
    for c in curves:
        k = len(c)
        if not (np.isfinite(c).all() and (c >= 0).all() and (c <= 1).all()
                and 1 <= k <= max_clicks and (k == max_clicks or c[-1] >= thr)
                and not (c[:-1] >= thr).any()):
            raise AssertionError(f"bad IoU curve {c}")


def phase_eval_parity(dev):
    """Phase 10: `evaluate_dataset` and `BatchedEvaluator` (B = 2, so the
    last chunk is padded) on Synthetic(3, (64, 64)), tiny config f32, on
    CUDA and on the CPU, the same port weights: identical click sequences,
    IoU within 1e-5, identical NoC lists; on each device batched =
    sequential (identical clicks, IoU within 1e-5)."""
    import torch
    from pvpuformer_tpu_torch.inference.batched import BatchedEvaluator
    from pvpuformer_tpu_torch.inference.datasets import SyntheticDataset
    from pvpuformer_tpu_torch.inference.evaluation import (compute_noc_metric,
                                                           evaluate_dataset)
    from pvpuformer_tpu_torch.inference.predictor import PredictorConfig
    from pvpuformer_tpu_torch.models.vpu import init_vpu

    cfg = PredictorConfig(model=tiny_config(), target_size=(64, 64),
                          min_crop_size=32)
    ds = SyntheticDataset(n_samples=3, hw=(64, 64))
    out = {}
    for where in ("cpu", dev):
        model = init_vpu(cfg.model, torch.Generator().manual_seed(1), "cpu")
        with torch.no_grad():
            # the random model's probabilities centred on the 0.49
            # threshold, so the masks (and IoUs) follow the clicks
            model.head.conv_seg.b -= 0.1
        pred = _recording_predictor(model, cfg, where)
        seq, _ = evaluate_dataset(ds, pred, max_iou_thr=0.95,
                                  max_clicks=EVAL_PARITY_CLICKS)
        bev = BatchedEvaluator(model, cfg, 2, device=where)
        with _batched_points(ds, bev) as bat_clicks:
            bat, _, _ = bev.evaluate(ds, max_clicks=EVAL_PARITY_CLICKS)
        for curves in (seq, bat):
            _curves_ok(curves, 3, EVAL_PARITY_CLICKS)
        out[str(where)] = (seq, torch.stack(pred.log).cpu(), bat,
                           torch.stack(bat_clicks))
    (seq_c, clk_c, bat_c, bclk_c) = out["cpu"]
    (seq_g, clk_g, bat_g, bclk_g) = out[str(dev)]
    levels = np.quantile(np.concatenate(seq_c), [0.25, 0.5, 0.75])
    thrs = sorted(levels.tolist()) + [0.85]

    def err(a, b):
        return max(float(np.abs(x - y).max()) if x.shape == y.shape
                   else float("inf") for x, y in zip(a, b))
    checks = {
        "cuda vs cpu clicks": torch.equal(clk_c, clk_g),
        "cuda vs cpu |dIoU| <= 1e-5": err(seq_c, seq_g) <= 1e-5,
        "cuda vs cpu NoC": compute_noc_metric(seq_c, thrs,
                                              EVAL_PARITY_CLICKS)[0]
        == compute_noc_metric(seq_g, thrs, EVAL_PARITY_CLICKS)[0],
        "batched vs sequential clicks (cpu)": torch.equal(bclk_c, clk_c),
        "batched vs sequential clicks (cuda)": torch.equal(bclk_g, clk_g),
        "batched vs sequential |dIoU| <= 1e-5 (cpu)":
            err(bat_c, seq_c) <= 1e-5,
        "batched vs sequential |dIoU| <= 1e-5 (cuda)":
            err(bat_g, seq_g) <= 1e-5,
    }
    _log(f"  curves (cpu) {[np.round(c, 4).tolist() for c in seq_c]}; "
         f"max |dIoU| cuda vs cpu {err(seq_c, seq_g):.2e}, batched vs "
         f"sequential {err(bat_c, seq_c):.2e} (cpu) / {err(bat_g, seq_g):.2e}"
         f" (cuda); NoC at {np.round(thrs, 4).tolist()}: "
         f"{[float(v) for v in compute_noc_metric(seq_g, thrs, EVAL_PARITY_CLICKS)[0]]}")
    _log("  " + ", ".join(f"{k}: {'ok' if v else 'FAIL'}"
                          for k, v in checks.items()))
    if not all(checks.values()):
        raise AssertionError(f"evaluation parity: {checks}\ncpu {out['cpu']}"
                             f"\ncuda {out[str(dev)]}")


def phase_batched(dev, card: str):
    """Phase 11: ViT-B@448 bf16 NoC evaluation of 21 objects x 20 clicks
    (16 of Synthetic 448 x 448 and 5 of 300 x 500: two canvas buckets and
    padded chunks), sequential, then BatchedEvaluator at B = 8 and 16."""
    import torch
    from pvpuformer_tpu_torch.inference.batched import BatchedEvaluator
    from pvpuformer_tpu_torch.inference.datasets import SyntheticDataset
    from pvpuformer_tpu_torch.inference.evaluation import evaluate_dataset
    from pvpuformer_tpu_torch.inference.predictor import (PredictorConfig,
                                                         batched_click_step,
                                                         init_session,
                                                         stack_states)
    from pvpuformer_tpu_torch.models.vpu import init_vpu, vpu_base_config
    from pvpuformer_tpu_torch.ops import edt

    mcfg = vpu_base_config(dtype=torch.bfloat16)
    model = init_vpu(mcfg, torch.Generator().manual_seed(0), dev)
    pcfg = PredictorConfig(model=mcfg, target_size=mcfg.crop_size,
                           with_flip=True)
    parts = ((16, (448, 448), 0), (5, (300, 500), 100))  # (n, hw, seed)
    ds = _Concat([SyntheticDataset(n_samples=n, hw=hw, seed=seed)
                  for n, hw, seed in parts])
    n_obj, depth = len(ds), mcfg.backbone.depth
    sample = ds.get_sample(0)

    def session():
        return init_session(sample.image, sample.gt_mask(0),
                            mcfg.num_max_points,
                            pred._canvas(*sample.image.shape[:2]), dev)

    def run(label, fn):
        """fn() -> (curves, elapsed, device rounds); the counts of this
        run alone, checked per round."""
        _zero_counts()
        curves, elapsed, rounds = fn()
        torch.cuda.synchronize()
        counts = _counts()
        _curves_ok(curves, n_obj, EVAL_CLICKS)
        clicks = sum(map(len, curves))
        want = {k: 0 for k in counts}
        want.update(fused_attention=depth * rounds, minplus_rows=rounds,
                    fused_ln_mlp=depth * rounds)
        per_round = {k: v / rounds for k, v in counts.items() if v}
        res = {"curves": curves, "objects_per_sec": n_obj / elapsed,
               "clicks_per_sec": clicks / elapsed,
               "ms_per_round": elapsed / rounds * 1e3, "rounds": rounds,
               "launches_per_round": per_round}
        _log(f"  {label}: {n_obj} objects, {clicks} clicks in {rounds} "
             f"rounds, {elapsed:.3f} s: {res['objects_per_sec']:.3f} "
             f"objects/s, {res['clicks_per_sec']:.2f} clicks/s, "
             f"{res['ms_per_round']:.2f} ms per round; launches per round "
             f"{per_round} ({card})")
        if counts != want:
            raise AssertionError(f"{label}: launches {counts}, the path "
                                 f"calls the wrappers {want} times")
        return res

    pred = _recording_predictor(model, pcfg, dev)
    pred.set_input(sample.image, sample.gt_mask(0))
    pred.run_clicks(2)                                   # warm-up
    pred.log.clear()

    def sequential():
        curves, elapsed = evaluate_dataset(ds, pred, max_iou_thr=0.95,
                                           max_clicks=EVAL_CLICKS)
        return curves, elapsed, n_obj * EVAL_CLICKS
    summary = {"sequential": run("sequential", sequential)}
    seq_clicks = torch.stack(pred.log).cpu()
    side = torch.cuda.Stream()
    for b in EVAL_BATCHES:
        bev = BatchedEvaluator(model, pcfg, b, device=dev)
        with torch.no_grad():                    # warm-up at the new shapes
            batched_click_step(model, bev.cfg,
                               stack_states([session()] * b))
        box = {}

        def batched():
            with _batched_points(ds, bev) as clicks:
                curves, elapsed, stats = bev.evaluate(
                    ds, max_clicks=EVAL_CLICKS, max_iou_thr=0.95)
            box.update(curves=curves, clicks=clicks, stats=stats)
            n_chunks = sum(-(-n // b) for n, _, _ in parts)
            return curves, elapsed, n_chunks * EVAL_CLICKS
        res = run(f"batched B={b}", batched)
        same = [torch.equal(c, s) for c, s in
                zip(box["clicks"], seq_clicks)]
        # the click (1-based) where each other session leaves the
        # sequential run's sequence
        first = sorted(next((i + 1 for i, (u, v) in enumerate(zip(
            _click_order(c), _click_order(s))) if u != v), 0)
            for c, s, ok in zip(box["clicks"], seq_clicks, same) if not ok)
        d_iou = max(float(np.abs(a[:min(len(a), len(q))]
                                 - q[:min(len(a), len(q))]).max())
                    for a, q in zip(box["curves"], summary["sequential"]
                                    ["curves"]))
        res.update(same_clicks_share=float(np.mean(same)),
                   max_abs_diou=d_iou, first_differing_clicks=first)
        _log(f"    vs sequential: {sum(same)} of {len(same)} sessions with "
             f"the same clicks (share {np.mean(same):.3f}; the others "
             f"leave it at click {first}), max |dIoU| "
             f"{d_iou:.3e} (reported, not gated: bf16 products may round "
             f"by the batch); stats {box['stats']}")
        summary[f"B={b}"] = res
        if b == EVAL_BATCHES[0]:
            states = stack_states([session()] * b)
            with torch.no_grad():
                _capture(lambda: batched_click_step(model, bev.cfg, states),
                         side)
            _log(f"  one batched_click_step at B={b} was captured into a "
                 f"CUDA graph (not replayed): no synchronizing call")
    # the batched mode's pass-1 form (resolve_batched_cfg: "dense") beside
    # the single-session "scan" form, bit-identical, at B = 16's masks
    masks = torch.rand((2 * EVAL_BATCHES[-1], 448, 448), device=dev) > 0.5
    p1 = {rows: _time_ms(lambda: edt._pass1(masks, rows), iters=5)
          for rows in ("scan", "dense")}
    if not torch.equal(edt._pass1(masks, "scan"), edt._pass1(masks, "dense")):
        raise AssertionError("EDT pass 1: dense and scan forms differ")
    _log(f"  EDT pass 1 at ({2 * EVAL_BATCHES[-1]}, 448, 448): scan "
         f"{p1['scan']:.3f} ms, dense {p1['dense']:.3f} ms per call "
         f"(bit-identical) ({card})")
    for res in summary.values():
        res.pop("curves", None)
    _log("  phase 11 summary: " + json.dumps(
        {"phase11": summary, "pass1_ms": p1, "card": card}))


def phase_presets(dev, card: str):
    """Phase 12: one 3-click bf16 session each of ViT-L@448 and
    ViT-H@448 (patch 14, head dim 80), random weights, with launch counts
    equal to the wrapper calls."""
    import torch
    from pvpuformer_tpu_torch.inference.predictor import (Predictor,
                                                         PredictorConfig)
    from pvpuformer_tpu_torch.models.vpu import (init_vpu, vpu_huge_config,
                                                 vpu_large_config)
    rng = np.random.default_rng(0)
    image = (rng.uniform(size=(448, 448, 3)) * 255).astype(np.uint8)
    gt = np.zeros((448, 448), np.float32)
    gt[96:352, 128:320] = 1.0
    for name, make in (("ViT-L", vpu_large_config),
                       ("ViT-H", vpu_huge_config)):
        mcfg = make(dtype=torch.bfloat16)
        t = time.perf_counter()
        model = init_vpu(mcfg, torch.Generator().manual_seed(0), dev)
        init_s = time.perf_counter() - t
        pred = Predictor(model, PredictorConfig(
            model=mcfg, target_size=mcfg.crop_size, with_flip=True),
            device=dev)
        pred.set_input(image, gt)
        _zero_counts()
        per_click, ious = [], []
        for _ in range(PRESET_CLICKS):
            t = time.perf_counter()
            ious.append(pred.next_click())             # float(iou) syncs
            per_click.append((time.perf_counter() - t) * 1e3)
        counts = _counts()
        depth, c = mcfg.backbone.depth, PRESET_CLICKS
        want = {k: 0 for k in counts}
        want.update(fused_attention=depth * c, minplus_rows=c,
                    fused_ln_mlp=depth * c)
        ious = np.asarray(ious)
        _log(f"  {name}@448 (D {mcfg.backbone.embed_dim}, depth {depth}, "
             f"patch {mcfg.backbone.patch_size[0]}, head dim "
             f"{mcfg.backbone.embed_dim // mcfg.backbone.num_heads}): IoUs "
             f"{np.round(ious, 4).tolist()}, ms per click "
             f"{np.round(per_click, 2).tolist()} (the first warms up; "
             f"weights built in {init_s:.1f} s) ({card}); launches "
             f"{ {k: v for k, v in counts.items() if v} }")
        if not (np.isfinite(ious).all() and (ious >= 0).all()
                and (ious <= 1).all()):
            raise AssertionError(f"{name}: bad IoU curve {ious}")
        if counts != want:
            raise AssertionError(f"{name}: launches {counts}, the path calls "
                                 f"the wrappers {want} times")
        del pred, model
        torch.cuda.empty_cache()


KERNEL_GROUPS = (("CC kernel", "flood_kernel"),
                 ("attention backward kernel", "attention_bwd"),
                 ("attention kernel", "attention"),
                 ("LN+MLP kernel", "fc1_gelu"), ("LN+MLP kernel", "fc2_resid"),
                 ("f32 products", "sgemm"), ("f32 products", "gemm_f32f32"),
                 ("min-plus kernel", "minplus"),
                 ("cuBLAS / cuDNN products", "gemm"),
                 ("cuBLAS / cuDNN products", "nvjet"),   # cuBLASLt's kernels
                 ("cuBLAS / cuDNN products", "xmma"),
                 ("cuBLAS / cuDNN products", "cutlass"),
                 ("cuBLAS / cuDNN products", "conv"),
                 ("copies / casts", "copy"), ("copies / casts", "Memcpy"),
                 ("copies / casts", "Memset"))
PROFILE_CLICKS = 5


def _profile_rounds(step, card: str, name: str) -> dict:
    """`step()` (one round, ending in a host read) 3 times to warm up and 5
    times on the host clock, then 5 times under torch.profiler: device ms
    per round by kernel group, launches per round, the busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    walls = []
    for _ in range(3 + PROFILE_CLICKS):
        t = time.perf_counter()
        step()
        walls.append((time.perf_counter() - t) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(PROFILE_CLICKS):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3 / PROFILE_CLICKS
    groups, launches, device = {}, 0, 0.0
    for e in prof.key_averages():
        us = e.self_device_time_total
        if e.device_type != torch.autograd.DeviceType.CUDA or us <= 0:
            continue
        g = next((grp for grp, key in KERNEL_GROUPS if key in e.key),
                 "other elementwise / reductions")
        groups[g] = groups.get(g, 0.0) + us / 1e3 / PROFILE_CLICKS
        launches += e.count
        device += us / 1e3 / PROFILE_CLICKS
    out = {"unprofiled_median_ms": float(np.median(walls[3:])),
           "profiled_wall_ms": wall, "device_ms": device,
           "busy_share": device / wall,
           "launches_per_round": launches / PROFILE_CLICKS,
           "device_ms_by_group": dict(sorted(groups.items(),
                                             key=lambda kv: -kv[1]))}
    _log(f"  {name}: {json.dumps(out)} ({card})")
    return out


def profile_paths(dev, card: str):
    """ViT-B@448 bf16: where a click round's device time goes, per path:
    the click path and the four prompt variants one session at a time,
    and batched click sessions at B = 8 and 16 (per round of B clicks)."""
    import torch
    from pvpuformer_tpu_torch.inference.batched import resolve_batched_cfg
    from pvpuformer_tpu_torch.inference.predictor import (Predictor,
                                                         PredictorConfig,
                                                         batched_click_step,
                                                         init_session,
                                                         stack_states)
    from pvpuformer_tpu_torch.models.vpu import init_vpu, vpu_base_config

    mcfg = vpu_base_config(dtype=torch.bfloat16)
    model = init_vpu(mcfg, torch.Generator().manual_seed(0), dev)
    rng = np.random.default_rng(0)
    image = (rng.uniform(size=(448, 448, 3)) * 255).astype(np.uint8)
    gt = np.zeros((448, 448), np.float32)
    gt[96:352, 128:320] = 1.0
    out = {}
    for mode, multi in [(0, True)] + list(PROMPT_VARIANTS):
        name = ("click path" if mode == 0 else
                f"mode {mode} {'multi' if multi else 'points'}")
        pred = Predictor(model, PredictorConfig(
            model=mcfg, target_size=(448, 448), with_flip=True,
            prompt_mode=mode, as_multi_prompts=multi), device=dev)
        pred.set_input(image, gt)
        out[name] = _profile_rounds(pred.next_click, card, name)
    bcfg = resolve_batched_cfg(PredictorConfig(
        model=mcfg, target_size=(448, 448), with_flip=True))
    for b in EVAL_BATCHES:
        box = [stack_states([init_session(image, gt, mcfg.num_max_points,
                                          (448, 448), dev)] * b)]

        @torch.no_grad()
        def step():
            box[0], iou = batched_click_step(model, bcfg, box[0])
            return iou.cpu()                        # the host read
        out[f"batched B={b}"] = _profile_rounds(step, card,
                                                f"batched B={b} (per round)")
    return out


ROOT = os.path.dirname(os.path.abspath(__file__))
TINY_RECIPE = "pvpuformer_tpu_torch/recipes/iSegNet/vpu_tiny_synthetic.py"
RECIPE_STEPS = 4          # phase 13b: one epoch of the shipped recipe
RECIPE_HW = (480, 640)    # phase 13b: a COCO-sized raw image
LOADER_WORKERS = 4        # train.py's default --workers
WAIT_SHARE = 0.05         # phase 13b: the loader keeps ahead below this


def _subprocess(args, cwd, what: str):
    """`python -m <args>` from `cwd` with this checkout on the path: its
    output, after a 0 exit code."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    t = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", *args], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=600)
    secs = time.perf_counter() - t
    if out.returncode != 0:
        raise AssertionError(f"{what} exited {out.returncode}:\n"
                             f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    return out.stdout, secs


def phase_entry(dev):
    """Phase 13a: `python -m pvpuformer_tpu_torch.train` on the tiny recipe
    (--debug: one epoch of 4 steps at batch 8) and `python -m
    pvpuformer_tpu_torch.evaluate` on its checkpoint, both on the card in
    a temporary directory; then the tiny recipe's first 2 Trainer steps on
    CUDA and on the CPU from the same Loader batches and draws, losses
    within phase 8's 1e-4."""
    import tempfile
    from pathlib import Path
    from pvpuformer_tpu_torch.engine import trainer as ttr
    from pvpuformer_tpu_torch.recipes.iSegNet import vpu_tiny_synthetic
    from pvpuformer_tpu_torch.utils.exp import EasyCfg

    with tempfile.TemporaryDirectory() as tmp:
        out, secs = _subprocess(
            ["pvpuformer_tpu_torch.train", os.path.join(ROOT, TINY_RECIPE),
             "--debug", "--batch-size", "8"], tmp, "the tiny recipe")
        exp = Path(tmp) / "experiments" / "iSegNet" / "vpu_tiny_synthetic" \
            / "000"
        ckpt = exp / "checkpoints" / "last_checkpoint.npz"
        layout = sorted(str(q.relative_to(exp)) for q in exp.rglob("*"))
        logs = list((exp / "logs").glob("train_*.log"))
        ok = (ckpt.is_file() and (exp / "checkpoints" / "000.npz").is_file()
              and (exp / "vpu_tiny_synthetic.py").is_file()
              and (exp / "vis").is_dir() and len(logs) == 1
              and "saved checkpoint" in logs[0].read_text())
        _log(f"  python -m pvpuformer_tpu_torch.train {TINY_RECIPE} --debug "
             f"--batch-size 8: rc 0 in {secs:.1f} s; experiment layout "
             f"{layout}; last log line: "
             f"{out.strip().splitlines()[-1] if out.strip() else '(none)'}")
        if not ok:
            raise AssertionError("the tiny recipe did not write the "
                                 "experiment layout, checkpoint and log")
        out, secs = _subprocess(
            ["pvpuformer_tpu_torch.evaluate", "--checkpoint", str(ckpt),
             "--datasets", "Synthetic", "--limit", "3", "--n-clicks", "5",
             "--dtype", "float32", "--print-ious", "--logs-path",
             os.path.join(tmp, "eval")], tmp,
            "the evaluation CLI")
        table = [ln for ln in out.splitlines()
                 if ln.startswith("|") or ln.startswith("mIoU@k")]
        _log(f"  python -m pvpuformer_tpu_torch.evaluate --checkpoint "
             f"<its last_checkpoint.npz> --datasets Synthetic --limit 3 "
             f"--n-clicks 5 --dtype float32 (the recipe's): rc 0 in "
             f"{secs:.1f} s")
        for ln in table:
            _log(f"    {ln}")
        if not any("NoC@90%" in ln for ln in table) or \
                not any("| Synthetic |" in ln for ln in table):
            raise AssertionError("the evaluation CLI printed no NoC table")

    losses = {}
    step = ttr.train_step
    for where in ("cpu", dev):
        cfg = EasyCfg(CHECKPOINTS_PATH=None, device=str(where), batch_size=8,
                      workers=2)
        trainer = vpu_tiny_synthetic.build_trainer(
            cfg, vpu_tiny_synthetic.make_trainset())
        trainer.train_loader = _Replay(
            itertools.islice(trainer.train_loader, 2))   # epoch 0's first
        seen = losses[str(where)] = []

        def rec(*a, **kw):
            out = step(*a, **kw)
            seen.append(float(out[0]["loss"]))
            return out

        ttr.train_step = rec
        try:
            trainer.training(0)
        finally:
            ttr.train_step = step
    lc, lg = losses["cpu"], losses[str(dev)]
    err = max(abs(a - b) for a, b in zip(lc, lg))
    _log(f"  tiny recipe's first 2 steps (Adam 1e-3, f32, batch 8) cuda vs "
         f"cpu, the same Loader batches and draws: losses {lg} vs {lc}, max "
         f"|dloss| {err:.2e} (tol 1e-4) {'ok' if err <= 1e-4 else 'FAIL'}")
    if len(lc) != 2 or len(lg) != 2 or err > 1e-4:
        raise AssertionError("the tiny recipe's CUDA and CPU steps disagree")


class _TimedLoader:
    """A loader whose epoch records the host seconds each batch was waited
    for, and keeps the batches."""

    def __init__(self, loader):
        self.loader, self.waits, self.batches = loader, [], []

    def set_epoch(self, epoch):
        self.loader.set_epoch(epoch)

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        it = iter(self.loader)
        while True:
            t = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            self.waits.append(time.perf_counter() - t)
            self.batches.append(batch)
            yield batch


def _recipe_epoch(trainer, loader, run):
    """`run()` (an epoch of `trainer`) with its batches from `loader`:
    (ms per step, batch wait ms per step, wall ms per step, num_iters,
    seconds after the last step (the dump and the checkpoints), the
    batches)."""
    import torch
    from pvpuformer_tpu_torch.engine import trainer as ttr
    trainer.train_loader = timed = _TimedLoader(loader)
    step = ttr.train_step
    steps, ends, iters = [], [], []

    def rec(*a, **kw):
        t = time.perf_counter()
        out = step(*a, **kw)
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
        steps.append((ends[-1] - t) * 1e3)
        iters.append(kw["num_iters"])
        return out

    ttr.train_step = rec
    try:
        t0 = time.perf_counter()
        run()
        tail = time.perf_counter() - ends[-1]
    finally:
        ttr.train_step = step
    walls = np.diff([t0] + ends) * 1e3
    return (steps, [w * 1e3 for w in timed.waits], walls.tolist(), iters,
            tail, timed.batches)


def _ms(xs):
    return [round(x, 1) for x in xs]


def phase_recipe(dev, card: str):
    """Phase 13b: the shipped recipe's own Trainer
    (`vpu_base448_cocolvis.build_trainer`: ViT-B@448 bf16, batch 32, its
    sampler, augmentations, TrainConfig and Adam 5e-5) over the synthetic
    raw source at a COCO size (480 x 640), `trainer.run(1)`: one epoch of
    RECIPE_STEPS steps through `Loader` with 4 thread workers, one panel
    dumped and the checkpoints written to a temporary directory; then the
    epoch's batches replayed from memory (the steps with no loader work
    beside them) and, where the wait share exceeds WAIT_SHARE, the epoch
    through process workers: loader records/s alone,
    ms per step, the share of each step's wall time spent waiting for its
    batch, peak memory, and each kernel's launches against what the drawn
    num_iters and prompt types (and the dump's forward) predict."""
    import random
    import tempfile
    from pathlib import Path
    import torch
    from pvpuformer_tpu_torch.data import Loader, SyntheticTrainDataset
    from pvpuformer_tpu_torch.engine.train_step import _train_noise
    from pvpuformer_tpu_torch.recipes.iSegNet import vpu_base448_cocolvis \
        as recipe
    from pvpuformer_tpu_torch.utils.exp import EasyCfg

    sampler = recipe.points_sampler()
    trainset = SyntheticTrainDataset(
        n_samples=32, hw=RECIPE_HW, **{**recipe.train_kwargs(sampler),
                                       "epoch_len": RECIPE_STEPS * TRAIN_BATCH})
    valset = SyntheticTrainDataset(n_samples=8, hw=RECIPE_HW,
                                   **recipe.val_kwargs(sampler))
    # a warm-up batch: the records' lazy scipy imports and the allocator's
    # first pages (a cold first pass read half the rate on a CPU host)
    next(iter(Loader(trainset, TRAIN_BATCH, num_workers=LOADER_WORKERS)))
    rates = {}
    for worker_type in ("thread", "process"):
        loader = Loader(trainset, TRAIN_BATCH, num_workers=LOADER_WORKERS,
                        worker_type=worker_type)
        t = time.perf_counter()
        n = sum(len(b["image"]) for b in loader)
        rates[worker_type] = n / (time.perf_counter() - t)
    _log(f"  Loader alone, {LOADER_WORKERS} workers, batch {TRAIN_BATCH}, "
         f"{RECIPE_STEPS * TRAIN_BATCH} records of {RECIPE_HW} raw images "
         f"(train_augmentator to 448 x 448, 24-point sampler, 1000-sample "
         f"scribbles): {rates['thread']:.1f} records/s with threads, "
         f"{rates['process']:.1f} with processes (host, {card})")

    with tempfile.TemporaryDirectory() as tmp:
        cfg = EasyCfg(CHECKPOINTS_PATH=Path(tmp) / "checkpoints",
                      LOGS_PATH=Path(tmp) / "logs", device=str(dev),
                      batch_size=TRAIN_BATCH, workers=LOADER_WORKERS,
                      IMAGENET_PRETRAINED_MODELS={})
        trainer = recipe.build_trainer(cfg, trainset, valset)
        trainer.vis_dir = Path(tmp) / "vis"
        trainer.image_dump_interval = RECIPE_STEPS
        mcfg = trainer.cfg.model
        depth = mcfg.backbone.depth
        rng = random.Random(f"{trainer.seed}-0")
        want_iters = [rng.randint(1, trainer.cfg.max_num_next_clicks)
                      for _ in range(RECIPE_STEPS)]
        plan = [_train_noise(trainer.cfg, torch.Generator().manual_seed(
            (trainer.seed << 20) ^ i), 1, 1, 1, ni)["prompt_types"]
            for i, ni in enumerate(want_iters)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        steps, waits, walls, iters, tail, batches = _recipe_epoch(
            trainer, trainer.train_loader, lambda: trainer.run(1))
        counts = _counts()
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        ckpts = sorted(q.name for q in cfg.CHECKPOINTS_PATH.iterdir())
        panels = sorted(q.name for q in trainer.vis_dir.iterdir())
        rounds = sum(len(tp) for tp in plan)
        boxes = sum(tp.count(1) for tp in plan)
        dumps = RECIPE_STEPS // trainer.image_dump_interval
        want = {"fused_attention": depth * (rounds + dumps),
                "fused_attention_bwd": depth * rounds,
                "flash_attention": 0, "flash_attention_bwd": 0,
                "fused_ln_mlp": depth * (rounds + dumps),
                "fused_ln_mlp_bwd": depth * rounds,
                "minplus_rows": sum(len(tp) - 1 for tp in plan),
                "cc_labels": boxes, "component_max": boxes}
        steady = slice(1, None)                 # the first includes warm-up
        share = sum(waits[steady]) / sum(walls[steady])
        _log(f"  recipe epoch, thread workers: num_iters {iters}, prompt "
             f"types {plan}; ms per step {_ms(steps)}, wall ms per step "
             f"{_ms(walls)}, batch wait ms {_ms(waits)}: wait share of steps "
             f"2-{RECIPE_STEPS} {share:.3f} (keeps ahead below {WAIT_SHARE}); "
             f"peak memory {peak_gb:.2f} GiB; panels {panels} and "
             f"checkpoints {ckpts} written in {tail:.1f} s after the last "
             f"step ({card})")
        _log(f"  launches {counts} expected {want}")
        if iters != want_iters or counts != want:
            raise AssertionError("the recipe's kernels were launched a "
                                 "different number of times than its "
                                 "path calls them")
        if len(panels) != dumps or "last_checkpoint.npz" not in ckpts:
            raise AssertionError("the recipe wrote no panel or checkpoint")
        trainer.image_dump_interval = 0
        # the same epoch's batches again from memory (the same num_iters):
        # the steps with no loader work beside them
        r_steps, _, r_walls, r_iters, _, _ = _recipe_epoch(
            trainer, _Replay(batches), lambda: trainer.training(0))
        _log(f"  the same batches replayed from memory: num_iters {r_iters}; "
             f"ms per step {_ms(r_steps)}, wall ms per step {_ms(r_walls)} "
             f"({card})")
        if share > WAIT_SHARE:
            p_steps, p_waits, p_walls, p_iters, _, _ = _recipe_epoch(
                trainer, Loader(trainset, TRAIN_BATCH,
                                num_workers=LOADER_WORKERS,
                                worker_type="process"),
                lambda: trainer.training(0))
            p_share = sum(p_waits[steady]) / sum(p_walls[steady])
            _log(f"  the epoch again through process workers: num_iters "
                 f"{p_iters}; ms per step {_ms(p_steps)}, wall ms per step "
                 f"{_ms(p_walls)}, batch wait ms {_ms(p_waits)}: wait share "
                 f"of steps 2-{RECIPE_STEPS} {p_share:.3f} (threads "
                 f"{share:.3f}) ({card})")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test needs a GPU",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    mm = torch.backends.cuda.matmul
    _log(f"[1/13] environment: {smi} | torch {torch.__version__} "
         f"cuda {torch.version.cuda} | torch's precision flags as they come "
         f"(the package pins its own): cudnn.allow_tf32 "
         f"{torch.backends.cudnn.allow_tf32}, matmul.allow_tf32 "
         f"{mm.allow_tf32}, allow_bf16_reduced_precision_reduction "
         f"{mm.allow_bf16_reduced_precision_reduction}")

    from pvpuformer_tpu_torch.ops import _build
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    _log(f"[2/13] build: {lib_path} in {time.perf_counter() - t0:.1f} s")
    if "--profile" in sys.argv[1:]:
        _log("[profile] ViT-B@448 bf16 clicks under torch.profiler")
        print(json.dumps({"profile": profile_paths(dev, smi), "card": smi}))
        return 0

    _log("[3/13] kernels vs plain versions")
    res = phase_kernels(dev)
    _log("[4/13] model parity, tiny config f32")
    phase_parity(dev)
    _log("[5/13] main path: ViT-B@448 bf16 click sessions")
    launches, model = phase_main(dev, smi)
    _log("[6/13] prompt parity, tiny config f32, four prompt variants")
    phase_prompt_parity(dev)
    _log("[7/13] prompt path: ViT-B@448 bf16 box / scribble sessions")
    prompt_launches, _ = phase_prompts(dev, smi, model)
    for name in ("cc_labels", "component_max"):        # slice 2's path
        launches[name] = prompt_launches[name]
    del model
    torch.cuda.empty_cache()
    _log("[8/13] training parity, tiny config f32")
    phase_train_parity(dev)
    _log("[9/13] training path: ViT-B@448 bf16 Trainer steps")
    train_launches = phase_train(dev, smi)
    launches["fused_attention_bwd"] = train_launches["fused_attention_bwd"]
    torch.cuda.empty_cache()
    _log("[10/13] evaluation parity, tiny config f32: sequential and "
         "batched, CUDA vs the CPU")
    phase_eval_parity(dev)
    _log("[11/13] batched evaluation: ViT-B@448 bf16, 21 objects x "
         f"{EVAL_CLICKS} clicks, sequential and B = "
         f"{' / '.join(map(str, EVAL_BATCHES))}")
    phase_batched(dev, smi)
    torch.cuda.empty_cache()
    _log("[12/13] presets: ViT-L@448 and ViT-H@448 bf16 sessions")
    phase_presets(dev, smi)
    torch.cuda.empty_cache()
    _log("[13/13] the training entry point: the tiny recipe and the "
         "evaluation CLI as processes; tiny steps CUDA vs the CPU; the "
         "shipped recipe through the data pipeline")
    phase_entry(dev)
    phase_recipe(dev, smi)

    meta = {
        "fused_attention": ("pvpuformer_tpu_torch/csrc/attention.cu",
                            "pvpuformer_tpu/ops/fused_attention.py:83"),
        "fused_attention_bwd": ("pvpuformer_tpu_torch/csrc/attention_bwd.cu",
                                "pvpuformer_tpu/ops/fused_attention.py:97"),
        "flash_attention": ("pvpuformer_tpu_torch/csrc/attention.cu",
                            "pvpuformer_tpu/ops/attention.py:39"),
        "minplus_rows": ("pvpuformer_tpu_torch/csrc/edt_minplus.cu",
                         "pvpuformer_tpu/ops/edt_pallas.py:28"),
        "fused_ln_mlp": ("pvpuformer_tpu_torch/csrc/fused_mlp.cu",
                         "pvpuformer_tpu/ops/fused_mlp.py:37"),
        "cc_labels": ("pvpuformer_tpu_torch/csrc/cc.cu",
                      "pvpuformer_tpu/ops/cc_pallas.py:86"),
        "component_max": ("pvpuformer_tpu_torch/csrc/cc.cu",
                          "pvpuformer_tpu/ops/cc_pallas.py:98"),
    }
    kernels = []
    for name, (src, rep) in meta.items():
        t = res[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": rep, "launches": launches[name],
                        **t, "bound_us": t["bound_ms"] * 1e3})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
