"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints one line; any failure raises and the exit code is not 0):
  1. environment: a CUDA device is required (no CPU path); the card's name
     and power limit from nvidia-smi; torch's precision flags are left as
     they come (the package pins its own precision);
  2. build: nvcc compiles pvpuformer_tpu_torch/csrc/*.cu into build/kernels/;
  3. kernels vs their plain PyTorch versions on the card, at the ViT-B@448
     click-, prompt- and training-path (batch 32) shapes, the batched
     sessions' shapes at B = 8 (B = 16's are the training shapes),
     PlainVit's tiled_forward over 12 tiles (attention (48, 196, 12, 64)
     and (12, 784, 12, 64), LN+MLP over 9408 rows), and the
     ViT-L / ViT-H click shapes (head dims 64 and 80, LN+MLP at 1024 ->
     4096 and 1280 -> 5120), the evaluation CLI's protocol shapes
     (--eval-ritm's crop 400: attention (2, 625, 12, 64), no windows,
     LN+MLP over 1250 rows; --eval-mode fixed448,672: attention
     (12, 196, 12, 64) and (2, 1176, 12, 64), LN+MLP over 2352 rows)
     (and the CC
     kernels, bit-exact and bit-identical on repeat at iters 1, 2, 8 and 16,
     at every mask of CC_MASKS: a snake and a spiral that need more than 8
     rounds, 50176 components, ragged, empty, full, 1 x W and H x 1 masks,
     a 4096 x 4096 image, and the batched prompt sessions' 16 flip-batch
     masks at B = 8; one CUDA kernel per call, counted with
     torch.profiler; the min-plus kernel bit-exact, bit-identical on repeat
     and one CUDA kernel per call at the click and training shapes, two
     ragged ones and the widest row, W = 8192, with values up to 2^24 - 1,
     with its device time at the path shapes; the LN+MLP kernel's
     tensor-parallel launch (b') (`launch_fc2_partial`, f32 out, ViT-B's
     local hidden width 1536 at M = 2) at 6272 and 25088 rows against
     `fc2_partial_plain` within FC2_PARTIAL_TOL and bit-identical on
     repeat, beside torch.mm(h, w2, out_dtype=torch.float32); the
     host-side distance maps of pvpuformer_tpu_torch/native, built with g++
     and held bit for bit against their numpy twin at 448 x 448 with 24
     clicks; and whether torch's
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
     sessions through `Predictor` (on the card its rounds are replayed
     from a captured round, inference/graphs.py), then 3 clicks with
     attn_impl="flash"; IoUs finite in [0, 1], click counts, and the
     launch checks: the counters zeroed just before a run and read just
     after hold the wrapper calls of the rounds run eagerly or captured
     (a replay calls no wrapper), and the same run again under
     torch.profiler shows each kernel launched on the card once per call
     its rounds make (LAUNCH CHECKS below); then
     the eager `click_scan` against `Predictor.run_clicks` from one state,
     bit-identical, with the p50 ms per click of both and the replayed
     session's device time;
  6. prompt parity: tiny f32 box / scribble sessions, all four (prompt_mode,
     as_multi_prompts) variants with deterministic prompts, CUDA vs the CPU:
     identical clicks, IoU within 1e-5;
  7. the prompt path: ViT-B@448 bf16 box / scribble sessions through
     `Predictor`, 5 clicks for each of the four variants (random prompts):
     IoUs finite in [0, 1] and the launch checks, per variant; one more click of
     each variant and of the click path under torch's sync debug mode, and
     one more captured into a CUDA graph (a capture fails on any host
     sync); per variant 20 rounds of the eager `click_scan` against
     `Predictor.run_clicks`, bit-identical, timed as in phase 5;
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
     config f32, for the click path and the four prompt variants, CUDA vs
     the CPU: identical clicks, IoU within 1e-5, identical NoC lists; on
     each device batched = sequential;
 11. batched evaluation: ViT-B@448 bf16, seeded random weights, 21
     objects (16 of Synthetic 448 x 448, 5 of 300 x 500: two canvas
     buckets, padded chunks) x 20 clicks, through sequential
     `evaluate_dataset` and `BatchedEvaluator` at B = 8 and 16: objects/s,
     clicks/s, ms per click round and the launch checks, whose kernel
     launches per round must be the same for every B (depth fused
     attention, depth LN+MLP, one min-plus); curves finite in [0, 1] of the right length;
     the share of sessions whose clicks equal the sequential run's and the
     max |dIoU| (reported, not gated: bf16 products may round by the
     batch); one `batched_click_step` captured into a CUDA graph; at B = 8
     the click path, a box and a scribble variant (multi-prompt) with
     every chunk replayed from the captured round against the eager
     `batched_click_scan`: curves and click slots bit-identical, clicks/s
     of both (and, for the prompt variants, of sequential sessions, with
     the share of sessions whose clicks equal theirs, reported), the
     replayed runs with the launch checks; the EDT pass-1 forms' times at
     B = 16's masks; the captured rounds' cache (`phase_graph_cache`): per
     key the ms of its first (eager), second (captured) and third
     (replayed) round and the memory reserved, and sequential evaluation
     over six canvas buckets met round robin twice in sessions of 1, 3 and
     10 clicks, eager and replayed with 4 and 8 graphs (MAX_GRAPHS is 8);
 12. presets: one 3-click bf16 session each of ViT-L@448 and ViT-H@448,
     random weights, with the launch checks;
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
 14. serving parity, tiny config f32, CUDA vs the CPU: the int8 linear at
     the ViT-B@448 click shapes and a padded small one (bit-identical); a
     controller session (clicks, undo, finish, init mask, a click outside
     the image): result masks and panels identical, probabilities within
     1e-5; an int8 `Predictor` session (first click identical, IoU within
     5e-3: int8 rounding turns last-bit differences into whole quanta);
     one session of each BRS mode (f-BRS-A / B / C, RGB-BRS, DistMap-BRS)
     at max_iters 3: identical clicks, IoU within 1e-3;
 15. serving at ViT-B@448 bf16, seeded random weights, one model for every
     session: the HTTP service in process on 127.0.0.1 with two concurrent
     client sessions (10 requests each, then /mask and /vis), each mask
     and panel bit-identical to a controller driven directly with the same
     clicks, and the /click p50 with one and two clients; `python -m
     pvpuformer_tpu_torch.demo --random-weights` as a process with REPL
     commands on stdin, which must write its mask; 10 user-click rounds of
     the bf16 and the int8 `Predictor` (p50 ms per round, the largest IoU
     difference between them, the launch checks with attention and
     LN+MLP 12 / 12 per round in bf16, 12 / 0 in int8; the replayed
     rounds' masks and IoUs
     bit-identical to the eager `user_click_step`'s) and one more
     `user_click_step` of each captured into a CUDA graph; f-BRS-B and
     RGB-BRS, 3 oracle clicks
     each at max_iters 20 (ms and functor evaluations per click; launches
     per click: one min-plus, 12 attention and LN+MLP forwards per full
     forward, 12 attention and LN+MLP backwards per RGB-BRS evaluation);
 16. the model families (models/registry.py): (a) each family's tiny f32
     5-click session (PlainVit and tests/test_zoo.py's tiny zoo configs) on
     the card against the CPU, identical clicks and IoU within 1e-5, and
     the tiny PlainVit's tiled_forward card against CPU (1e-4 of the
     largest logit); (b) PlainVit (SimpleClick) ViT-B@448 bf16, seeded
     random weights: two 20-click sessions through `Predictor` with the
     launch checks (12 attention, 12 LN+MLP, 1 min-plus a round), the
     replayed rounds against the eager `click_scan` (bit-identical, p50 ms
     per click of both, device time), 2 RGB-BRS clicks at max_iters 20
     (the attention backward and LN+MLP backward launches per
     evaluation), a 5-click box session (one launch of each CC kernel and
     two min-plus a round) and `tiled_forward` over 896 x 1344 (3 x 4
     tiles) against the same call with the attention and LN+MLP kernels'
     plain twins on the card (TILED_BF16_TOL of the largest logit) and
     against the same tiles' forward blended on the CPU; (c) each
     zoo family at its default config (HRNet-18s + OCR-64, DeepLab R50 ch
     256, MiT-b0, Swin-T, HRFormer-base, Swin-UNet), bf16, seeded random
     weights: two 5-click sessions with the launch checks (one min-plus a
     round), replayed rounds against the eager `click_scan`
     (bit-identical, p50 ms per click), and one f-BRS-A click of HRNet and
     DeepLab; one {"phase16": ...} JSON line with the p50s;
 17. scale-out (parallel/): (a) two ranks on this one card over gloo
     (NCCL refuses two ranks on one card), processes chip_smoke starts
     itself (`--worker scaleout`, `parallel.dist.init(backend="gloo")`):
     "replicated" ViT-B@448 bf16 training (width 768, its depth cut to
     SCALE_DEPTH for time throughout 17a), global batch 8 (4 rows a
     rank), 2 steps of 3 rounds each with a box round: both ranks' losses
     identical and within SCALE_LOSS_TOL of one process on the global
     batch, the wrapper launches per rank; then `BatchedEvaluator(mesh=)`
     with B = 16 (8 sessions a rank) x 20 clicks on 16 Synthetic objects
     against one process's B = 16: equal clicks, IoU within SCALE_IOU_TOL;
     then, in the same two processes, tensor parallelism on the (1, 2)
     mesh ("tp" and "tp+fsdp", ViT-B@448 bf16, both ranks on the global
     batch 8, 2 steps of 3 rounds): both ranks' losses identical and
     within SCALE_LOSS_TOL of the one process, the wrapper launches per
     rank exact (attention forward and backward depth a round on 6 heads,
     the tensor-parallel LN+MLP's launches (a) and (b') and its backward
     depth a round, the unsplit LN+MLP none), one traced "tp" step per rank
     showing (b') on the card, and the gathered "tp+fsdp" checkpoint
     loading strictly in one process (no speed claim: gloo goes through
     the host and the two ranks share the card);
     (b) FSDP at world size 1 under NCCL in a process of
     `torch.distributed.run --nproc-per-node 1` (`--worker fsdp`; it and
     (c) run beside (a), for time): the
     ViT-L recipe's `build_trainer` (width 1024, its depth cut to
     FSDP_DEPTH for time) in its default mode ("fsdp") against
     the same recipe unsharded, batch 4 of the synthetic raw source, 2
     steps of 3 rounds from the same batches and draws: losses and the
     checkpoints (whole parameters and Adam moments) within FSDP_TOL, the
     wrapper launches, and one more FSDP step traced by torch.profiler
     showing the attention forward and backward, LN+MLP, min-plus and CC
     kernels on the card; (c) `python -m torch.distributed.run
     --nproc-per-node 1 -m pvpuformer_tpu_torch.evaluate --batched 16
     --eval-mesh 1` exits 0 with its NoC table; ms per step at W = 1 / 2,
     the collectives per step, and the phase's and the script's seconds;
 18. the evaluation CLI's protocol flags, ViT-B@448 bf16, seeded random
     weights: (a) `python -m pvpuformer_tpu_torch.evaluate --random-weights
     NoBRS --cf-n=0 --acf --iou-analysis --save-ious --print-ious` (the
     repo launcher's flags) as a process, its pickled curves bit-identical
     to an in-process `evaluate_dataset` at target 1.01 on the same
     weights; (e) the same with --profile: the same curves, its p50 / p90 /
     p99 and memory line; (f, g) --vis-preds --clicks-limit 5 --model-name
     X (a process beside (a)): one PNG per sample of click rows x the panel's height, the header,
     the first 5 clicks equal to (a)'s; in process, sessions of 20 clicks
     through `Predictor` of (b) the CFR cascade (--cf-n 2 --cf-click 3
     --acf: three forwards a round, every round), (c) --eval-ritm (crop
     400, skip_clicks=1) and (d) --eval-mode fixed448,672, each with the
     launch checks, replayed rounds against the eager `click_scan`
     (bit-identical) and every round against the plain twins patched into
     `models.vit` on the card (the same click, probabilities within
     TILED_BF16_TOL); p50s at --cf-n 0 and --cf-n 2 without --acf; a
     5-click box session with the cascade (its launch checks, one host
     prompt draw a click); one {"phase18": ...} JSON line with the
     numbers and phase 3's checks at the protocol shapes;
 19. the int8 accuracy gate and reference checkpoints: (a)
     `gate_int8.gate` at the ViT-B / L / H widths (768, 1024, 1280; the
     depth-4 protocol config at 224), at the port's seeded init and after
     60 steps of `train_synthetic` (Adam 5e-5, the iterloss step on
     synthetic blobs), bf16 against int8 sessions of 24 samples x 6
     clicks: random init mean |dIoU| < 0.005 and max < 0.02, trained mean
     < 0.005 and p95 < 0.02 (the max and the divergence rate reported),
     the first click equal in every session, and the training loss lower
     over the last 10 steps than over the first 10, like against like
     (each step's loss over the mean of its num_iters); each run's
     summary on a {"gate": ...} line; (b) the ViT-B@448 VPU (depth 12, a
     28 x 28 grid) from a reference-named .pth (`load_vpu_checkpoint`)
     and HRNet-18s + OCR-64 from RITM-named keys
     (`convert_hrnet_checkpoint`, its OCR conv biases kept), each loaded
     strictly by `registry.load`: a 5-click f32 session on the card
     against the CPU's (identical clicks, IoU within 1e-5) and the first
     forward's logits (REF_LOGIT_TOL of the largest), then bf16 sessions
     with the launch checks and the replayed rounds against the eager
     `click_scan` (bit-identical); one {"phase19": ...} JSON line;
 20. the last model-side modules: (a) caption co-training (`VPUConfig.
     text`): one tiny f32 2-round caption step on the card against the
     CPU (loss and every gradient, clip_text's and caption_proj's among
     them, within CAPTION_TOL), then ViT-B@448 bf16 with the full CLIP text
     tower (ClipTextConfig(): 12 layers, width 512, context 77) at batch 8,
     3 steps of 3 rounds with byte_tokenizer captions and 3 without: ms
     per step, peak memory, the attention forward, its backward and the
     LN+MLP kernel 12 times a round each, min-plus and CC as the prompt
     types predict, the text tower's gradient norms, and no host sync
     more with captions than without (phase 9's counter); (b) the
     vision-language decoder at DecoderConfig() on the 28 x 28 grid, all
     four as_text x image_to_token forms with their intermediates, f32 on
     the card against the CPU (F32_TOL) and int8 against bf16 (cosine >
     DECODER_COS), ms per call; (c) the CLIP RN50 and ViT-B/16 towers at
     224 and the text encoder, each converted from a reference-named state
     dict and loaded strictly, f32 on the card against the CPU; (d) the
     token shuffle forward of ViT-B@448 bf16 against its plain twins and
     against the identity permutation (TILED_BF16_TOL), 12 attention and
     12 LN+MLP launches a forward; one {"phase20": ...} JSON line;
 21. the entry scripts: (a) `python -m pvpuformer_tpu_torch.prepare_data
     rehearse` (without --skip-large), started before phase 19 and run
     beside phases 19-21 for time: the fixtures of every real on-disk
     layout and the BASELINE configurations through six evaluation
     processes with --random-weights, ViT-B@448 for configs 1-3b, ViT-L@448
     with --iou-analysis --save-ious on SBD, ViT-H@448 --batched 2 on
     COCO_MVal, each at rc 0 with its NoC row and seconds (taken so);
     (b) the
     train-then-evaluate demo (`demo_train_eval_synthetic`) at its
     defaults in this process: 40 epochs of the tiny f32 VPU (loss and
     AdaptiveIoU every 8), then NoC@50 / NoC@80 of the random, trained and
     trained+int8 weights; the trained NoC@50 below the random one and the
     last logged AdaptiveIoU DEMO_IOU_GAIN above the first; the launches of
     its training steps (as phase 9 counts them) and of each row's eager
     and captured rounds (depth attention and one min-plus a round); (c)
     `hbm_fit` at its defaults in this process (ViT-B@448 bf16, batch 32,
     num_iters 1, 2, 3): every variant fits, its launches as phase 9
     counts them, its num_iters=3 peak beside phase 9's (HBM_FIT_TOL,
     reported); (d) `python -m pvpuformer_tpu_torch.bench_loader` reduced
     (LOADER_BENCH), after the rehearsal has ended: on-disk records/s of
     thread and process workers beside the recipe's demand; one
     {"phase21": ...} JSON line;
then one JSON line of kernel summaries (launches: the wrapper counts
summed over the paths of phases 5, 7, 9, 15, 16, 17, 18, 19, 20 and 21's
in-process parts), the card's name and power limit, and, last, {"ok":
true, "device": ...}.

LAUNCH CHECKS. A kernel wrapper counts its calls where it launches: in an
eager round and in the capture of a round, which records the launch into
a CUDA graph. Replaying the graph runs the kernels without a call, so the
counters cannot see a replay. `_launch_checks` therefore reads two
numbers for a run of rounds: the counters (zeroed just before the run,
read just after), which must equal the calls of the rounds that ran
eagerly or were captured (`graphs.rounds`), and, from the same run taken
again under torch.profiler (CUPTI traces each kernel of a replayed graph),
each hand-written kernel's launches on the card, which must equal its
calls per round times the rounds (phase 11's sequential run is traced for
one session of each canvas bucket, 40 of its 420 rounds).

    python3 chip_smoke.py --profile

instead runs phases 1-2 and then profiles ViT-B@448 bf16 clicks of the
click path and of the four prompt variants, and batched click rounds at B
= 8 and 16, each eager and replayed from its captured round, with
torch.profiler (CPU + CUDA activities): device time per round by kernel
group, launches per round, the device busy share under the profiler, and
the host-clock median of unprofiled rounds beside it; then the replayed
click round of PlainVit ViT-B@448 and of each zoo family at its default
config the same way (`profile_families`).

For time, the graph-cache workload runs two passes of sessions of 1, 3
and 10 clicks, phase 11 traces 2 of its sequential run's 21 sessions
(tracing all 21 cost phase 11 59-62 s of its 197-200 s), 17a runs ViT-B
at depth SCALE_DEPTH and 17b the ViT-L recipe at depth FSDP_DEPTH, 17b
and 17c run beside 17a, 18 (f, g) beside 18 (a), and phase 21's
rehearsal beside phases 19-21: none of those runs is a speed claim. On
an NVIDIA H100 80GB HBM3 at 700 W the whole script took 993.5 s with
phases 1-20 at full depth, and with phase 21 1031.9 s before the last
two overlaps and 1246.3 s on a host that ran every phase 10-110%
slower; the host moves the phases by 12-21% between calls. Phases 11,
17, 18 and 19 take 85-190 s each, and 185-238 s in all go to the launch
checks' profiler windows. Each phase's seconds are logged as it ends,
and the last lines print the whole script's.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
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
# phase 3, launch (b') (f32 out) against `fc2_partial_plain`: the same
# exact bf16 products summed in another order, atol 1e-3 + rtol 1e-4 (as
# tests/test_torch_cuda.py, where they matched on an H100)
FC2_PARTIAL_TOL = (1e-3, 1e-4)


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


# phase 3's checks at the shapes of the evaluation CLI's protocols, which
# phase 18 prints on its JSON line
PROTOCOL_SHAPES = {}


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
                f"  library ({yardstick}) {library_ms:.4f} ms, kernel / "
                f"{yardstick} {r[1] / library_ms:.2f}x"))
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
            # PlainVit's tiled_forward over 896 x 1344: 12 tiles in one
            # batch (phase 16b)
            ("tiled window", (48, 196, 12, 64), (torch.bfloat16,), both[:1]),
            ("tiled global", (12, 784, 12, 64), (torch.bfloat16,), both[:1]),
            ("ViT-L window", (8, 196, 16, 64), (torch.bfloat16,), both[:1]),
            ("ViT-L global", (2, 784, 16, 64), (torch.bfloat16,), both[:1]),
            ("ViT-H window", (8, 256, 16, 80), (torch.bfloat16,), both[:1]),
            ("ViT-H global", (2, 1024, 16, 80), (torch.bfloat16,), both[:1]),
            # the evaluation CLI's protocols (phase 18): --eval-ritm's 400
            # crop (grid 25 x 25, no windows: every block global), and
            # --eval-mode fixed448,672 (grid 28 x 42, windows 2 x 3)
            ("RITM-400 global", (2, 625, 12, 64), (torch.bfloat16,),
             both[:1]),
            ("fixed 448x672 window", (12, 196, 12, 64), (torch.bfloat16,),
             both[:1]),
            ("fixed 448x672 global", (2, 1176, 12, 64), (torch.bfloat16,),
             both[:1])):
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
                kern_dev = _device_ms(call) if bf16 else None
                record(name, r, label == "global" and bf16, bound, lib_ms,
                       (kern_dev, lib_dev))
                if label.startswith(("RITM", "fixed")):
                    PROTOCOL_SHAPES[f"{name} {tuple(shape)}"] = {
                        "ms": r[1], "plain_ms": r[2], "device_ms": kern_dev,
                        "bound_ms": bound[0], "bound_by": bound[1],
                        "max_abs_err": r[0], "sdpa_ms": lib_ms,
                        "sdpa_device_ms": lib_dev}
    # the attention backward at the training shapes, batch 32 (window
    # blocks 32 x 4 windows x 12 heads, global blocks 32 x 12 heads), bf16,
    # at the click path's flip batch (8 window blocks, 2 global), which
    # RGB-BRS and DistMap-BRS differentiate through, bf16, and at a small
    # shape in f32; the bf16 limit is ~2.5x the error measured on an H100
    # (3.9e-3), f32 as the forward. The bound counts the five N x N x D
    # products of the function (S, dV, dP, dQ, dK). Kernel and plain
    # version both start from the forward kernel's row statistics, as the
    # training path's backward does; the click shapes also log the
    # kernel's device time; so do the int8 gate's training shapes (phase
    # 19a: batch 4 at 224, one global window, ViT-B / L / H widths, head
    # dims 64 and 80)
    bf = torch.bfloat16
    for label, shape, dt in (("window", (128, 196, 12, 64), bf),
                             ("global", (32, 784, 12, 64), bf),
                             ("click window", (8, 196, 12, 64), bf),
                             ("click global", (2, 784, 12, 64), bf),
                             ("gate ViT-B", (4, 196, 12, 64), bf),
                             ("gate ViT-L", (4, 196, 16, 64), bf),
                             ("gate ViT-H", (4, 256, 16, 80), bf),
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
        call = lambda: fu.launch_attention_bwd(  # noqa: E731
            q, k, v, do, sc, st)
        r = _compare(f"fused_attention_bwd {label} {tuple(shape)} {dt}", call,
                     lambda: fu.fused_attention_bwd_plain(q, k, v, do, sc, st),
                     *((1e-2, 0.0) if bf16 else (1e-4, 1e-4)))
        dev_ms = (_device_ms(call) if label.startswith(("click", "gate"))
                  else None)
        record("fused_attention_bwd", r, label == "global", bound, lib_ms,
               device=(dev_ms, None))
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
    # (D, hidden, rows): ViT-B's click, batched B = 8, PlainVit's 12 tiles
    # (phase 16b) and training rows, the evaluation CLI's --eval-ritm (2 x
    # 625 tokens) and --eval-mode fixed448,672 (2 x 1176) rows (phase 18),
    # ViT-L's and ViT-H's click rows (2 x 784, 2 x 1024 tokens)
    for d, hid, rows in ((768, 3072, (1568, 16 * 784, 12 * 784, 32 * 784,
                                      2 * 625, 2 * 1176)),
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
            bound = _bound(4.0 * m * d * hid, PEAK_BF16,
                           2.0 * (2 * m * d + 2 * d * hid + hid + d)
                           + 4.0 * 2 * d)
            record("fused_ln_mlp", r, (m, d) == (1568, 768), bound,
                   device=(dev_ms, chain_ms), yardstick="cuBLAS chain",
                   extra={"chain_device_ms": chain_ms})
            if m in (2 * 625, 2 * 1176):
                PROTOCOL_SHAPES[f"fused_ln_mlp ({m},{d})"] = {
                    "ms": r[1], "plain_ms": r[2], "device_ms": dev_ms,
                    "bound_ms": bound[0], "bound_by": bound[1],
                    "max_abs_err": r[0], "chain_device_ms": chain_ms}
            del x
    # launch (b'), the tensor-parallel fc2 (`launch_fc2_partial`): ViT-B's
    # local hidden width at M = 2 (1536 of 3072) at phase 17's TP rows
    # (batch 8: 6272 tokens) and the training path's (batch 32: 25088), f32
    # out, against `fc2_partial_plain` (the same bf16 products summed in
    # another order), bit-identical on repeat; beside it the one PyTorch
    # call for the same function, torch.mm(h, w2, out_dtype=torch.float32)
    for m in (8 * 784, 32 * 784):
        hid, d = 1536, 768
        h = (torch.randn((m, hid), generator=g) * 0.5).to(dev, torch.bfloat16)
        w2 = (torch.randn((hid, d), generator=g) * 0.05).to(dev,
                                                            torch.bfloat16)
        call = lambda: fused_mlp.launch_fc2_partial(h, w2)  # noqa: E731
        r = _compare(f"fc2_partial ({m},{hid})->{d} bf16, f32 out", call,
                     lambda: fused_mlp.fc2_partial_plain(h, w2),
                     *FC2_PARTIAL_TOL)
        if not torch.equal(call(), call()):
            raise AssertionError("fc2_partial: not bit-identical on repeat")
        mm_call = lambda: torch.mm(h, w2, out_dtype=torch.float32)  # noqa
        lib_ms = _time_ms(mm_call)
        dev_ms, lib_dev = _device_ms(call), _device_ms(mm_call)
        bound = _bound(2.0 * m * hid * d, PEAK_BF16,
                       2.0 * (m * hid + hid * d) + 4.0 * m * d)
        record("fc2_partial", r, m == 8 * 784, bound, lib_ms,
               device=(dev_ms, lib_dev), yardstick="torch.mm")
        if m == 32 * 784:
            times["fc2_partial"].update(
                ms_train=r[1], plain_ms_train=r[2], device_ms_train=dev_ms,
                bound_ms_train=bound[0], library_ms_train=lib_ms,
                library_device_ms_train=lib_dev)
        del h, w2
    phase_native()
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


def phase_native():
    """The host-side distance maps (pvpuformer_tpu_torch/native): built with
    g++ on this machine, held bit for bit against their numpy twin at
    448 x 448 with 24 clicks (12 slots a layer, a few off the canvas and
    padding), delimiter 5 (inexact distances)."""
    from pvpuformer_tpu_torch import native
    t0 = time.perf_counter()
    lib = native.build()
    built = time.perf_counter() - t0
    r = np.random.default_rng(11)
    pts = np.full((24, 3), -1.0, np.float32)
    for j, i in enumerate(r.choice(24, size=20, replace=False)):
        pts[i] = (r.integers(-5, 453), r.integers(0, 448), j)
    t0 = time.perf_counter()
    got = native.get_dist_maps(pts, 448, 448, 5.0)
    c_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    want = native.get_dist_maps_numpy(pts, 448, 448, 5.0)
    py_ms = (time.perf_counter() - t0) * 1e3
    ok = got.shape == (2, 448, 448) and np.array_equal(got, want)
    _log(f"  native get_dist_maps (448 x 448, 24 clicks, delimiter 5): "
         f"built {lib.name} in {built:.1f} s; bit-identical to "
         f"get_dist_maps_numpy {ok}; C++ {c_ms:.1f} ms, numpy "
         f"{py_ms:.1f} ms (host) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("native get_dist_maps disagrees with its numpy "
                             "twin")


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


TRACE_TRIES = 3          # _launch_checks: traces taken at most
GUARD = 100              # _kernel_trace: spin kernels ahead of the call
GUARD_CYCLES = 5_000_000  # about 2.5 ms each at the H100's clock
TRACE_COST = {"windows": 0, "seconds": 0.0}   # every profiler session


def _kernel_trace(fn, sessions: int = 3):
    """fn() under torch.profiler (CUPTI; a CUDA graph's replay shows each
    kernel it runs): (fn()'s result, the names of the CUDA kernels and
    copies fn() launched, in the order they started).

    The profiler loses the first records of a session, and more of them
    the longer chip_smoke runs: a process's first session has come back
    empty, and on the H100 sessions kept 19 of 20 guard kernels of 5 ms in
    phase 5, 12 in phase 7 and none late in phase 11 (a process that only
    traced replayed rounds kept them all over 60 sessions). So each
    session first launches `guard` spin kernels (`torch.cuda._sleep`,
    GUARD of about 2.5 ms, 0.25 s in all), each behind a synchronize, and
    leaves them out of the names; a session that kept no spin kernel, or
    no kernel of fn(), is taken again with twice the guard (fn() runs
    again), at most `sessions` times. The callers that count kernels
    compare the counts with exact predictions (`_launch_checks` takes a
    short trace again).
    (The records' start times order kernels, not copies: a pageable
    copy's record can start before a kernel launched ahead of it.)"""
    import torch
    from torch.profiler import ProfilerActivity, profile
    guard = GUARD
    for _ in range(sessions):
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(guard):
                torch.cuda._sleep(GUARD_CYCLES)
                torch.cuda.synchronize()
            out = fn()
            torch.cuda.synchronize()
        seen = sorted((e.time_range.start, e.name) for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA)
        TRACE_COST["windows"] += 1
        TRACE_COST["seconds"] += time.perf_counter() - t0
        names = [name for _, name in seen if "spin_kernel" not in name]
        kept = len(seen) - len(names)
        if kept < guard:
            _log(f"    (the profiler kept {kept} of {guard} guard kernels)")
        if names and kept:
            return out, names
        guard *= 2
    raise AssertionError(f"the profiler kept no guard kernel or no kernel "
                         f"of the call in {sessions} sessions")


def _cuda_kernels(fn, sessions: int = 3):
    """The names of the CUDA kernels one call of `fn` launches (after one
    call to warm up)."""
    import torch
    fn()
    torch.cuda.synchronize()
    return _kernel_trace(fn, sessions)[1]


# the hand-written kernels' CUDA names (substrings) -> their wrapper; the
# fused and flash entries of csrc/attention.cu are one kernel (None: the
# attention wrapper the path calls)
KERNEL_NAMES = (("attention_fwd", None), ("minplus_envelope", "minplus_rows"),
                ("ln_fc1_gelu", "fused_ln_mlp"),
                ("flood_kernel<1>", "cc_labels"),
                ("flood_kernel<2>", "component_max"))


def _device_launches(fn, attn: str = "fused_attention"):
    """fn() with the launches it made on the card read from a profiler
    trace (`_kernel_trace`), graph replays included: (fn()'s result,
    {wrapper name: launches of its kernel}); the attention kernel's are
    counted under `attn`."""
    out, names = _kernel_trace(fn)
    counts = {w.__name__: 0 for w in _wrappers()}
    for name in names:
        for key, wrapper in KERNEL_NAMES:
            if key in name:
                counts[wrapper or attn] += 1
    return out, counts


def _launch_checks(fn, per_round, rounds: int, what: str,
                   attn: str = "fused_attention", traced=None,
                   sampled: bool = False):
    """The launch checks of a path whose rounds replay captured rounds
    (inference/graphs.py). fn() runs `rounds` rounds, each of which calls
    the wrappers `per_round` ({name: calls}) times. The counters are zeroed
    just before fn() and read just after: each wrapper must have counted
    the calls of the rounds that ran eagerly or were captured
    (graphs.rounds), since a replay calls nothing. Then fn()'s work runs
    again under the profiler (`_device_launches`), and each kernel must
    have run per_round x rounds times on the card. `traced`: (callable,
    its rounds) pairs that redo fn()'s work in parts, one profiler window
    each (default: fn() whole); with `sampled` they redo only some of its
    rounds (a sample of its sessions), and each kernel must have run
    per_round x those rounds times. The profiler loses records now and then
    (a few rounds' kernels of a window of tens of rounds, late in a run,
    on the H100) and never adds one, so a part's trace that falls short
    of its prediction is taken again, at most TRACE_TRIES times in all:
    an exact trace passes, and a count above the prediction fails at
    once. Returns (the first fn()'s result, the wrapper counts, the device
    launches)."""
    import torch
    from pvpuformer_tpu_torch.inference import graphs
    r0 = dict(graphs.rounds)
    _zero_counts()
    out = fn()
    torch.cuda.synchronize()
    calls = _counts()
    ran = {k: graphs.rounds[k] - r0[k] for k in r0}
    called = ran["eager"] + ran["captured"]
    want_calls = {k: per_round.get(k, 0) * called for k in calls}
    names = [w.__name__ for w in _wrappers()]
    parts = traced or [(fn, rounds)]
    traced_rounds = sum(n for _, n in parts)
    want_device = {k: per_round.get(k, 0) * traced_rounds for k in names}
    device, retaken = dict.fromkeys(names, 0), 0
    for part, n in parts:
        want = {k: per_round.get(k, 0) * n for k in names}
        for tries in range(TRACE_TRIES):
            got = _device_launches(part, attn)[1]
            if got == want or any(got[k] > want[k] for k in names):
                break
        retaken += tries
        for k in names:
            device[k] += got[k]
    ok = (calls == want_calls and device == want_device
          and ran["eager"] + ran["replayed"] == rounds
          and (traced_rounds < rounds if sampled
               else traced_rounds == rounds))
    _log(f"  {what}: rounds {ran} (of {rounds}); wrapper calls "
         f"{ {k: v for k, v in calls.items() if v} } (eager and captured "
         f"rounds); device launches (torch.profiler, {len(parts)} "
         f"window(s){f' over {traced_rounds} of the rounds' if sampled else ''}"
         f", {retaken} taken again) "
         f"{ {k: v for k, v in device.items() if v} } "
         f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(
            f"{what}: wrapper calls {calls} (want {want_calls}), device "
            f"launches {device} (want {want_device}), rounds {ran}")
    return out, calls, device


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
    # the batched prompt sessions' flip batch at B = 8 (2B masks)
    "batched": lambda: _blobs(5, 2 * EVAL_BATCHES[0], 448, 448, 12),
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
    from pvpuformer_tpu_torch.inference import graphs
    from pvpuformer_tpu_torch.inference.predictor import (Predictor,
                                                         PredictorConfig,
                                                         init_session)
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

    def check_session(ious, n):
        if not (np.isfinite(ious).all() and ious.shape == (n,)
                and (ious >= 0).all() and (ious <= 1).all()):
            raise AssertionError(f"bad IoU curve {ious}")
        if int(pred.state.click_count) != n:
            raise AssertionError(f"click_count {int(pred.state.click_count)}")

    def sessions():
        """Session 1 (its first round eager, its second captured), then
        session 2, timed per click: replayed rounds."""
        t0 = time.perf_counter()
        pred.set_input(image, gt)
        ious = pred.run_clicks(CLICKS)
        check_session(ious, CLICKS)
        first_s = time.perf_counter() - t0
        pred.set_input(image, gt)
        per_click, ious2 = [], []
        for _ in range(CLICKS):
            t = time.perf_counter()
            ious2.append(pred.next_click())        # float(iou) syncs
            per_click.append((time.perf_counter() - t) * 1e3)
        check_session(np.asarray(ious2), CLICKS)
        return ious, first_s, per_click

    flash_pred = Predictor(model, dataclasses.replace(pcfg, model=mcfg.replace(
        backbone=dataclasses.replace(mcfg.backbone, attn_impl="flash"))),
        device=dev)

    def flash_session():
        flash_pred.set_input(image, gt)
        ious3 = flash_pred.run_clicks(FLASH_CLICKS)
        if not (np.isfinite(ious3).all() and (ious3 >= 0).all()
                and (ious3 <= 1).all()):
            raise AssertionError(f"flash session IoUs {ious3}")
        return ious3

    def session():
        pred.set_input(image, gt)
        pred.run_clicks(CLICKS)

    graphs.clear()
    per_round = {"fused_attention": depth, "minplus_rows": 1,
                 "fused_ln_mlp": depth}
    (ious, first_s, per_click), total, _ = _launch_checks(
        sessions, per_round, 2 * CLICKS, "click sessions",
        traced=[(session, CLICKS)] * 2)
    ious3, flash_calls, _ = _launch_checks(
        flash_session, dict(per_round, fused_attention=0,
                            flash_attention=depth), FLASH_CLICKS,
        "flash session", attn="flash_attention")
    for k, v in flash_calls.items():
        total[k] += v
    _log(f"  session 1: {CLICKS} clicks in {first_s:.2f} s (incl. warm-up), "
         f"final IoU {ious[-1]:.4f}; session 2 median {np.median(per_click):.3f}"
         f" ms/click ({card}); flash session IoU {ious3[-1]:.4f}")
    state0 = init_session(image, gt, mcfg.num_max_points, (448, 448), dev)
    _replay_vs_eager(pred, state0, CLICKS, "click path", card)
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
                                                         click_step,
                                                         init_session)

    mcfg = model.cfg
    rng = np.random.default_rng(0)
    image = (rng.uniform(size=(448, 448, 3)) * 255).astype(np.uint8)
    gt = np.zeros((448, 448), np.float32)
    gt[96:352, 128:320] = 1.0
    depth = mcfg.backbone.depth
    total = {}
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

        def clicks(pred=pred):
            """PROMPT_CLICKS rounds, timed per click: the first eager, the
            second captured (a new key), then replays."""
            per_click, ious = [], []
            for _ in range(PROMPT_CLICKS):
                t = time.perf_counter()
                ious.append(pred.next_click())         # float(iou) syncs
                per_click.append((time.perf_counter() - t) * 1e3)
            return np.asarray(ious), per_click

        name = f"mode {mode} {'multi' if multi else 'points'}"
        per_round = {"fused_attention": depth, "minplus_rows": n_mp,
                     "fused_ln_mlp": depth, "cc_labels": n_cc,
                     "component_max": n_cm}
        (ious, per_click), counts, _ = _launch_checks(
            clicks, per_round, PROMPT_CLICKS, name)
        medians[name] = float(np.median(per_click))
        _log(f"  {name}: IoUs {np.round(ious, 4).tolist()}, median "
             f"{medians[name]:.3f} ms/click (first {per_click[0]:.1f} ms, "
             f"second {per_click[1]:.1f} ms; noise draw "
             f"{np.median(noise_ms):.3f} ms on the host) ({card})")
        if not (np.isfinite(ious).all() and (ious >= 0).all()
                and (ious <= 1).all()):
            raise AssertionError(f"{name}: bad IoU curve {ious}")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        _replay_vs_eager(pred, init_session(image, gt, mcfg.num_max_points,
                                            (448, 448), dev), CLICKS, name,
                         card)
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


def _replay_vs_eager(pred, state0, clicks: int, label: str, card: str):
    """The eager `click_scan` and `Predictor.run_clicks` (rounds replayed
    from a captured round, inference/graphs.py) from one state with the
    same prompt draws: every state field and the IoU curve bit-identical,
    or raise. Then, for each, the p50 ms per click on the host clock (one
    round and its IoU read) and the CUDA-event ms per click of a whole
    session queued back to back (for the replayed session the host stays
    ahead, so that is its device time)."""
    import torch
    from pvpuformer_tpu_torch.inference import graphs
    from pvpuformer_tpu_torch.inference.predictor import (NOISE_SEED,
                                                         _as_batch,
                                                         click_scan,
                                                         click_step)

    def gen():
        return torch.Generator().manual_seed(NOISE_SEED)

    def restart():
        pred.state = state0
        pred.gen.manual_seed(NOISE_SEED)

    with torch.no_grad():
        est, eious = click_scan(pred.model, pred.cfg, state0, clicks, gen())
    restart()
    rious = pred.run_clicks(clicks)
    same = (np.array_equal(eious.cpu().numpy(), rious)
            and all(torch.equal(a, b) for a, b in zip(est, pred.state)))
    eager_ms, replay_ms = [], []
    st, g = state0, gen()
    for _ in range(clicks):
        t = time.perf_counter()
        with torch.no_grad():
            st, iou = click_step(pred.model, pred.cfg, st, g)
        float(iou)
        eager_ms.append((time.perf_counter() - t) * 1e3)
    restart()
    for _ in range(clicks):
        t = time.perf_counter()
        pred.next_click()
        replay_ms.append((time.perf_counter() - t) * 1e3)

    def events(fn):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        with torch.no_grad():
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / clicks
    ev_eager = events(lambda: click_scan(pred.model, pred.cfg, state0,
                                         clicks, gen()))
    ev_replay = events(lambda: graphs.click_rounds(
        pred.model, pred.cfg, _as_batch(state0), clicks, gen()))
    out = {"eager_p50_ms": float(np.median(eager_ms)),
           "replay_p50_ms": float(np.median(replay_ms)),
           "eager_event_ms": ev_eager, "replay_device_ms": ev_replay}
    _log(f"  {label}: {clicks} replayed rounds against the eager click_scan"
         f" from one state: {'bit-identical' if same else 'DIFFER'} (click "
         f"slots, probabilities, IoU curve); p50 ms per click eager "
         f"{out['eager_p50_ms']:.3f}, replayed {out['replay_p50_ms']:.3f}; "
         f"CUDA-event ms per click of a session: eager "
         f"{ev_eager:.3f}, replayed {ev_replay:.3f} (device time) ({card})")
    if not same:
        raise AssertionError(f"{label}: replay {rious} eager "
                             f"{eious.cpu().numpy()}\nreplay points "
                             f"{pred.state.points} eager {est.points}")
    return out


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
    from pvpuformer_tpu_torch.ops.fused_mlp import fused_ln_mlp_tp
    for w in _wrappers():
        w.launches = 0
        if hasattr(w, "bwd_launches"):
            w.bwd_launches = 0
    # the tensor-parallel LN+MLP (phase 17's TP leg, `_tp_counts`)
    fused_ln_mlp_tp.launches = fused_ln_mlp_tp.epilogues = 0
    fused_ln_mlp_tp.bwd_launches = 0


def _tp_counts():
    """The tensor-parallel LN+MLP's counters: its forward calls (launches
    (a) and (b') each), their epilogues and its backward calls."""
    from pvpuformer_tpu_torch.ops.fused_mlp import fused_ln_mlp_tp as t
    return {"fused_ln_mlp_tp": t.launches, "fused_ln_mlp_tp_epilogue":
            t.epilogues, "fused_ln_mlp_tp_bwd": t.bwd_launches}


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
TRAIN_PEAK_GIB = {}       # phase 9's peak, held against phase 21's hbm_fit


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


def _host_syncs(fn):
    """fn() under torch's sync debug mode 'warn': {where: syncs}, each
    warning's innermost frame in the package, else its thread and the
    warning's own frame (autograd runs a CUDA backward on a thread of its
    own); phases 9 and 20 count a training step's so."""
    import threading
    import traceback
    import warnings
    import torch
    syncs = {}

    def record(message, category, filename, lineno, file=None, line=None):
        stack = traceback.extract_stack()
        # torch warns once a process as the mode is first set: not a sync
        if "synchroniz" not in str(message) or any(
                f.name == "set_sync_debug_mode" for f in stack):
            return
        frames = [f for f in stack if "pvpuformer_tpu_torch" in f.filename]
        where = (f"{frames[-1].filename.split('pvpuformer_tpu_torch/')[-1]}:"
                 f"{frames[-1].lineno} {frames[-1].name}") if frames else \
            f"{threading.current_thread().name} {filename}:{lineno} " + \
            " <- ".join(f"{os.path.basename(f.filename)}:{f.lineno} {f.name}"
                        for f in stack[-8:-1][::-1])
        syncs[where] = syncs.get(where, 0) + 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        shown = warnings.showwarning
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
            warnings.showwarning = shown
    torch.cuda.synchronize()
    return syncs


def _train_run(dev, card, cfg, seed, plan, b):
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
    peak_gb = TRAIN_PEAK_GIB["phase9"] = \
        torch.cuda.max_memory_allocated() / 2 ** 30
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
    syncs = _host_syncs(lambda: train_step(model, tx, batch, gen(), thr,
                                           cfg=cfg, num_iters=3, device=dev))
    _log(f"  host syncs in one 3-round step (sync debug mode 'warn'): "
         f"{sum(syncs.values())} {json.dumps(syncs)}")
    return counts


# kernel-name substrings -> group, first match wins (profile_paths)
EVAL_PARITY_CLICKS = 5    # phase 10, per object
EVAL_CLICKS = 20          # phase 11, per object
EVAL_BATCHES = (8, 16)    # phase 11's batch sizes
PRESET_CLICKS = 3         # phase 12, per preset


class _Slice:
    """Samples [lo, hi) of a dataset."""

    def __init__(self, ds, lo: int, hi: int):
        self.ds, self.lo, self.hi = ds, lo, min(hi, len(ds))

    def __len__(self):
        return self.hi - self.lo

    def get_sample(self, i):
        return self.ds.get_sample(self.lo + i)


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
def _patched(module, name, wrap):
    """module.name replaced by wrap(module.name) inside the block."""
    orig = getattr(module, name)
    setattr(module, name, wrap(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


@contextlib.contextmanager
def _batched_points(dataset, bev):
    """Collect the final click slots of every chunk that
    `bev.evaluate(dataset, ...)` runs (`graphs.click_rounds`, the eager
    `batched_click_scan` on the CPU); the yielded list is filled,
    after the block, with one (2N, 3) tensor per object in dataset order
    (the chunks' padding dropped). The evaluator's order: canvas bucket by
    bucket, chunk by chunk."""
    from pvpuformer_tpu_torch.inference import graphs
    log, out = [], []

    def record(scan):
        def recorded(*args):
            states, ious = scan(*args)
            log.append(states.points)
            return states, ious
        return recorded
    with _patched(graphs, "click_rounds", record):
        yield out
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


def _variant(mode: int, multi: bool) -> str:
    return ("clicks" if mode == 0 else
            f"mode {mode} {'multi' if multi else 'points'}")


def _chunk_runs(ds, bev, clicks: int, per_round, rounds: int, what: str,
                traced):
    """`bev.evaluate(ds)` on the card: its chunks replayed from the captured
    round (`graphs.click_rounds`), with the launch checks of
    `_launch_checks` (per_round, rounds, traced) and each chunk's replays
    counted,
    then with the eager `batched_click_scan` in graphs.click_rounds' place
    (its wrapper counts per_round x rounds). Returns ({"replayed" /
    "eager": (curves, click slots per object, stats, wrapper counts)},
    replays per chunk of the replayed run)."""
    from pvpuformer_tpu_torch.inference import batched, graphs
    per_chunk = []

    def per_chunk_count(scan):
        def run(*args):
            n0 = graphs.rounds["replayed"]
            out = scan(*args)
            per_chunk.append(graphs.rounds["replayed"] - n0)
            return out
        return run

    def replayed():
        per_chunk.clear()
        with _patched(graphs, "click_rounds", per_chunk_count), \
                _batched_points(ds, bev) as points:
            curves, _, stats = bev.evaluate(ds, max_clicks=clicks,
                                            max_iou_thr=0.95)
        return curves, points, stats, list(per_chunk)

    (curves, points, stats, chunks), counts, _ = _launch_checks(
        replayed, per_round, rounds, what, traced=traced)
    runs = {"replayed": (curves, points, stats, counts)}
    with _patched(graphs, "click_rounds",
                  lambda scan: batched.batched_click_scan), \
            _batched_points(ds, bev) as points:
        _zero_counts()
        curves, _, stats = bev.evaluate(ds, max_clicks=clicks,
                                        max_iou_thr=0.95)
        counts = _counts()
    runs["eager"] = (curves, points, stats, counts)
    return runs, chunks


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
    CUDA and on the CPU, the same port weights, for the click path and the
    four prompt variants (random prompts): identical click sequences, IoU
    within 1e-5, identical NoC lists; on each device batched = sequential
    (identical clicks, IoU within 1e-5)."""
    from pvpuformer_tpu_torch.inference.predictor import PredictorConfig
    for mode, multi in [(0, True)] + list(PROMPT_VARIANTS):
        _log(f"  {_variant(mode, multi)}:")
        _eval_parity(dev, PredictorConfig(
            model=tiny_config(), target_size=(64, 64), min_crop_size=32,
            prompt_mode=mode, as_multi_prompts=multi))


def _eval_parity(dev, cfg):
    import torch
    from pvpuformer_tpu_torch.inference.batched import BatchedEvaluator
    from pvpuformer_tpu_torch.inference.datasets import SyntheticDataset
    from pvpuformer_tpu_torch.inference.evaluation import (compute_noc_metric,
                                                           evaluate_dataset)
    from pvpuformer_tpu_torch.models.vpu import init_vpu

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

    per_round = {"fused_attention": depth, "minplus_rows": 1,
                 "fused_ln_mlp": depth}
    bounds = np.cumsum([0] + [n for n, _, _ in parts]).tolist()

    def chunk_parts(bev):
        """`bev`'s run again, one chunk at a time (a slice of at most B
        samples of one canvas bucket; one object each): (call, rounds)."""
        b = bev.batch_size
        return [(lambda lo=lo, hi=min(lo + b, hi): bev.evaluate(
                    _Slice(ds, lo, hi), max_clicks=EVAL_CLICKS,
                    max_iou_thr=0.95), EVAL_CLICKS)
                for lo_g, hi in zip(bounds, bounds[1:])
                for lo in range(lo_g, hi, b)]

    def run(label, fn, rounds, traced=None, sampled=False):
        """fn() -> (curves, elapsed) of `rounds` rounds, with the launch
        checks of `_launch_checks`."""
        (curves, elapsed), counts, device = _launch_checks(
            fn, per_round, rounds, label, traced=traced, sampled=sampled)
        _curves_ok(curves, n_obj, EVAL_CLICKS)
        clicks = sum(map(len, curves))
        res = {"curves": curves, "objects_per_sec": n_obj / elapsed,
               "clicks_per_sec": clicks / elapsed,
               "ms_per_round": elapsed / rounds * 1e3, "rounds": rounds,
               "launches_per_round": {k: v / sum(n for _, n in traced)
                                      if sampled else v / rounds
                                      for k, v in device.items() if v},
               "wrapper_calls": {k: v for k, v in counts.items() if v}}
        _log(f"  {label}: {n_obj} objects, {clicks} clicks in {rounds} "
             f"rounds, {elapsed:.3f} s: {res['objects_per_sec']:.3f} "
             f"objects/s, {res['clicks_per_sec']:.2f} clicks/s, "
             f"{res['ms_per_round']:.2f} ms per round ({card})")
        return res

    pred = _recording_predictor(model, pcfg, dev)
    pred.set_input(sample.image, sample.gt_mask(0))
    pred.run_clicks(2)                                   # warm-up
    pred.log.clear()

    def sequential():
        return evaluate_dataset(ds, pred, max_iou_thr=0.95,
                                max_clicks=EVAL_CLICKS)

    def sequential_part(i):
        """The sequential run's sample i again (the same sessions, through
        the same captured rounds): (the call, its rounds)."""
        return (lambda: evaluate_dataset(
            _Slice(ds, i, i + 1), _recording_predictor(model, pcfg, dev),
            max_iou_thr=0.95, max_clicks=EVAL_CLICKS),
            len(ds.get_sample(i).objects_ids) * EVAL_CLICKS)
    # the device launches of the sequential run are read from a trace of
    # one session of each canvas bucket (the first sample of each part)
    summary = {"sequential": run(
        "sequential", sequential, n_obj * EVAL_CLICKS,
        [sequential_part(i) for i in bounds[:-1]], sampled=True)}
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
            box.setdefault("curves", curves)
            box.setdefault("clicks", clicks)
            box.setdefault("stats", stats)
            return curves, elapsed
        n_chunks = sum(-(-n // b) for n, _, _ in parts)
        res = run(f"batched B={b}", batched, n_chunks * EVAL_CLICKS,
                  chunk_parts(bev))
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
    # chunks replayed against the eager batched_click_scan at B = 8: the
    # click path, a box and a scribble variant (multi-prompt protocol)
    b = EVAL_BATCHES[0]
    n_chunks = sum(-(-n // b) for n, _, _ in parts)
    for mode in (0, 1, 2):
        cfg_v = dataclasses.replace(pcfg, prompt_mode=mode)
        name = _variant(mode, True)
        n_cc, n_cm, n_mp = PROMPT_VARIANTS.get((mode, True), (0, 0, 1))
        rounds = n_chunks * EVAL_CLICKS
        want = {"fused_attention": depth, "fused_ln_mlp": depth,
                "minplus_rows": n_mp, "cc_labels": n_cc,
                "component_max": n_cm}
        bev = BatchedEvaluator(model, cfg_v, b, device=dev)
        runs, per_chunk = _chunk_runs(ds, bev, EVAL_CLICKS, want, rounds,
                                      f"{name} at B={b}, replayed",
                                      chunk_parts(bev))
        (rc, rp, rs, rn), (ec, ep, es, en) = runs["replayed"], runs["eager"]
        _curves_ok(rc, n_obj, EVAL_CLICKS)
        want = {k: want.get(k, 0) * rounds for k in en}
        same = (len(rc) == len(ec) == len(rp) == len(ep) == n_obj
                and all(np.array_equal(x, y) for x, y in zip(rc, ec))
                and all(torch.equal(x, y) for x, y in zip(rp, ep)))
        every = (len(per_chunk) == n_chunks
                 and all(k >= EVAL_CLICKS - 1 for k in per_chunk))
        res = {"replayed_clicks_per_sec": rs["clicks_per_sec"],
               "eager_clicks_per_sec": es["clicks_per_sec"],
               "replays_per_chunk": per_chunk,
               "wrapper_calls_replayed": {k: v for k, v in rn.items() if v}}
        if mode:
            seq_pred = _recording_predictor(model, cfg_v, dev)
            seq, seq_s = evaluate_dataset(ds, seq_pred, max_iou_thr=0.95,
                                          max_clicks=EVAL_CLICKS)
            seq_clk = torch.stack(seq_pred.log).cpu()
            res.update(
                sequential_clicks_per_sec=sum(map(len, seq)) / seq_s,
                same_clicks_share=float(np.mean(
                    [torch.equal(c, q) for c, q in zip(rp, seq_clk)])),
                max_abs_diou=max(float(np.abs(
                    x[:min(len(x), len(q))] - q[:min(len(x), len(q))]).max())
                    for x, q in zip(rc, seq)))
        _log(f"  {name} at B={b}, {n_chunks} chunks: replayed "
             f"{'=' if same else '!='} eager batched_click_scan (curves and "
             f"click slots, bit for bit); every chunk replayed the captured "
             f"round ({per_chunk} replays of {EVAL_CLICKS} rounds) "
             f"{'ok' if every else 'FAIL'}; {json.dumps(res)} ({card})")
        if not (same and every):
            raise AssertionError(f"{name} at B={b}: replayed chunks differ "
                                 f"from eager ones or did not replay")
        if en != want:
            raise AssertionError(f"{name} at B={b}: eager launches {en}, the "
                                 f"path calls the wrappers {want} times")
        summary[f"{name} replay vs eager B={b}"] = res
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


# phase 11's graph-cache workload: six canvas buckets met round robin
CACHE_SIZES = ((448, 448), (300, 500), (384, 512), (500, 300), (256, 320),
               (480, 640))
CACHE_PASSES = 2
CACHE_CLICKS = (1, 3, 10)
CACHE_GRAPHS = (4, 8)     # cache sizes compared (graphs.MAX_GRAPHS is 8)


def phase_graph_cache(dev, card: str):
    """Phase 11: what the captured rounds' cache (inference/graphs.py)
    costs and saves at ViT-B@448 bf16, random weights (seed 0).
    (a) Per key of the click path (B = 1), a scribble variant (mode 2
    multi, B = 1) and batched click rounds (B = 8): the host-clock ms of
    the key's first round (eager), second (captured, then replayed) and
    third (replayed), each ending in its IoU read, and the memory the card
    reserved after each (measured after one untimed pass over the keys).
    (b) Sequential NoC evaluation (`evaluate_dataset` through `Predictor`)
    of Synthetic samples in six canvas buckets taken round robin, so each
    bucket comes back only after the five others, CACHE_PASSES times, in
    sessions cut at CACHE_CLICKS clicks (max_clicks: the random weights
    cross no threshold): eager (graphs.replayed patched to False) and
    replayed with MAX_GRAPHS patched to each of CACHE_GRAPHS, each from an
    empty cache: seconds, ms per click, the rounds run eagerly, captured
    and replayed. Prints one {"graph_cache": ...} JSON line."""
    import torch
    from pvpuformer_tpu_torch.inference import graphs
    from pvpuformer_tpu_torch.inference.batched import resolve_batched_cfg
    from pvpuformer_tpu_torch.inference.datasets import SyntheticDataset
    from pvpuformer_tpu_torch.inference.evaluation import evaluate_dataset
    from pvpuformer_tpu_torch.inference.predictor import (NOISE_SEED,
                                                         Predictor,
                                                         PredictorConfig,
                                                         init_session,
                                                         stack_states)
    from pvpuformer_tpu_torch.models.vpu import init_vpu, vpu_base_config

    mcfg = vpu_base_config(dtype=torch.bfloat16)
    model = init_vpu(mcfg, torch.Generator().manual_seed(0), dev)
    pcfg = PredictorConfig(model=mcfg, target_size=(448, 448),
                           with_flip=True)
    rng = np.random.default_rng(0)
    image = (rng.uniform(size=(448, 448, 3)) * 255).astype(np.uint8)
    gt = np.zeros((448, 448), np.float32)
    gt[96:352, 128:320] = 1.0
    keys = (("click B=1", pcfg, 1),
            ("mode 2 multi B=1", dataclasses.replace(pcfg, prompt_mode=2), 1),
            ("click B=8", resolve_batched_cfg(pcfg), 8))
    out = {"card": card, "max_graphs": graphs.MAX_GRAPHS, "keys": {}}
    for timed in (False, True):
        graphs.clear()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        for label, cfg, b in keys:
            states = stack_states([init_session(
                image, gt, mcfg.num_max_points, (448, 448), dev)] * b)
            gen = torch.Generator().manual_seed(NOISE_SEED)
            ms, reserved = [], []
            for _ in range(3):
                t = time.perf_counter()
                states, iou = graphs.click_rounds(model, cfg, states, 1, gen)
                iou.cpu()
                ms.append((time.perf_counter() - t) * 1e3)
                reserved.append(torch.cuda.memory_reserved() / 2 ** 30)
            if timed:
                out["keys"][label] = {
                    "first_round_eager_ms": ms[0],
                    "second_round_capture_and_replay_ms": ms[1],
                    "third_round_replay_ms": ms[2],
                    "reserved_gib_after_each": reserved}
                _log(f"  {label}: rounds 1 (eager) / 2 (captured, replayed)"
                     f" / 3 (replayed) {ms[0]:.2f} / {ms[1]:.2f} / "
                     f"{ms[2]:.2f} ms; memory reserved after each "
                     f"{np.round(reserved, 3).tolist()} GiB ({card})")

    parts = [SyntheticDataset(n_samples=1, hw=hw, seed=100 * p + i)
             for p in range(CACHE_PASSES)
             for i, hw in enumerate(CACHE_SIZES)]
    ds = _Concat(parts)
    pred = Predictor(model, pcfg, device=dev)
    runs = {}
    for clicks in CACHE_CLICKS:
        for label, replay, size in (
                ("eager", False, graphs.MAX_GRAPHS),
                *((f"replayed, {n} graphs", True, n) for n in CACHE_GRAPHS)):
            graphs.clear()
            r0 = dict(graphs.rounds)
            with _patched(graphs, "replayed",
                          lambda f, replay=replay: lambda device: replay), \
                    _patched(graphs, "MAX_GRAPHS", lambda n, size=size: size):
                curves, elapsed = evaluate_dataset(
                    ds, pred, max_iou_thr=0.95, max_clicks=clicks)
                torch.cuda.synchronize()
            n = sum(map(len, curves))
            res = {"seconds": elapsed, "clicks": n, "objects": len(curves),
                   "ms_per_click": elapsed / n * 1e3,
                   "rounds": {k: graphs.rounds[k] - r0[k] for k in r0},
                   "reserved_gib": torch.cuda.memory_reserved() / 2 ** 30}
            runs[f"{clicks} clicks, {label}"] = res
            _log(f"  {len(curves)} objects in {len(CACHE_SIZES)} buckets, "
                 f"sessions of {clicks} clicks, {label}: {elapsed:.3f} s, "
                 f"{res['ms_per_click']:.2f} ms per click, rounds "
                 f"{res['rounds']} ({card})")
    graphs.clear()
    out["buckets"] = runs
    _log("  graph cache: " + json.dumps({"graph_cache": out}))
    del pred, model
    torch.cuda.empty_cache()


def phase_presets(dev, card: str):
    """Phase 12: one 3-click bf16 session each of ViT-L@448 and
    ViT-H@448 (patch 14, head dim 80), random weights, with the launch
    checks of `_launch_checks`."""
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
        depth = mcfg.backbone.depth

        def session():
            pred.set_input(image, gt)
            per_click, ious = [], []
            for _ in range(PRESET_CLICKS):
                t = time.perf_counter()
                ious.append(pred.next_click())         # float(iou) syncs
                per_click.append((time.perf_counter() - t) * 1e3)
            return np.asarray(ious), per_click
        (ious, per_click), _, _ = _launch_checks(
            session, {"fused_attention": depth, "minplus_rows": 1,
                      "fused_ln_mlp": depth}, PRESET_CLICKS, f"{name}@448")
        _log(f"  {name}@448 (D {mcfg.backbone.embed_dim}, depth {depth}, "
             f"patch {mcfg.backbone.patch_size[0]}, head dim "
             f"{mcfg.backbone.embed_dim // mcfg.backbone.num_heads}): IoUs "
             f"{np.round(ious, 4).tolist()}, ms per click "
             f"{np.round(per_click, 2).tolist()} (the first eager, the "
             f"second captured; weights built in {init_s:.1f} s) ({card})")
        if not (np.isfinite(ious).all() and (ious >= 0).all()
                and (ious <= 1).all()):
            raise AssertionError(f"{name}: bad IoU curve {ious}")
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
    """ViT-B@448 bf16: where a click round's device time goes, per path,
    eager and replayed from the captured round (inference/graphs.py): the
    click path and the four prompt variants one session at a time, and
    batched click sessions at B = 8 and 16 (per round of B clicks)."""
    import torch
    from pvpuformer_tpu_torch.inference import graphs
    from pvpuformer_tpu_torch.inference.batched import resolve_batched_cfg
    from pvpuformer_tpu_torch.inference.predictor import (Predictor,
                                                         PredictorConfig,
                                                         batched_click_step,
                                                         click_step,
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

        @torch.no_grad()
        def eager(pred=pred):
            pred.state, iou = click_step(pred.model, pred.cfg, pred.state,
                                         pred.gen)
            return float(iou)                       # the host read
        out[name + " eager"] = _profile_rounds(eager, card, name + " eager")
        out[name + " replayed"] = _profile_rounds(pred.next_click, card,
                                                  name + " replayed")
    bcfg = resolve_batched_cfg(PredictorConfig(
        model=mcfg, target_size=(448, 448), with_flip=True))
    for b in EVAL_BATCHES:
        box = [stack_states([init_session(image, gt, mcfg.num_max_points,
                                          (448, 448), dev)] * b)]

        @torch.no_grad()
        def step():
            box[0], iou = batched_click_step(model, bcfg, box[0])
            return iou.cpu()                        # the host read

        def replayed():
            box[0], iou = graphs.click_rounds(model, bcfg, box[0], 1)
            return iou.cpu()
        out[f"batched B={b} eager"] = _profile_rounds(
            step, card, f"batched B={b} eager (per round)")
        out[f"batched B={b} replayed"] = _profile_rounds(
            replayed, card, f"batched B={b} replayed (per round)")
    return out



def profile_families(dev, card: str):
    """`--profile`, second part: where a replayed click round's device time
    goes for PlainVit ViT-B@448 and each zoo family at its default config
    (bf16, seeded random weights; the sessions of phase 16)."""
    import torch
    from pvpuformer_tpu_torch.inference import graphs
    from pvpuformer_tpu_torch.inference.predictor import (Predictor,
                                                         PredictorConfig)
    from pvpuformer_tpu_torch.models import registry
    rng = np.random.default_rng(0)
    image = (rng.uniform(size=(448, 448, 3)) * 255).astype(np.uint8)
    gt = np.zeros((448, 448), np.float32)
    gt[96:352, 128:320] = 1.0
    out = {}
    for cfg in [plainvit_b448(torch.bfloat16)] + zoo_defaults(torch.bfloat16):
        name = type(cfg).__name__
        graphs.clear()
        torch.cuda.empty_cache()
        model = registry.build(cfg, torch.Generator().manual_seed(0), dev)
        pred = Predictor(model, PredictorConfig(
            model=cfg, target_size=(448, 448), with_flip=True), device=dev)
        pred.set_input(image, gt)
        out[name + " replayed"] = _profile_rounds(pred.next_click, card,
                                                  name + " replayed")
        del pred, model
    graphs.clear()
    return out

ROOT = os.path.dirname(os.path.abspath(__file__))
TINY_RECIPE = "pvpuformer_tpu_torch/recipes/iSegNet/vpu_tiny_synthetic.py"
RECIPE_STEPS = 4          # phase 13b: one epoch of the shipped recipe
RECIPE_HW = (480, 640)    # phase 13b: a COCO-sized raw image
LOADER_WORKERS = 4        # train.py's default --workers
WAIT_SHARE = 0.05         # phase 13b: the loader keeps ahead below this


def _start(args, cwd):
    """`python -m <args>` started from `cwd` with this checkout on the path,
    leading a session of its own: (the process, its start time)."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.Popen([sys.executable, "-m", *args], cwd=cwd, env=env,
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True), time.perf_counter()


def _stop(started) -> None:
    """Kill every process of a started process's session, unless it has
    ended."""
    import signal
    proc, _ = started
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()


def _finish(started, what: str, stdin: str = "", timeout: int = 600):
    """A started process's output, after a 0 exit code, and its seconds
    from its start; `stdin` is its input. At `timeout` seconds its
    session's every process is killed (the rehearsal of phase 21 starts
    processes of its own)."""
    proc, t = started
    try:
        stdout, stderr = proc.communicate(stdin, timeout=timeout)
    except subprocess.TimeoutExpired:
        _stop(started)
        raise AssertionError(f"{what} ran past {timeout} s and was killed")
    secs = time.perf_counter() - t
    if proc.returncode != 0:
        raise AssertionError(f"{what} exited {proc.returncode}:\n"
                             f"{stdout[-3000:]}\n{stderr[-3000:]}")
    return stdout, secs


def _subprocess(args, cwd, what: str, stdin: str = "", timeout: int = 600):
    """`python -m <args>` from `cwd` (`_start`, `_finish`): its output and
    seconds."""
    return _finish(_start(args, cwd), what, stdin, timeout)


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


SERVE_SCRIPT = ([("click", 220, 200, True), ("click", 300, 120, True),
                 ("click", 60, 60, False), ("click", 250, 330, True),
                 ("click", 400, 420, False), ("undo",), ("finish",)]
                + [("click", x, y, p) for x, y, p in
                   ((80, 100, True), (120, 60, True), (30, 200, False))])
USER_CLICKS = [(200.5, 220.25, True), (300.0, 120.0, True),
               (60.0, 60.0, False), (250.75, 330.5, True),
               (400.0, 420.0, False), (180.0, 240.0, True),
               (100.0, 380.0, False), (330.0, 200.0, True),
               (220.0, 160.0, True), (20.0, 20.0, False)]
BRS_PARITY_ITERS = 3      # phase 14's BRS sessions
BRS_CLICKS = 3            # phase 15's BRS sessions, at max_iters 20


def _drive(controller, image, script):
    """A controller through a click script (phase 15's served sessions)."""
    controller.set_image(image)
    for op, *args in script:
        if op == "click":
            controller.add_click(*args)
        elif op == "undo":
            controller.undo_click()
        else:
            controller.finish_object()
    return controller.result_mask


def phase_serving_parity(dev):
    """Phase 14: the serving surface at the tiny config, f32, CUDA vs the
    CPU (same port weights): a controller session (clicks, undo, finish,
    init mask, a click outside the 60 x 90 image), an int8 Predictor
    session, one session of each BRS mode at max_iters 3, and the int8
    linear at the ViT-B@448 click shapes and a padded small one."""
    import torch
    from pvpuformer_tpu_torch import nn
    from pvpuformer_tpu_torch.inference.brs import get_predictor
    from pvpuformer_tpu_torch.inference.controller import InteractiveController
    from pvpuformer_tpu_torch.inference.predictor import (Predictor,
                                                         PredictorConfig)
    from pvpuformer_tpu_torch.models.vpu import init_vpu

    g = torch.Generator().manual_seed(3)
    for m, k, n, dt in ((1568, 768, 2304, torch.bfloat16),
                        (1568, 3072, 768, torch.bfloat16),
                        (5, 20, 12, torch.float32)):
        lin = nn.Linear(k, n, g=g)
        q = nn.quantize_params(lin, min_in_dim=1, dtype=dt)
        if not isinstance(q, nn.QuantLinear):
            raise AssertionError("the linear was not quantized")
        x = (torch.randn((2, m // 2 or 1, k), generator=g) * 2).to(dt)
        want = nn.linear(q, x)
        got = nn.linear(q.to(dev), x.to(dev)).cpu()
        same = torch.equal(got, want)
        _log(f"  int8 linear {tuple(x.shape)} @ ({k}, {n}) {dt}: cuda "
             f"{'bit-identical to' if same else 'DIFFERS from'} the CPU")
        if not same:
            raise AssertionError("the int8 linear differs on the card")

    cfg = PredictorConfig(model=tiny_config(), target_size=(64, 64),
                          min_crop_size=32)
    r = np.random.default_rng(7)
    image = (r.uniform(size=(60, 90, 3)) * 255).astype(np.uint8)
    gt = np.zeros((60, 90), np.float32)
    gt[14:50, 18:46] = 1.0
    square = np.zeros((60, 90), np.float32)
    square[8:24, 8:24] = 1.0
    out = {}
    for where in ("cpu", dev):
        model = init_vpu(cfg.model, torch.Generator().manual_seed(1), "cpu")
        c = InteractiveController(model, cfg, device=where)
        c.set_image(image)
        for x, y, pos in ((30, 20, True), (50, 40, False),
                          (70.5, 12.5, True)):
            c.add_click(x, y, pos)
        c.undo_click()
        c.finish_object()
        c.set_mask(square)
        c.add_click(16, 16, True)
        c.add_click(95, 10, False)            # outside the image
        ctl = (c.result_mask, c.current_object_prob, c.get_visualization())
        pred = Predictor(model, cfg, device=where, int8=True)
        pred.set_input(image, gt)
        q8 = (pred.run_clicks(5), pred.clicks)
        brs = {}
        for mode in ("f-BRS-A", "f-BRS-B", "f-BRS-C", "RGB-BRS",
                     "DistMap-BRS"):
            bp = get_predictor(model, cfg, mode, max_iters=BRS_PARITY_ITERS,
                               device=where)
            bp.set_input(image, gt)
            brs[mode] = (bp.run_clicks(3), bp.clicks)
        out[str(where)] = ctl, q8, brs
    (ctl_c, q8_c, brs_c), (ctl_g, q8_g, brs_g) = out["cpu"], out[str(dev)]
    err = float(np.abs(ctl_c[1] - ctl_g[1]).max())
    ok = (np.array_equal(ctl_c[0], ctl_g[0]) and err <= 1e-5
          and np.array_equal(ctl_c[2], ctl_g[2]))
    _log(f"  controller session (3 clicks, undo, finish, init mask, 2 clicks):"
         f" result masks {'identical' if np.array_equal(ctl_c[0], ctl_g[0]) else 'DIFFER'}"
         f", panels {'identical' if np.array_equal(ctl_c[2], ctl_g[2]) else 'DIFFER'}"
         f", max |dprob|={err:.2e} (tol 1e-5) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("controller session differs on the card")
    # int8: a last-bit difference upstream of a quantized linear can move a
    # value across a rounding boundary, so the session carries ~1e-3 of IoU
    # noise (tests/test_torch_quant.py); the first click is the gt's EDT
    err = float(np.abs(q8_c[0] - q8_g[0]).max())
    first = q8_c[1][:, 2] == 0
    same = np.array_equal(q8_c[1], q8_g[1])
    ok = np.array_equal(q8_c[1][first], q8_g[1][first]) and err <= 5e-3
    _log(f"  int8 Predictor 5 clicks: clicks "
         f"{'identical' if same else 'part after the first'}, max |dIoU|="
         f"{err:.2e} (tol 5e-3, first click identical) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"int8 session: cpu {q8_c}\ncuda {q8_g}")
    for mode in brs_c:
        (iou_c, clk_c), (iou_g, clk_g) = brs_c[mode], brs_g[mode]
        err = float(np.abs(iou_c - iou_g).max())
        ok = np.array_equal(clk_c, clk_g) and err <= 1e-3
        _log(f"  {mode} 3 clicks at max_iters {BRS_PARITY_ITERS}: clicks "
             f"{'identical' if np.array_equal(clk_c, clk_g) else 'DIFFER'}, "
             f"max |dIoU|={err:.2e} (tol 1e-3) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{mode}: cpu {iou_c} {clk_c}\n"
                                 f"cuda {iou_g} {clk_g}")


def _png_b64(arr):
    import base64
    import io
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode("ascii")


def _png(b64):
    import base64
    import io
    from PIL import Image
    return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))))


def _http(base, path, payload=None, method=None):
    import urllib.request
    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(base + path, data=data, method=method)
    if data is not None:
        req.add_header("Content-Type", "application/json")
    with urllib.request.urlopen(req, timeout=300) as resp:
        return json.loads(resp.read())


def _serve_session(base, image, script, out, key):
    """One client session over HTTP: the script's requests, then /mask and
    /vis, then delete; the /click latencies in ms."""
    sid = _http(base, "/session", {"image": _png_b64(image)})["session"]
    lat = []
    for op, *args in script:
        if op == "click":
            x, y, pos = args
            t = time.perf_counter()
            _http(base, "/click", {"session": sid, "x": x, "y": y,
                                   "positive": pos})
            lat.append((time.perf_counter() - t) * 1e3)
        else:
            _http(base, "/" + op, {"session": sid})
    mask = _png(_http(base, f"/mask?session={sid}", method="GET")["mask"])
    vis = _png(_http(base, f"/vis?session={sid}", method="GET")["image"])
    _http(base, f"/session?session={sid}", method="DELETE")
    out[key] = mask, vis, lat


def _user_session(pred, image, gt, clicks):
    """User clicks through a Predictor: (IoUs against gt, ms per round and
    each round's probabilities)."""
    pred.set_input(image, gt)
    ious, ms, probs = [], [], []
    for y, x, pos in clicks:
        t = time.perf_counter()
        ious.append(pred.user_click(y, x, pos))        # float(iou) syncs
        ms.append((time.perf_counter() - t) * 1e3)
        probs.append(pred.state.prev_probs)
    return np.asarray(ious), ms, probs


def _user_eager(pred, image, gt, clicks):
    """The same user clicks through the eager `user_click_step` from the
    state `pred.set_input` makes: (IoUs, each round's probabilities)."""
    import torch
    from pvpuformer_tpu_torch.inference.predictor import user_click_step
    pred.set_input(image, gt)
    st, dev, ious, probs = pred.state, pred.device, [], []
    for y, x, pos in clicks:
        with torch.no_grad():
            st, iou = user_click_step(
                pred.model, pred.cfg, st, torch.tensor(float(y), device=dev),
                torch.tensor(float(x), device=dev),
                torch.tensor(bool(pos), device=dev))
        ious.append(float(iou))
        probs.append(st.prev_probs)
    return np.asarray(ious), probs


def _round_counts(counts, want, what):
    for i, c in enumerate(counts):
        got = {k: v for k, v in c.items() if v}
        if got != {k: v for k, v in want.items() if v}:
            raise AssertionError(f"{what} round {i}: launches {got}, "
                                 f"predicted {want}")


def phase_serving(dev, card: str):
    """Phase 15: the serving surface at ViT-B@448 bf16, random weights
    (seed 0), one model for every session: the HTTP service in process
    with two concurrent client sessions (masks bit-equal to controllers
    driven directly), the demo REPL as a process, user-click rounds of the
    bf16 and int8 predictors (p50, launches per round, one round of each
    captured into a CUDA graph), f-BRS-B and RGB-BRS oracle sessions at
    max_iters 20. Returns the launches of its paths, summed."""
    import tempfile
    import threading
    import torch
    from pvpuformer_tpu_torch import nn, serve
    from pvpuformer_tpu_torch.inference.brs import get_predictor
    from pvpuformer_tpu_torch.inference.controller import InteractiveController
    from pvpuformer_tpu_torch.inference.predictor import (Predictor,
                                                         PredictorConfig,
                                                         user_click_step)
    from pvpuformer_tpu_torch.models.vpu import init_vpu, vpu_base_config

    mcfg = vpu_base_config(dtype=torch.bfloat16)
    model = init_vpu(mcfg, torch.Generator().manual_seed(0), dev)
    # the demo's and the service's configuration (demo.build_model)
    pcfg = PredictorConfig(model=mcfg, target_size=mcfg.backbone.img_size,
                           prob_thresh=0.49, limit_longest_side=800)
    images = [(np.random.default_rng(s).uniform(size=(448, 448, 3)) * 255
               ).astype(np.uint8) for s in (0, 1)]
    depth = mcfg.backbone.depth
    total = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    # --- the HTTP service, two concurrent client sessions ---
    srv = serve.build_server(
        lambda: InteractiveController(model, pcfg, device=dev), "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    served = {}
    try:
        _serve_session(base, images[0], SERVE_SCRIPT[:2], {}, "warm-up")
        clients = [threading.Thread(target=_serve_session,
                                    args=(base, images[i], SERVE_SCRIPT,
                                          served, i)) for i in (0, 1)]
        t = time.perf_counter()
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=600)
        both_s = time.perf_counter() - t
        if any(c.is_alive() for c in clients) or len(served) != 2:
            raise AssertionError("a client session did not finish")
        alone = {}
        _serve_session(base, images[0], SERVE_SCRIPT, alone, "alone")
        if _http(base, "/healthz")["sessions"] != 0:
            raise AssertionError("sessions left after delete")
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)
    for i in (0, 1):
        c = InteractiveController(model, pcfg, device=dev)
        want = _drive(c, images[i], SERVE_SCRIPT)
        mask, vis, _ = served[i]
        same = np.array_equal(mask, want) and np.array_equal(
            vis, c.get_visualization())
        _log(f"  served session {i}: mask objects "
             f"{sorted(set(np.unique(mask).tolist()))}, mask and panel "
             f"{'bit-identical to' if same else 'DIFFER from'} a controller "
             f"driven directly")
        if not same or mask.shape != (448, 448):
            raise AssertionError(f"served session {i} differs")
    lat2 = served[0][2] + served[1][2]
    click_p50 = float(np.median(alone["alone"][2]))
    _log(f"  /click p50 {click_p50:.2f} ms with one client, "
         f"{np.median(lat2):.2f} ms with two concurrent clients (two "
         f"sessions of {len(SERVE_SCRIPT)} requests in {both_s:.2f} s) "
         f"({card})")

    # --- the demo REPL as a process ---
    with tempfile.TemporaryDirectory() as tmp:
        out, secs = _subprocess(
            ["pvpuformer_tpu_torch.demo", "--random-weights"], tmp,
            "the demo", stdin="p 220 200\np 300 120\nn 60 60\nundo\n"
                              "finish\np 80 100\nsave mask.png\n"
                              "vis vis.png\nquit\n")
        from PIL import Image
        path = os.path.join(tmp, "mask.png")
        mask = np.asarray(Image.open(path)) if os.path.exists(path) else None
        ok = (mask is not None and mask.shape == (448, 448)
              and set(np.unique(mask)) <= {0, 1, 2}
              and os.path.exists(os.path.join(tmp, "vis.png"))
              and "object 1 saved" in out)
        _log(f"  python -m pvpuformer_tpu_torch.demo --random-weights with "
             f"REPL commands on stdin: rc 0 in {secs:.1f} s, mask "
             f"{None if mask is None else mask.shape} objects "
             f"{None if mask is None else sorted(set(np.unique(mask).tolist()))}"
             f" {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"the demo wrote no mask:\n{out[-2000:]}")

    # --- user-click rounds, bf16 and int8, launches per round ---
    gt = np.zeros((448, 448), np.float32)
    gt[96:352, 128:320] = 1.0
    side = torch.cuda.Stream()
    res = {}
    for name, int8 in (("bf16", False), ("int8", True)):
        pred = Predictor(model, pcfg, device=dev, int8=int8)
        want = {"fused_attention": depth,
                "fused_ln_mlp": 0 if int8 else depth}
        # a warm-up session (its first round eager, its second captured),
        # then the session measured, replayed
        _, counts, _ = _launch_checks(
            lambda: _user_session(pred, images[0], gt, USER_CLICKS[:2]),
            want, 2, f"{name} user clicks, warm-up")
        add(counts)
        (ious, ms, probs), counts, _ = _launch_checks(
            lambda: _user_session(pred, images[0], gt, USER_CLICKS),
            want, len(USER_CLICKS), f"{name} user clicks")
        add(counts)
        e_ious, e_probs = _user_eager(pred, images[0], gt, USER_CLICKS)
        same = np.array_equal(ious, e_ious) and all(
            torch.equal(a, b) for a, b in zip(probs, e_probs))
        if not (np.isfinite(ious).all() and (ious >= 0).all()
                and (ious <= 1).all()):
            raise AssertionError(f"{name}: bad IoUs {ious}")
        y, x, pos = (torch.tensor(v, device=dev) for v in (150.0, 150.0,
                                                            True))
        with torch.no_grad():
            _capture(lambda: user_click_step(pred.model, pred.cfg,
                                             pred.state, y, x, pos), side)
        res[name] = ious, ms
        _log(f"  {name} user clicks: p50 {np.median(ms):.2f} ms per round "
             f"over {len(ms)} rounds ({card}); IoUs "
             f"{np.round(ious, 4).tolist()}; the replayed rounds' masks "
             f"and IoUs "
             f"{'bit-identical to' if same else 'DIFFER from'} the eager "
             f"user_click_step's; one more user_click_step captured into a "
             f"CUDA graph (no host sync)")
        if not same:
            raise AssertionError(f"{name} user clicks: replayed {ious}, "
                                 f"eager {e_ious}")
        del pred
    dious = float(np.abs(res["int8"][0] - res["bf16"][0]).max())
    _log(f"  int8 against bf16 over the same {len(USER_CLICKS)} user clicks:"
         f" max |dIoU| {dious:.4f}, p50 {np.median(res['int8'][1]):.2f} vs "
         f"{np.median(res['bf16'][1]):.2f} ms ({card})")

    # --- BRS oracle sessions at the default max_iters 20 ---
    brs = {}
    for mode in ("f-BRS-B", "RGB-BRS"):
        bp = get_predictor(model, pcfg, mode, device=dev)
        bp.set_input(images[0], gt)
        bp.next_click()                                         # warm-up
        bp.set_input(images[0], gt)
        ms, evals, ious = [], [], []
        for _ in range(BRS_CLICKS):
            _zero_counts()
            e0 = bp.evaluations
            t = time.perf_counter()
            ious.append(bp.next_click())
            ms.append((time.perf_counter() - t) * 1e3)
            torch.cuda.synchronize()
            ev = bp.evaluations - e0
            counts = _counts()
            add(counts)
            evals.append(ev)
            full = ev + 1 if mode == "RGB-BRS" else 1
            want = {"fused_attention": depth * full,
                    "fused_ln_mlp": depth * full, "minplus_rows": 1,
                    "fused_attention_bwd": depth * ev if mode == "RGB-BRS"
                    else 0,
                    "fused_ln_mlp_bwd": depth * ev if mode == "RGB-BRS"
                    else 0}
            _round_counts([counts], want, f"{mode} click")
        ious = np.asarray(ious)
        if not (np.isfinite(ious).all() and (ious >= 0).all()
                and (ious <= 1).all()):
            raise AssertionError(f"{mode}: bad IoUs {ious}")
        brs[mode] = {"ms_per_click": ms, "evaluations": evals,
                     "ious": ious.tolist()}
        _log(f"  {mode} {BRS_CLICKS} oracle clicks at max_iters 20: ms per "
             f"click {np.round(ms, 1).tolist()}, functor evaluations "
             f"{evals} ({card}); IoUs {np.round(ious, 4).tolist()}; "
             f"launches per click as predicted (attention and LN+MLP "
             f"forward {depth} per full forward, their backwards {depth} per"
             f" RGB-BRS evaluation, one min-plus)")
        del bp
    summary = {"card": card,
               "user_click_p50_ms": {k: float(np.median(v[1]))
                                     for k, v in res.items()},
               "click_request_p50_ms": {"one client": click_p50,
                                        "two clients": float(
                                            np.median(lat2))},
               "int8_max_abs_diou": dious, "brs": brs}
    _log("  phase 15 summary: " + json.dumps(summary))
    del model
    return total


FAMILY_CLICKS = 5         # phase 16: clicks of each family's session
PLAINVIT_BRS_CLICKS = 2   # phase 16b: RGB-BRS oracle clicks at max_iters 20
TILE_CANVAS = (896, 1344)  # phase 16b: tiled_forward's canvas (3 x 4 tiles)
# phase 16b: tiled_forward's kernels vs their plain twins on the card, bf16,
# of max(1, the largest |logit|): ~2.5x the 1.17e-2 measured on an H100
# (3 ulps at the logits' scale; PERF.md, Findings)
TILED_BF16_TOL = 3e-2


def tiny_families():
    """Phase 16a's configs: a tiny PlainVit (depth 4, 64 x 64, windowed
    blocks) and the zoo's tiny configs of tests/test_zoo.py, with
    Swin-UNet's of its test_swin_unet_forward."""
    from pvpuformer_tpu_torch.models.fpn import NeckConfig
    from pvpuformer_tpu_torch.models.plainvit import PlainVitConfig
    from pvpuformer_tpu_torch.models.seg_head import HeadConfig
    from pvpuformer_tpu_torch.models.vit import ViTConfig
    from pvpuformer_tpu_torch.models.zoo.deeplab import DeeplabISConfig
    from pvpuformer_tpu_torch.models.zoo.hrformer import HRFormerISConfig
    from pvpuformer_tpu_torch.models.zoo.hrnet import HRNetISConfig
    from pvpuformer_tpu_torch.models.zoo.segformer import SegformerISConfig
    from pvpuformer_tpu_torch.models.zoo.swin import SwinISConfig
    from pvpuformer_tpu_torch.models.zoo.swin_unet import SwinUNetISConfig
    n = dict(num_max_points=6)
    return [
        PlainVitConfig(
            backbone=ViTConfig(img_size=(64, 64), patch_size=(16, 16),
                               embed_dim=64, depth=4, num_heads=2,
                               window_pixels=32),
            neck=NeckConfig(in_dim=64, out_dims=(16, 32, 48, 64),
                            img_size=(64, 64), hide_dim=64),
            head=HeadConfig(in_channels=(16, 32, 48, 64), channels=32,
                            d_model=64, ed_loss=False), **n),
        SegformerISConfig(embed_dims=(16, 32, 48, 64), depths=(1, 1, 1, 1),
                          num_heads=(1, 2, 3, 4), head_channels=32, **n),
        HRNetISConfig(width=8, small=True, ocr_width=16, **n),
        DeeplabISConfig(ch=32, **n),
        SwinISConfig(embed_dim=16, depths=(1, 1, 1, 1),
                     num_heads=(1, 2, 4, 8), head_channels=16, window=4, **n),
        HRFormerISConfig(width=8, num_heads=(1, 2, 4, 8), num_units=(1, 1, 1),
                         window=4, ocr_width=16, **n),
        SwinUNetISConfig(embed_dim=16, depths=(1, 1, 1, 1),
                         num_heads=(1, 2, 4, 8), window=4, **n)]


def plainvit_b448(dtype):
    """Phase 16b: PlainVit's default config, SimpleClick ViT-B@448."""
    from pvpuformer_tpu_torch.models.plainvit import PlainVitConfig
    return PlainVitConfig(dtype=dtype)


def zoo_defaults(dtype):
    """Phase 16c: each zoo family at its default config: HRNet-18s +
    OCR-64, DeepLab R50 ch 256, MiT (32, 64, 160, 256), Swin-T,
    HRFormer-base, Swin-UNet."""
    from pvpuformer_tpu_torch.models.zoo.deeplab import DeeplabISConfig
    from pvpuformer_tpu_torch.models.zoo.hrformer import HRFormerISConfig
    from pvpuformer_tpu_torch.models.zoo.hrnet import HRNetISConfig
    from pvpuformer_tpu_torch.models.zoo.segformer import SegformerISConfig
    from pvpuformer_tpu_torch.models.zoo.swin import SwinISConfig
    from pvpuformer_tpu_torch.models.zoo.swin_unet import SwinUNetISConfig
    return [c(dtype=dtype) for c in (HRNetISConfig, DeeplabISConfig,
                                     SegformerISConfig, SwinISConfig,
                                     HRFormerISConfig, SwinUNetISConfig)]


def _canvas_clicks(hw):
    """Full-frame clicks over a tiled canvas: two positives, one negative,
    one at the far corner."""
    import torch
    pts = torch.full((1, 12, 3), -1.0)
    pts[0, 0] = torch.tensor([200.0, 300.0, 0.0])
    pts[0, 1] = torch.tensor([hw[0] * 0.6, hw[1] * 0.55, 2.0])
    pts[0, 6] = torch.tensor([hw[0] * 0.3, hw[1] * 0.8, 1.0])
    pts[0, 7] = torch.tensor([hw[0] - 1.0, hw[1] - 1.0, 3.0])
    return pts


def phase_family_parity(dev):
    """Phase 16a: each family's tiny f32 session on the card (kernels;
    rounds replayed from the second) against the same session on the CPU
    (plain versions): identical clicks, IoU within 1e-5; tiled_forward of
    the tiny PlainVit over a 96 x 150 canvas, card against CPU, within
    1e-4 of the largest logit."""
    import torch
    from pvpuformer_tpu_torch.inference.predictor import (Predictor,
                                                         PredictorConfig)
    from pvpuformer_tpu_torch.inference.tiled import tiled_forward
    from pvpuformer_tpu_torch.models import registry
    r = np.random.default_rng(7)
    image = (r.uniform(size=(60, 90, 3)) * 255).astype(np.uint8)
    gt = np.zeros((60, 90), np.float32)
    gt[14:50, 18:46] = 1.0
    for cfg in tiny_families():
        pcfg = PredictorConfig(model=cfg, target_size=(64, 64),
                               min_crop_size=32)
        out = {}
        for where in ("cpu", dev):
            model = registry.build(cfg, torch.Generator().manual_seed(1),
                                   "cpu")
            pred = Predictor(model, pcfg, device=where)
            pred.set_input(image, gt)
            out[str(where)] = (pred.run_clicks(FAMILY_CLICKS), pred.clicks)
        (iou_c, clk_c), (iou_g, clk_g) = out["cpu"], out[str(dev)]
        err = float(np.abs(iou_c - iou_g).max())
        same = np.array_equal(clk_c, clk_g)
        ok = same and err <= 1e-5
        _log(f"  {type(cfg).__name__} tiny f32 {FAMILY_CLICKS}-click session"
             f" cuda vs cpu: clicks {'identical' if same else 'DIFFER'}, "
             f"max |dIoU|={err:.2e} (tol 1e-5) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{type(cfg).__name__}: cpu {iou_c} "
                                 f"{clk_c}\ncuda {iou_g} {clk_g}")
    cfg = tiny_families()[0]
    img = torch.from_numpy(np.random.default_rng(0).uniform(
        size=(1, 96, 150, 4)).astype(np.float32))
    pts = _canvas_clicks((96, 150)) * torch.tensor([0.2, 0.2, 1.0])
    got = {}
    for where in ("cpu", dev):
        model = registry.build(cfg, torch.Generator().manual_seed(1),
                               "cpu").to(where)
        got[str(where)] = tiled_forward(model, cfg, img.to(where),
                                        pts.to(where), (64, 64)).cpu()
    want = got["cpu"]
    err = float((got[str(dev)] - want).abs().max()
                / max(1.0, float(want.abs().max())))
    _log(f"  tiny PlainVit tiled_forward over 96 x 150 (2 x 3 tiles) cuda vs"
         f" cpu: {err:.2e} of the largest logit (tol 1e-4) "
         f"{'ok' if err <= 1e-4 else 'FAIL'}")
    if err > 1e-4:
        raise AssertionError(f"tiled_forward: cuda vs cpu {err}")


def _family_sessions(pred, image, gt, clicks: int):
    """Session 1 (its first round eager, its second captured, the rest
    replayed), then session 2 timed per click (replayed rounds)."""
    def check(ious):
        ious = np.asarray(ious)
        if not (np.isfinite(ious).all() and ious.shape == (clicks,)
                and (ious >= 0).all() and (ious <= 1).all()):
            raise AssertionError(f"bad IoU curve {ious}")
        if int(pred.state.click_count) != clicks:
            raise AssertionError(f"click_count {int(pred.state.click_count)}")

    def sessions():
        pred.set_input(image, gt)
        check(pred.run_clicks(clicks))
        pred.set_input(image, gt)
        per_click, ious = [], []
        for _ in range(clicks):
            t = time.perf_counter()
            ious.append(pred.next_click())
            per_click.append((time.perf_counter() - t) * 1e3)
        check(ious)
        return per_click

    def session():
        pred.set_input(image, gt)
        pred.run_clicks(clicks)
    return sessions, session


@contextlib.contextmanager
def _plain_twins():
    """The attention and LN+MLP kernels' plain twins (the functions the CPU
    runs) in place of their wrappers in `models.vit`, on the same
    device."""
    from pvpuformer_tpu_torch.models import vit
    from pvpuformer_tpu_torch.ops.fused_attention import \
        fused_attention_plain
    from pvpuformer_tpu_torch.ops.fused_mlp import fused_ln_mlp_plain

    def plain_attention(q, k, v, scale=None):
        s = 1.0 / float(np.sqrt(q.shape[-1])) if scale is None else scale
        return fused_attention_plain(q, k, v, s)

    def plain_ln_mlp(x, ln, mlp, eps=1e-6):
        d = x.shape[-1]
        return fused_ln_mlp_plain(
            x.reshape(-1, d), ln.scale, ln.bias, mlp.fc1.w, mlp.fc1.b,
            mlp.fc2.w, mlp.fc2.b, eps).reshape(x.shape)

    with _patched(vit, "fused_attention", lambda _: plain_attention), \
            _patched(vit, "fused_ln_mlp", lambda _: plain_ln_mlp):
        yield


def _tiled_vs_plain(model, mcfg, img, pts, got, card: str):
    """Phase 16b: `tiled_forward` again with the attention and LN+MLP
    kernels' plain twins (the functions the CPU runs) in place of their
    wrappers, on the same device: the kernels at the 12 tiles' batch shapes
    held against their plain versions end to end. `got` is the kernels'
    result; returns the largest difference, absolute and relative to the
    largest logit."""
    import torch
    from pvpuformer_tpu_torch.inference.tiled import tiled_forward

    _zero_counts()
    with _plain_twins():
        plain = tiled_forward(model, mcfg, img, pts, mcfg.backbone.img_size)
    torch.cuda.synchronize()
    _round_counts([_counts()], {}, "tiled forward, plain twins")
    scale = max(1.0, float(plain.abs().max()))
    err = float((got - plain).abs().max())
    ok = bool(torch.isfinite(plain).all()) and err <= TILED_BF16_TOL * scale
    _log(f"  PlainVit tiled_forward, kernels vs plain twins on the card "
         f"(bf16): max |d| {err:.4e} = {err / scale:.4e} of max(1, the "
         f"largest |logit|) {scale:.4f}, limit {TILED_BF16_TOL} "
         f"{'ok' if ok else 'FAIL'} ({card})")
    if not ok:
        raise AssertionError(f"tiled_forward vs plain twins: {err}")
    return err, err / scale


def phase_plainvit(dev, card: str):
    """Phase 16b: PlainVit (SimpleClick) ViT-B@448 bf16, seeded random
    weights, on the hand-written kernels."""
    import torch
    from pvpuformer_tpu_torch.inference import graphs
    from pvpuformer_tpu_torch.inference.brs import get_predictor
    from pvpuformer_tpu_torch.inference.predictor import (Predictor,
                                                         PredictorConfig,
                                                         init_session)
    from pvpuformer_tpu_torch.inference.tiled import (_blend_window,
                                                     _tile_origins,
                                                     tiled_forward)
    from pvpuformer_tpu_torch.models.plainvit import (init_plainvit,
                                                     plainvit_forward)
    mcfg = plainvit_b448(torch.bfloat16)
    if mcfg.backbone.img_size != (448, 448):
        raise AssertionError(f"PlainVit crop {mcfg.backbone.img_size}")
    model = init_plainvit(mcfg, torch.Generator().manual_seed(0), dev)
    pcfg = PredictorConfig(model=mcfg, target_size=(448, 448), with_flip=True)
    rng = np.random.default_rng(0)
    image = (rng.uniform(size=(448, 448, 3)) * 255).astype(np.uint8)
    gt = np.zeros((448, 448), np.float32)
    gt[96:352, 128:320] = 1.0
    depth = mcfg.backbone.depth
    total = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    graphs.clear()
    pred = Predictor(model, pcfg, device=dev)
    sessions, session = _family_sessions(pred, image, gt, CLICKS)
    per_round = {"fused_attention": depth, "minplus_rows": 1,
                 "fused_ln_mlp": depth}
    per_click, calls, device = _launch_checks(
        sessions, per_round, 2 * CLICKS, "PlainVit click sessions",
        traced=[(session, CLICKS)] * 2)
    add(calls)
    state0 = init_session(image, gt, mcfg.num_max_points, (448, 448), dev)
    rv = _replay_vs_eager(pred, state0, CLICKS, "PlainVit click path", card)
    _log(f"  PlainVit ViT-B@448 bf16: session 2 median "
         f"{np.median(per_click):.3f} ms/click; device launches over "
         f"{2 * CLICKS} rounds {device} ({card})")

    # --- RGB-BRS: a full forward and backward per evaluation ---
    bp = get_predictor(model, pcfg, "RGB-BRS", device=dev)
    bp.set_input(image, gt)
    bp.next_click()                                          # warm-up
    bp.set_input(image, gt)
    brs_ms, brs_evals = [], []
    for _ in range(PLAINVIT_BRS_CLICKS):
        _zero_counts()
        e0 = bp.evaluations
        t = time.perf_counter()
        iou = bp.next_click()
        brs_ms.append((time.perf_counter() - t) * 1e3)
        torch.cuda.synchronize()
        ev = bp.evaluations - e0
        counts = _counts()
        add(counts)
        brs_evals.append(ev)
        _round_counts([counts], {
            "fused_attention": depth * (ev + 1),
            "fused_ln_mlp": depth * (ev + 1), "minplus_rows": 1,
            "fused_attention_bwd": depth * ev,
            "fused_ln_mlp_bwd": depth * ev}, "PlainVit RGB-BRS click")
        if not 0.0 <= iou <= 1.0:
            raise AssertionError(f"PlainVit RGB-BRS IoU {iou}")
    _log(f"  PlainVit RGB-BRS {PLAINVIT_BRS_CLICKS} oracle clicks at "
         f"max_iters 20: ms per click {np.round(brs_ms, 1).tolist()}, "
         f"evaluations {brs_evals}; launches per click as predicted "
         f"(attention and LN+MLP forwards {depth} per full forward, their "
         f"backwards {depth} per evaluation, one min-plus) ({card})")
    del bp

    # --- a box session: the CC kernels through synth_boxes ---
    bpred = Predictor(model, dataclasses.replace(pcfg, prompt_mode=1),
                      device=dev)

    def box_session():
        bpred.set_input(image, gt)
        ious = bpred.run_clicks(PROMPT_CLICKS)
        if not (np.isfinite(ious).all() and (ious >= 0).all()
                and (ious <= 1).all()):
            raise AssertionError(f"PlainVit box session IoUs {ious}")
        return ious
    _, calls, _ = _launch_checks(
        box_session, {"fused_attention": depth, "fused_ln_mlp": depth,
                      "minplus_rows": 2, "cc_labels": 1, "component_max": 1},
        PROMPT_CLICKS, "PlainVit box session (multi-prompt)")
    add(calls)
    del bpred

    # --- tiled_forward over a canvas larger than the crop ---
    h, w = TILE_CANVAS
    img = torch.from_numpy(np.random.default_rng(1).uniform(
        size=(1, h, w, 4)).astype(np.float32)).to(dev)
    pts = _canvas_clicks(TILE_CANVAS).to(dev)
    _zero_counts()
    got = tiled_forward(model, mcfg, img, pts, (448, 448))
    torch.cuda.synchronize()
    counts = _counts()
    tiled_ms = []                      # the first call above is the warm-up
    for _ in range(3):
        t = time.perf_counter()
        tiled_forward(model, mcfg, img, pts, (448, 448))
        torch.cuda.synchronize()
        tiled_ms.append((time.perf_counter() - t) * 1e3)
    tiled_ms = float(np.median(tiled_ms))
    ys, xs = _tile_origins(h, 448, 0.2), _tile_origins(w, 448, 0.2)
    tiles = [(y0, x0) for y0 in ys for x0 in xs]
    add(counts)
    _round_counts([counts], {"fused_attention": depth,
                             "fused_ln_mlp": depth}, "tiled forward")
    plain_err, plain_rel = _tiled_vs_plain(model, mcfg, img, pts, got, card)
    # the tiles' own forward on the card, blended on the CPU in f64
    with torch.no_grad():
        batch = torch.stack([img[0, y0:y0 + 448, x0:x0 + 448]
                             for y0, x0 in tiles])
        tpts = []
        for y0, x0 in tiles:
            py, px = pts[0, :, 0] - y0, pts[0, :, 1] - x0
            inside = ((pts[0, :, 2] >= 0) & (py >= 0) & (py < 448)
                      & (px >= 0) & (px < 448))
            tpts.append(torch.where(inside[:, None], torch.stack(
                [py, px, pts[0, :, 2]], -1), -1.0))
        logits = plainvit_forward(model, mcfg, batch, torch.stack(tpts))[
            "instances"].float().cpu().numpy()
    win = _blend_window(448, 448)[..., None].astype(np.float64)
    acc = np.zeros((h, w, 1))
    den = np.full((h, w, 1), 1e-6)
    for i, (y0, x0) in enumerate(tiles):
        acc[y0:y0 + 448, x0:x0 + 448] += logits[i] * win
        den[y0:y0 + 448, x0:x0 + 448] += win
    want = acc / den
    err = float(np.abs(got[0].cpu().numpy() - want).max())
    ok = err <= 1e-4 * max(1.0, float(np.abs(want).max())) \
        and np.isfinite(want).all()
    _log(f"  PlainVit tiled_forward over {h} x {w} ({len(ys)} x {len(xs)} "
         f"tiles, one batched forward): {tiled_ms:.1f} ms (median of 3 "
         f"after a warm-up call); against the "
         f"tiles' forward blended on the CPU (f64): max |d| {err:.2e} "
         f"{'ok' if ok else 'FAIL'}; one attention and LN+MLP launch per "
         f"block ({card})")
    if not ok:
        raise AssertionError(f"tiled_forward: {err}")
    del model
    graphs.clear()
    torch.cuda.empty_cache()
    return total, {"eager_p50_ms": rv["eager_p50_ms"],
                   "replay_p50_ms": rv["replay_p50_ms"],
                   "session_p50_ms": float(np.median(per_click)),
                   "replay_device_ms": rv["replay_device_ms"],
                   "rgb_brs_ms": brs_ms, "rgb_brs_evaluations": brs_evals,
                   "tiled_ms": tiled_ms, "tiled_plain_err": plain_err,
                   "tiled_plain_rel_err": plain_rel,
                   "device_launches": device}


def phase_zoo(dev, card: str):
    """Phase 16c: each zoo family at its default config, bf16, seeded random
    weights: a FAMILY_CLICKS-click session through `Predictor` twice (the
    launch checks: one min-plus a round, no attention or LN+MLP kernel),
    replayed rounds against the eager `click_scan` (bit-identical) with p50
    ms per click; one f-BRS-A click of HRNet and DeepLab."""
    import torch
    from pvpuformer_tpu_torch.inference import graphs
    from pvpuformer_tpu_torch.inference.brs import get_predictor
    from pvpuformer_tpu_torch.inference.predictor import (Predictor,
                                                         PredictorConfig,
                                                         init_session)
    from pvpuformer_tpu_torch.models import registry
    rng = np.random.default_rng(0)
    image = (rng.uniform(size=(448, 448, 3)) * 255).astype(np.uint8)
    gt = np.zeros((448, 448), np.float32)
    gt[96:352, 128:320] = 1.0
    total, out = {}, {}
    for cfg in zoo_defaults(torch.bfloat16):
        name = type(cfg).__name__
        graphs.clear()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        model = registry.build(cfg, torch.Generator().manual_seed(0), dev)
        build_s = time.perf_counter() - t
        pcfg = PredictorConfig(model=cfg, target_size=(448, 448),
                               with_flip=True)
        pred = Predictor(model, pcfg, device=dev)
        sessions, session = _family_sessions(pred, image, gt, FAMILY_CLICKS)
        per_click, calls, device = _launch_checks(
            sessions, {"minplus_rows": 1}, 2 * FAMILY_CLICKS,
            f"{name} sessions", traced=[(session, FAMILY_CLICKS)] * 2)
        for k, v in calls.items():
            total[k] = total.get(k, 0) + v
        state0 = init_session(image, gt, cfg.num_max_points, (448, 448), dev)
        rv = _replay_vs_eager(pred, state0, FAMILY_CLICKS, f"{name} click "
                              f"path", card)
        n_params = sum(p.numel() for p in model.parameters())
        rec = {"session_p50_ms": float(np.median(per_click)),
               "replay_p50_ms": rv["replay_p50_ms"],
               "eager_p50_ms": rv["eager_p50_ms"],
               "replay_device_ms": rv["replay_device_ms"],
               "params_m": n_params / 1e6, "build_s": build_s}
        if name in ("HRNetISConfig", "DeeplabISConfig"):
            bp = get_predictor(model, pcfg, "f-BRS-A", device=dev)
            bp.set_input(image, gt)
            bp.next_click()                                  # warm-up
            bp.set_input(image, gt)
            _zero_counts()
            e0 = bp.evaluations
            t = time.perf_counter()
            iou = bp.next_click()
            ms = (time.perf_counter() - t) * 1e3
            torch.cuda.synchronize()
            counts = _counts()
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
            _round_counts([counts], {"minplus_rows": 1},
                          f"{name} f-BRS-A click")
            if not 0.0 <= iou <= 1.0:
                raise AssertionError(f"{name} f-BRS-A IoU {iou}")
            rec.update(fbrs_a_ms=ms, fbrs_a_insertion=bp.insertion,
                       fbrs_a_evaluations=bp.evaluations - e0)
            del bp
        out[name] = rec
        _log(f"  {name} (default config, {n_params / 1e6:.1f} M parameters,"
             f" bf16): session 2 median {rec['session_p50_ms']:.3f} ms/click"
             f", replayed p50 {rec['replay_p50_ms']:.3f}, eager p50 "
             f"{rec['eager_p50_ms']:.3f}, replayed device "
             f"{rec['replay_device_ms']:.3f} ms/click"
             + (f"; f-BRS-A ({rec['fbrs_a_insertion']}) click "
                f"{rec['fbrs_a_ms']:.1f} ms, {rec['fbrs_a_evaluations']} "
                f"evaluations" if "fbrs_a_ms" in rec else "")
             + f" ({card})")
        del pred, model
    graphs.clear()
    torch.cuda.empty_cache()
    return total, out


def phase_families(dev, card: str):
    """Phase 16: the model registry's families (a, b, c above); prints one
    {"phase16": ...} JSON line and returns the wrapper calls of 16b-16c."""
    _log("  (a) parity, tiny f32 sessions cuda vs cpu, every family")
    phase_family_parity(dev)
    _log("  (b) PlainVit ViT-B@448 bf16")
    total, plainvit = phase_plainvit(dev, card)
    _log("  (c) the zoo families at their default configs, bf16")
    zoo_total, zoo = phase_zoo(dev, card)
    for k, v in zoo_total.items():
        total[k] = total.get(k, 0) + v
    print(json.dumps({"phase16": {"card": card, "plainvit": plainvit,
                                  "zoo": zoo, "launches": total}}),
          flush=True)
    return total


# ---------------------------------------------------------------------------
# phase 17: scale-out on the card (parallel/, the Trainer's and
# BatchedEvaluator's mesh, the CLIs' mesh flags)
# ---------------------------------------------------------------------------

SCALE_BATCH = 8           # 17a: the global batch, 4 rows a rank
SCALE_STEPS = 2           # 17a / 17b: steps of SCALE_ITERS rounds
SCALE_ITERS = 3
SCALE_EVAL_B = 16         # 17a: sessions a chunk, 8 a rank
SCALE_DEPTH = 4           # 17a: ViT-B@448 (width 768) cut to 4 blocks
FSDP_BATCH = 4            # 17b: the ViT-L recipe's batch
FSDP_DEPTH = 8            # 17b: the ViT-L recipe's 24 blocks cut to 8
CHILD_TIMEOUT = 600       # s: each process phase 17 starts
# 17a, 2 gloo ranks against one process on the global batch: |dloss| of
# each step; 7.530e-03 measured on losses of 14.5 and 17.4 (H100 80GB HBM3,
# 700 W): cuBLAS rounds the bf16 products of a 4-row batch otherwise than
# those of an 8-row one
SCALE_LOSS_TOL = 2e-2
# 17a: |dIoU| of the sharded B = 16 evaluation (8 sessions a rank) against
# one process's B = 16 (model batch 32 against 16: the same rounding
# effect; 11 of 16 sessions' clicks parted), 3.380e-04 measured. Against
# one process's B = 8, the ranks' own shapes, the run is held bit-identical
SCALE_IOU_TOL = 5e-3
# 17b: FSDP at world size 1 against the unsharded step, losses and the
# checkpoint's leaves
FSDP_TOL = 0.0
# torch.distributed's collectives that the port and FSDP2 call (FSDP2's
# names differ between torch versions; those this torch lacks are skipped)
COLLECTIVES = ("all_reduce", "broadcast", "all_gather_into_tensor",
               "reduce_scatter_tensor", "all_gather_single",
               "reduce_scatter_single")


@contextlib.contextmanager
def _collective_counts():
    """{name: calls} of torch.distributed's collectives inside the block
    (FSDP2 and the port call them through the module's attributes)."""
    import torch.distributed as tdist
    names = [n for n in COLLECTIVES if hasattr(tdist, n)]
    counts = dict.fromkeys(names, 0)
    saved = {n: getattr(tdist, n) for n in names}

    def counted(name):
        def call(*a, **kw):
            counts[name] += 1
            return saved[name](*a, **kw)
        return call

    for n in names:
        setattr(tdist, n, counted(n))
    try:
        yield counts
    finally:
        for n, f in saved.items():
            setattr(tdist, n, f)


def _scale_batch(b: int, hw: int, n: int):
    """b distinct samples in train_batch's layout (one image seed each)."""
    parts = [train_batch(1, hw, n, seed=i) for i in range(b)]
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def _box_seeds(cfg, num_iters: int, k: int):
    """The first k generator seeds whose step draws a box round and a
    click round."""
    import torch
    from pvpuformer_tpu_torch.engine.train_step import _train_noise
    out = []
    for seed in range(1 << 16):
        types = _train_noise(cfg, torch.Generator().manual_seed(seed), 1, 1,
                             1, num_iters)["prompt_types"]
        if {0, 1} <= set(types):
            out.append(seed)
            if len(out) == k:
                return out
    raise AssertionError("too few seeds draw a box round and a click round")


def _steps(trainer, batch, seeds, dev, mesh):
    """SCALE_ITERS-round `train_step`s of a Trainer's model and optimizer,
    one per seed: (global losses, host ms per step, wrapper counts,
    collectives per step)."""
    import torch
    from pvpuformer_tpu_torch.engine.train_step import train_step
    thr = torch.tensor([0.4, 0.375, 0.425], device=dev)
    losses, ms = [], []
    torch.cuda.synchronize()
    _zero_counts()
    with _collective_counts() as coll:
        for seed in seeds:
            t = time.perf_counter()
            logs, _, _ = train_step(
                trainer.model, trainer.tx, batch,
                torch.Generator().manual_seed(seed), thr, cfg=trainer.cfg,
                num_iters=SCALE_ITERS, device=dev, mesh=mesh)
            losses.append(float(logs["loss"]))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
    return losses, ms, {**_counts(), **_tp_counts()}, {
        k: v / len(seeds) for k, v in coll.items() if v}


def _scale_config():
    """17a's model: ViT-B@448 bf16, its depth cut to SCALE_DEPTH for time
    (the widths, heads and the window / global blocks' layout kept)."""
    import torch
    from pvpuformer_tpu_torch.models.vpu import vpu_base_config
    mcfg = vpu_base_config(dtype=torch.bfloat16)
    return mcfg.replace(backbone=dataclasses.replace(mcfg.backbone,
                                                     depth=SCALE_DEPTH))


def _scale_train(dev, mesh):
    """17a's training: `_scale_config()` (seeded weights, Adam 5e-5), the
    global batch SCALE_BATCH (this rank's rows under a mesh),
    "replicated", SCALE_STEPS steps."""
    import torch
    from pvpuformer_tpu_torch.engine.optimizer import make_optimizer
    from pvpuformer_tpu_torch.engine.train_step import TrainConfig
    from pvpuformer_tpu_torch.engine.trainer import Trainer
    from pvpuformer_tpu_torch.models.vpu import init_vpu
    from pvpuformer_tpu_torch.parallel.mesh import shard_batch

    cfg = TrainConfig(model=_scale_config())
    model = init_vpu(cfg.model, torch.Generator().manual_seed(0), dev)
    trainer = Trainer(model, cfg, make_optimizer(model, "adam", lr=5e-5),
                      None, device=dev, mesh=mesh, param_mode="replicated")
    hw = cfg.model.backbone.img_size[0]
    batch = shard_batch(_scale_batch(SCALE_BATCH, hw,
                                     cfg.model.num_max_points), mesh)
    seeds = _box_seeds(cfg, SCALE_ITERS, SCALE_STEPS)
    losses, ms, counts, coll = _steps(trainer, batch, seeds, dev, mesh)
    return {"losses": losses, "step_ms": ms, "launches": counts,
            "collectives_per_step": coll, "rows": len(batch["image"]),
            "types": _train_noise_types(cfg, seeds),
            "depth": cfg.model.backbone.depth}


def _scale_eval(dev, mesh, b: int = SCALE_EVAL_B):
    """17a's evaluation: `_scale_config()`, SCALE_EVAL_B objects of Synthetic
    448 x 448 x EVAL_CLICKS clicks in chunks of B = b (each split over the
    ranks under a mesh)."""
    import torch
    from pvpuformer_tpu_torch.inference.batched import BatchedEvaluator
    from pvpuformer_tpu_torch.inference.datasets import SyntheticDataset
    from pvpuformer_tpu_torch.inference.predictor import PredictorConfig
    from pvpuformer_tpu_torch.models.vpu import init_vpu

    mcfg = _scale_config()
    model = init_vpu(mcfg, torch.Generator().manual_seed(0), dev)
    pcfg = PredictorConfig(model=mcfg, target_size=mcfg.crop_size,
                           with_flip=True)
    bev = BatchedEvaluator(model, pcfg, batch_size=b, device=dev, mesh=mesh)
    ds = SyntheticDataset(n_samples=SCALE_EVAL_B, hw=(448, 448), seed=0)
    torch.cuda.synchronize()
    _zero_counts()
    with _collective_counts() as coll:
        curves, elapsed, _ = bev.evaluate(ds, max_clicks=EVAL_CLICKS,
                                          max_iou_thr=0.95)
    torch.cuda.synchronize()
    return {"curves": [c.tolist() for c in curves],
            "clicks": [c.tolist() for c in bev.clicks], "elapsed": elapsed,
            "launches": _counts(), "collectives": coll}


TP_MODES = ("tp", "tp+fsdp")    # 17a's TP leg, on the (1, 2) mesh


def _scale_tp(dev, out_dir: str):
    """17a's tensor-parallel leg, in the same two gloo ranks: `_scale_config()`
    (seeded weights, Adam 5e-5) on the (1, 2) mesh, both ranks on the
    global batch SCALE_BATCH, SCALE_STEPS steps of SCALE_ITERS rounds in
    each of TP_MODES: per mode the losses, ms per step, wrapper counts
    (the tensor-parallel LN+MLP's too), the head counts the attention
    wrapper saw, collectives per step; in "tp" one more step traced by
    torch.profiler (one window a rank, no retake: the ranks must call their
    collectives alike); in "tp+fsdp" the gathered checkpoint, which rank 0
    writes to out_dir/tp_fsdp.npz."""
    import torch
    from pvpuformer_tpu_torch.engine.optimizer import make_optimizer
    from pvpuformer_tpu_torch.engine.train_step import TrainConfig
    from pvpuformer_tpu_torch.engine.trainer import Trainer
    from pvpuformer_tpu_torch.models import vit
    from pvpuformer_tpu_torch.models.vpu import init_vpu
    from pvpuformer_tpu_torch.parallel import dist
    from pvpuformer_tpu_torch.parallel.mesh import (full_state_dict,
                                                    is_sharded, make_mesh,
                                                    shard_batch)
    from pvpuformer_tpu_torch.utils.serialization import save_checkpoint

    mesh = make_mesh(model_parallel=2)
    out = {"mesh": mesh.mesh.tolist()}
    heads = set()
    attn = vit.fused_attention

    def spy(q, k, v, *a, **kw):
        heads.add(int(q.shape[2]))
        return attn(q, k, v, *a, **kw)
    for mode in TP_MODES:
        t0 = time.perf_counter()
        cfg = TrainConfig(model=_scale_config())
        model = init_vpu(cfg.model, torch.Generator().manual_seed(0), dev)
        trainer = Trainer(model, cfg, make_optimizer(model, "adam", lr=5e-5),
                          None, device=dev, mesh=mesh, param_mode=mode)
        hw = cfg.model.backbone.img_size[0]
        batch = shard_batch(_scale_batch(SCALE_BATCH, hw,
                                         cfg.model.num_max_points), mesh)
        seeds = _box_seeds(cfg, SCALE_ITERS, SCALE_STEPS)
        heads.clear()
        vit.fused_attention = spy
        try:
            losses, ms, counts, coll = _steps(trainer, batch, seeds, dev,
                                              mesh)
        finally:
            vit.fused_attention = attn
        res = {"losses": losses, "step_ms": ms, "launches": counts,
               "collectives_per_step": coll, "rows": len(batch["image"]),
               "heads": sorted(heads), "sharded": is_sharded(trainer.model),
               "types": _train_noise_types(cfg, seeds),
               "depth": cfg.model.backbone.depth}
        if mode == "tp":
            _, names = _kernel_trace(lambda: _steps(
                trainer, batch, seeds[:1], dev, mesh), sessions=1)
            res["device"] = {
                "fc2_partial": sum("fc2_residual_kernel" in n
                                   and "true>" in n for n in names),
                "fc2_residual": sum("fc2_residual_kernel" in n
                                    and "false>" in n for n in names),
                "ln_fc1_gelu": sum("ln_fc1_gelu" in n for n in names),
                "attention_fwd": sum("attention_fwd" in n for n in names)}
        else:
            t = time.perf_counter()
            state = full_state_dict(trainer.model)
            opt = trainer.tx.state_dict()
            if dist.is_master():
                save_checkpoint(os.path.join(out_dir, "tp_fsdp.npz"), state,
                                config=cfg, opt_state=opt, step=SCALE_STEPS)
            res["save_s"] = time.perf_counter() - t
            del state, opt
        res["leg_s"] = time.perf_counter() - t0
        out[mode] = res
        del trainer, model
        torch.cuda.empty_cache()
    return out


def worker_scaleout(out_dir: str) -> None:
    """One gloo rank of 17a on cuda:0 (chip_smoke starts two): training,
    the sharded evaluation, then the tensor-parallel leg; writes
    out_dir/rank<R>.json."""
    from pvpuformer_tpu_torch.parallel import dist
    from pvpuformer_tpu_torch.parallel.mesh import make_mesh
    dev = dist.init("cuda:0", backend="gloo")
    try:
        mesh = make_mesh()
        out = {"train": _scale_train(dev, mesh),
               "eval": _scale_eval(dev, mesh),
               "tp": _scale_tp(dev, out_dir)}
        with open(os.path.join(out_dir, f"rank{dist.get_rank()}.json"),
                  "w") as f:
            json.dump(out, f)
    finally:
        dist.shutdown()


def worker_fsdp(out_dir: str) -> None:
    """17b, the one rank of `torch.distributed.run --nproc-per-node 1`
    under NCCL: the ViT-L recipe's Trainer (`build_trainer`; the ViT at
    width 1024, FSDP_DEPTH blocks) over the synthetic raw source, unsharded ("replicated" on the one-rank mesh)
    and in its default mode ("fsdp"), SCALE_STEPS steps each from the same
    batches and draws; the FSDP Trainer's checkpoint against the unsharded
    Trainer's state (what its `save` would write: `full_state_dict` and
    the optimizer's `state_dict`); then one more FSDP step traced by
    torch.profiler. Writes out_dir/fsdp.json."""
    from pathlib import Path
    import torch
    from pvpuformer_tpu_torch.data import Loader, SyntheticTrainDataset
    from pvpuformer_tpu_torch.parallel import dist
    from pvpuformer_tpu_torch.parallel.mesh import (full_state_dict,
                                                    is_sharded)
    from pvpuformer_tpu_torch.utils.serialization import jax_name
    from pvpuformer_tpu_torch.recipes.iSegNet import (
        vpu_base448_cocolvis as base, vpu_large448_cocolvis as recipe)
    from pvpuformer_tpu_torch.models.vpu import vpu_large_config
    from pvpuformer_tpu_torch.utils.exp import EasyCfg
    from pvpuformer_tpu_torch.utils.serialization import load_checkpoint

    def cut_large(**kw):            # width 1024 kept, depth cut for time
        mcfg = vpu_large_config(**kw)
        return mcfg.replace(backbone=dataclasses.replace(mcfg.backbone,
                                                         depth=FSDP_DEPTH))

    recipe.init_model = functools.partial(base.init_model,
                                          make_config=cut_large,
                                          mae_key="MAE_LARGE")
    dev = dist.init()
    try:
        sampler = base.points_sampler()
        trainset = SyntheticTrainDataset(
            n_samples=8, hw=RECIPE_HW, **{**base.train_kwargs(sampler),
                                          "epoch_len": 8})
        batches = list(itertools.islice(Loader(trainset, FSDP_BATCH,
                                               num_workers=2),
                                        SCALE_STEPS))
        out = {}
        for mode in ("replicated", "fsdp"):
            d = Path(out_dir) / mode
            cfg = EasyCfg(CHECKPOINTS_PATH=d, LOGS_PATH=d / "logs",
                          device=str(dev), batch_size=FSDP_BATCH, workers=2,
                          IMAGENET_PRETRAINED_MODELS={},
                          param_mode="replicated" if mode == "replicated"
                          else None)          # None: the recipe's default
            t0 = time.perf_counter()
            trainer = recipe.build_trainer(cfg, trainset, None)
            t_build = time.perf_counter() - t0
            seeds = _box_seeds(trainer.cfg, SCALE_ITERS, SCALE_STEPS)
            torch.cuda.reset_peak_memory_stats()
            losses, ms, counts, coll = [], [], None, None
            for batch, seed in zip(batches, seeds):
                lo, m, c, k = _steps(trainer, batch, [seed], dev,
                                     trainer.mesh)
                losses += lo
                ms += m
                counts = c if counts is None else \
                    {n: counts[n] + c[n] for n in c}
                coll = k
            res = {"losses": losses, "step_ms": ms, "launches": counts,
                   "collectives_per_step": coll,
                   "sharded": is_sharded(trainer.model),
                   "param_mode": trainer.param_mode,
                   "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                   "build_s": t_build}
            if mode == "replicated":
                ref = ({jax_name(k): v.float().cpu()
                        for k, v in full_state_dict(trainer.model).items()},
                       {k: torch.as_tensor(v).float().cpu()
                        for k, v in trainer.tx.state_dict().items()})
            else:
                trainer.global_step = SCALE_STEPS
                t0 = time.perf_counter()
                trainer.save(0)
                res["save_s"] = time.perf_counter() - t0
                flat, _, step, extra = load_checkpoint(
                    d / "last_checkpoint.npz", opt_state=True)
                opt = extra["opt_state"]
                out["ckpt"] = {
                    "same_keys": set(flat) == set(ref[0])
                    and set(opt) == set(ref[1]),
                    "step": step,
                    "param_err": max(float((torch.from_numpy(v).float()
                                            - ref[0][k]).abs().max())
                                     for k, v in flat.items()),
                    "opt_err": max(float((v.float() - ref[1][k]).abs().max())
                                   for k, v in opt.items()),
                    "moments": sum(k.endswith("exp_avg") for k in opt)}
                del ref
                def step():
                    return _steps(trainer, batches[0], seeds[:1], dev,
                                  trainer.mesh)
                _, names = _kernel_trace(step)
                res["device"] = {key: sum(key in n for n in names)
                                 for key in FSDP_KERNELS}
            res["types"] = _train_noise_types(trainer.cfg, seeds)
            res["depth"] = trainer.cfg.model.backbone.depth
            out[mode] = res
            del trainer
            torch.cuda.empty_cache()
        with open(os.path.join(out_dir, "fsdp.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.shutdown()


# 17b's profiler trace: kernel-name substrings of rows 1, 2, 4, 5, 6, 7
FSDP_KERNELS = ("attention_fwd", "attention_bwd_q", "attention_bwd_kv",
                "minplus_envelope", "ln_fc1_gelu", "flood_kernel<1>",
                "flood_kernel<2>")


def _scale_launches(depth: int, types):
    """Each wrapper's calls in steps of these prompt types (phase 9's
    count): per round depth attention and LN+MLP forwards and backwards, a
    min-plus call per click round after the first, a CC call each per box
    round."""
    rounds = sum(map(len, types))
    boxes = sum(t.count(1) for t in types)
    return {"fused_attention": depth * rounds,
            "fused_attention_bwd": depth * rounds,
            "fused_ln_mlp": depth * rounds, "fused_ln_mlp_bwd": depth * rounds,
            "flash_attention": 0, "minplus_rows": rounds - len(types),
            "cc_labels": boxes, "component_max": boxes}


def _train_noise_types(cfg, seeds):
    import torch
    from pvpuformer_tpu_torch.engine.train_step import _train_noise
    return [_train_noise(cfg, torch.Generator().manual_seed(s), 1, 1, 1,
                         SCALE_ITERS)["prompt_types"] for s in seeds]


def _children(cmds, envs, what: str):
    """Start the commands together from the repo root, wait at most
    CHILD_TIMEOUT s for each (then kill them all); raise unless all exit
    0. Returns their stdouts."""
    procs = [subprocess.Popen(c, cwd=ROOT, env=e, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c, e in zip(cmds, envs)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=CHILD_TIMEOUT)
            if p.returncode != 0:
                raise AssertionError(f"{what} exited {p.returncode}:\n"
                                     f"{out[-3000:]}\n{err[-5000:]}")
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def _free_ports(n: int):
    """n distinct free ports of 127.0.0.1 (held together while chosen)."""
    import contextlib
    import socket
    with contextlib.ExitStack() as stack:
        socks = [stack.enter_context(socket.socket()) for _ in range(n)]
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]


def _start_torchrun(args, port: int):
    """`python -m torch.distributed.run --nproc-per-node 1 <args>` started
    on `port` of 127.0.0.1 (`_start`; `_finish` reads its stdout)."""
    return _start(["torch.distributed.run", "--nproc-per-node=1",
                   "--master-addr=127.0.0.1", f"--master-port={port}",
                   *args], ROOT)


def _noise_cost(card: str) -> None:
    """The host's draw of one 3-round step's noise (`_train_noise`, ViT-B@448)
    at the batches a rank of W = 1, 2, 8 draws for a local batch of 4 and
    32: a rank draws the global batch's and keeps its rows."""
    import torch
    from pvpuformer_tpu_torch.engine.train_step import TrainConfig, _train_noise
    from pvpuformer_tpu_torch.models.vpu import vpu_base_config
    cfg = TrainConfig(model=vpu_base_config(dtype=torch.bfloat16))
    hw = cfg.model.backbone.img_size[0]
    ms = {}
    for b in (4, 8, 32, 64, 256):
        t = []
        for _ in range(3):
            t0 = time.perf_counter()
            _train_noise(cfg, torch.Generator().manual_seed(0), b, hw, hw,
                         SCALE_ITERS)
            t.append((time.perf_counter() - t0) * 1e3)
        ms[b] = round(float(np.median(t)), 1)
    _log(f"  host noise draw of a {SCALE_ITERS}-round step at global batch "
         f"B (ms, median of 3; a rank draws the global B): {ms} (host of "
         f"{card})")


def _tp_checkpoint(path: str):
    """The TP leg's gathered "tp+fsdp" checkpoint in one process: its
    leaves loaded strictly into a one-process VPU (`registry.load`), its
    Adam moments into a one-process optimizer, each of the parameter's
    shape; returns what the check reads."""
    from pvpuformer_tpu_torch.engine.optimizer import make_optimizer
    from pvpuformer_tpu_torch.models import registry
    from pvpuformer_tpu_torch.utils.serialization import load_checkpoint
    t = time.perf_counter()
    flat, cfg, step, extra = load_checkpoint(path, opt_state=True)
    model = registry.load(flat, cfg.model)
    tx = make_optimizer(model, "adam", lr=5e-5)
    opt = extra["opt_state"]
    shapes = all(tuple(v.shape) == tuple(tx.params[int(k.split("/")[1])]
                                          .shape)
                 for k, v in opt.items() if k.endswith(("exp_avg",
                                                        "exp_avg_sq")))
    tx.load_state_dict(opt)
    qkv = tuple(flat["backbone/blocks/#0/attn/qkv/w"].shape)
    return {"step": step, "moments": sum(k.endswith("exp_avg") for k in opt),
            "params": len(tx.params), "shapes": shapes, "qkv": qkv,
            "finite": all(np.isfinite(v).all() for v in flat.values()),
            "load_s": time.perf_counter() - t}


def _check_tp(tp, one, ckpt, card: str) -> None:
    """17a's TP leg (`_scale_tp` in both ranks) against the one process's
    steps: identical losses on the two model ranks and within
    SCALE_LOSS_TOL of one process's, every rank's wrapper launches exact
    (the unsplit LN+MLP none), 6 heads a rank, (b') in the traced step,
    the checkpoint whole and loaded."""
    for mode in TP_MODES:
        a, b = tp[0][mode], tp[1][mode]
        depth = a["depth"]
        rounds = sum(map(len, a["types"]))
        want = dict(_scale_launches(depth, a["types"]), fused_ln_mlp=0,
                    fused_ln_mlp_bwd=0, fused_ln_mlp_tp=depth * rounds,
                    fused_ln_mlp_tp_epilogue=depth * rounds,
                    fused_ln_mlp_tp_bwd=depth * rounds)
        dloss = max(abs(x - y) for x, y in zip(a["losses"], one["losses"]))
        ok = (a["losses"] == b["losses"] and dloss <= SCALE_LOSS_TOL
              and np.isfinite(a["losses"]).all()
              and a["types"] == one["types"]
              and a["rows"] == b["rows"] == SCALE_BATCH
              and a["heads"] == b["heads"] == [6]
              and a["sharded"] == b["sharded"] == (mode == "tp+fsdp")
              and all(r["launches"][k] == v for r in (a, b)
                      for k, v in want.items()))
        extra = ""
        if mode == "tp":
            seen = [r["tp"]["device"] for r in tp]
            ok = ok and (max(d["fc2_partial"] for d in seen) > 0
                         and all(d["fc2_residual"] == 0 for d in seen))
            extra = (f"; one traced step a rank, device launches {seen} "
                     f"(torch.profiler)")
        else:
            ok = ok and (ckpt["step"] == SCALE_STEPS and ckpt["shapes"]
                         and ckpt["finite"] and ckpt["qkv"] == (768, 2304)
                         and ckpt["moments"] == ckpt["params"])
            extra = (f"; the gathered checkpoint: written in "
                     f"{a['save_s']:.1f} s, loaded strictly in one process "
                     f"in {ckpt['load_s']:.1f} s (qkv {ckpt['qkv']}, "
                     f"{ckpt['moments']} exp_avg leaves of the parameters' "
                     f"shapes, step {ckpt['step']})")
        _log(f"  17a TP leg, mesh {tp[0]['mesh']} (2 gloo ranks on cuda:0, "
             f"M = 2), {mode}, ViT-B@448 bf16 at depth {SCALE_DEPTH}, "
             f"global batch {SCALE_BATCH} "
             f"on both ranks, {SCALE_STEPS} steps x {SCALE_ITERS} rounds: "
             f"losses rank 0 {a['losses']}, rank 1 {b['losses']}; one "
             f"process {one['losses']}; max |dloss| {dloss:.3e} (tol "
             f"{SCALE_LOSS_TOL}); heads a rank {a['heads']}; collectives "
             f"per step {a['collectives_per_step']}; ms per step "
             f"{[round(x, 1) for x in a['step_ms']]} (no speed claim: gloo "
             f"goes through the host and the two ranks share the card); "
             f"the leg {a['leg_s']:.1f} s; launches per rank "
             f"{ {k: v for k, v in a['launches'].items() if v} } (want "
             f"{ {k: v for k, v in want.items() if v} }){extra} ({card}) "
             f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"17a TP leg ({mode}): the ranks disagree "
                                 f"with each other, with one process, in "
                                 f"their launches or in the checkpoint")


def _add(total, counts):
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def phase_scaleout(dev, card: str):
    """Phase 17 (see the module docstring). Returns the wrapper counts of
    its distributed runs: both gloo ranks' steps and evaluation, the FSDP
    steps."""
    import tempfile

    t_phase = time.perf_counter()
    port_a, port_b, port_c = _free_ports(3)
    base_env = dict(os.environ, PYTHONPATH=ROOT, WORLD_SIZE="2",
                    LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                    MASTER_PORT=str(port_a))
    with tempfile.TemporaryDirectory() as tmp:
        dirs = [os.path.join(tmp, d) for d in ("a", "b", "c")]
        for d in dirs:
            os.mkdir(d)
        # 17b and 17c run beside 17a, for time (no speed claim here)
        fsdp = _start_torchrun([os.path.abspath(__file__), "--worker",
                                "fsdp", dirs[1]], port_b)
        mesh_cli = _start_torchrun(
            ["-m", "pvpuformer_tpu_torch.evaluate", "--random-weights",
             "--datasets", "Synthetic", "--n-clicks", "5", "--batched",
             str(SCALE_EVAL_B), "--eval-mesh", "1", "--logs-path", dirs[2]],
            port_c)
        try:
            launches = _scale_ranks(dev, card, base_env, dirs[0])
            _, secs = _finish(fsdp, "the 17b FSDP rank",
                              timeout=CHILD_TIMEOUT)
            with open(os.path.join(dirs[1], "fsdp.json")) as f:
                fs = json.load(f)
            out, secs_c = _finish(mesh_cli, "evaluate --eval-mesh 1",
                                  timeout=CHILD_TIMEOUT)
        except BaseException:
            _stop(fsdp)
            _stop(mesh_cli)
            raise
    _check_fsdp(fs, secs, card)
    _add(launches, fs["fsdp"]["launches"])
    table = [ln for ln in out.splitlines() if ln.startswith("|")]
    _log(f"  17c python -m torch.distributed.run --nproc-per-node 1 -m "
         f"pvpuformer_tpu_torch.evaluate --random-weights --datasets "
         f"Synthetic --n-clicks 5 --batched {SCALE_EVAL_B} --eval-mesh 1: rc "
         f"0 in {secs_c:.1f} s (beside 17a and 17b)")
    for ln in table:
        _log(f"    {ln}")
    if not any("| Synthetic |" in ln for ln in table):
        raise AssertionError("evaluate --eval-mesh 1 printed no NoC table")
    _log(f"  phase 17: {time.perf_counter() - t_phase:.1f} s")
    return launches


def _scale_ranks(dev, card: str, base_env, tmp: str):
    """17a: the two gloo ranks (`--worker scaleout`), then this process's
    one-process references and the checks; returns the ranks' wrapper
    counts."""
    import torch
    launches = {}
    t = time.perf_counter()
    _children([[sys.executable, os.path.abspath(__file__), "--worker",
                "scaleout", tmp]] * 2,
              [dict(base_env, RANK=str(r)) for r in range(2)],
              "the 17a gloo ranks")
    ranks = []
    for r in range(2):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    secs = time.perf_counter() - t
    tp_ckpt = _tp_checkpoint(os.path.join(tmp, "tp_fsdp.npz"))
    one = _scale_train(dev, None)
    r0, r1 = (r["train"] for r in ranks)
    dloss = max(abs(a - b) for a, b in zip(r0["losses"], one["losses"]))
    want = _scale_launches(one["depth"], one["types"])
    ok = (r0["losses"] == r1["losses"] and dloss <= SCALE_LOSS_TOL
          and np.isfinite(r0["losses"]).all()
          and r0["rows"] == r1["rows"] == SCALE_BATCH // 2
          and all(r["launches"][k] == v for r in (r0, r1)
                  for k, v in want.items()))
    _log(f"  17a 2 gloo ranks on cuda:0, replicated, ViT-B@448 bf16 at "
         f"depth {SCALE_DEPTH}, global "
         f"batch {SCALE_BATCH} ({r0['rows']} rows a rank), {SCALE_STEPS} "
         f"steps x {SCALE_ITERS} rounds: losses rank 0 {r0['losses']}, rank "
         f"1 {r1['losses']}; one process {one['losses']}; max |dloss| "
         f"{dloss:.3e} (tol {SCALE_LOSS_TOL}); collectives per step "
         f"{r0['collectives_per_step']}; ms per step W=2 "
         f"{[round(x, 1) for x in r0['step_ms']]} (gloo through the host, "
         f"two ranks sharing the card: no speed claim), W=1 "
         f"{[round(x, 1) for x in one['step_ms']]}; launches per rank "
         f"{ {k: v for k, v in r0['launches'].items() if v} } (want {want}); "
         f"both ranks' processes {secs:.1f} s ({card}) "
         f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("17a: the 2-rank steps disagree with each other, "
                             "with one process, or in their launches")
    _add(launches, r0["launches"])
    _add(launches, r1["launches"])
    _noise_cost(card)

    e0, e1 = (r["eval"] for r in ranks)
    single = _scale_eval(dev, None)
    half = _scale_eval(dev, None, SCALE_EVAL_B // 2)
    for e in (e0, e1, single, half):
        _curves_ok([np.asarray(c) for c in e["curves"]], SCALE_EVAL_B,
                   EVAL_CLICKS)
    same = sum(np.array_equal(a, b) for a, b in zip(e0["clicks"],
                                                    single["clicks"]))

    def diou(e):
        return max(float(np.abs(np.asarray(a[:min(len(a), len(b))])
                                - np.asarray(b[:min(len(a), len(b))])).max())
                   for a, b in zip(e0["curves"], e["curves"]))
    exact = e0["curves"] == half["curves"] and e0["clicks"] == half["clicks"]
    ok = (e0["curves"] == e1["curves"] and e0["clicks"] == e1["clicks"]
          and exact and diou(single) <= SCALE_IOU_TOL)
    _log(f"  17a BatchedEvaluator(mesh=) B = {SCALE_EVAL_B} over 2 gloo "
         f"ranks (8 sessions a rank) x {EVAL_CLICKS} clicks: against one "
         f"process's B = {SCALE_EVAL_B // 2} (each rank's shapes) curves "
         f"and clicks bit-identical {exact}; against one process's B = "
         f"{SCALE_EVAL_B}: sessions with equal clicks {same} of "
         f"{SCALE_EVAL_B}, max |dIoU| {diou(single):.3e} (tol "
         f"{SCALE_IOU_TOL}); {e0['elapsed']:.2f} s sharded vs "
         f"{single['elapsed']:.2f} s one process; collectives "
         f"{e0['collectives']}; launches per rank "
         f"{ {k: v for k, v in e0['launches'].items() if v} } ({card}) "
         f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("17a: the sharded evaluation disagrees with "
                             "one process's")
    _add(launches, e0["launches"])
    _add(launches, e1["launches"])
    _check_tp([r["tp"] for r in ranks], one, tp_ckpt, card)
    for r in ranks:
        for mode in TP_MODES:
            _add(launches, r["tp"][mode]["launches"])
    del one, single, half
    torch.cuda.empty_cache()
    return launches


def _check_fsdp(fs, secs: float, card: str) -> None:
    """17b's checks on its rank's fsdp.json."""
    a, b, ck = fs["replicated"], fs["fsdp"], fs["ckpt"]
    boxes = sum(t.count(1) for t in b["types"][:1])
    want = _scale_launches(b["depth"], b["types"])
    dloss = max(abs(x - y) for x, y in zip(a["losses"], b["losses"]))
    seen = b["device"]
    ok = (b["sharded"] and not a["sharded"] and b["param_mode"] == "fsdp"
          and dloss <= FSDP_TOL and ck["same_keys"]
          and ck["param_err"] <= FSDP_TOL and ck["opt_err"] <= FSDP_TOL
          and ck["step"] == SCALE_STEPS
          and all(b["launches"][k] == v for k, v in want.items())
          and all(seen[k] > 0 for k in FSDP_KERNELS[:5])
          and (boxes == 0 or all(seen[k] > 0 for k in FSDP_KERNELS[5:])))
    _log(f"  17b FSDP at world size 1 under NCCL (torch.distributed.run "
         f"--nproc-per-node 1), the ViT-L recipe's build_trainer (depth "
         f"{b['depth']} of 24) in its default mode ({b['param_mode']}), batch {FSDP_BATCH}, "
         f"{SCALE_STEPS} steps x {SCALE_ITERS} rounds: losses fsdp "
         f"{b['losses']}, unsharded {a['losses']}, max |dloss| {dloss:.3e} "
         f"(tol {FSDP_TOL}); the FSDP checkpoint against the unsharded "
         f"Trainer's state: max |dparam| "
         f"{ck['param_err']:.3e}, max |dmoment| {ck['opt_err']:.3e} "
         f"({ck['moments']} exp_avg leaves; tol {FSDP_TOL}); ms per step "
         f"fsdp {[round(x, 1) for x in b['step_ms']]}, unsharded "
         f"{[round(x, 1) for x in a['step_ms']]}; build_trainer s fsdp "
         f"{b['build_s']:.1f}, unsharded {a['build_s']:.1f}; the FSDP "
         f"checkpoint written in {b['save_s']:.1f} s; peak GiB fsdp "
         f"{b['peak_gib']:.2f}, unsharded {a['peak_gib']:.2f}; collectives "
         f"per step fsdp {b['collectives_per_step']}; wrapper launches "
         f"{ {k: v for k, v in b['launches'].items() if v} } (want {want}); "
         f"one more FSDP step traced (types {b['types'][:1]}): device "
         f"launches {seen}; the process {secs:.1f} s, beside 17a "
         f"({card}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("17b: the FSDP step disagrees with the "
                             "unsharded one, or its kernels did not launch")


EVAL_CLI = "pvpuformer_tpu_torch.evaluate"
CLI_LIMIT = 2             # phase 18: Synthetic samples per CLI process
CLI_VIS_CLICKS = 7        # phase 18f: clicks of the --vis-preds process
CLI_CLICKS_LIMIT = 5      # phase 18g: --clicks-limit
LAUNCHER = ["NoBRS", "--cf-n=0", "--acf", "--iou-analysis", "--save-ious",
            "--print-ious"]            # run_evaluate_vpu.sh's flags
# --cf-n 2 --cf-click 3 --acf: three forwards a click (every one of them
# runs, the cascade selects with torch.where), the first 3 clicks refined
CASCADE = {"cascade_step": 3, "cascade_adaptive": True, "cascade_clicks": 3}
RITM_CROP = (400, 400)    # phase 18c: --eval-ritm (skip_clicks=1)
FIXED_CROP = (448, 672)   # phase 18d: --eval-mode fixed448,672
PROTOCOL_HW = (480, 640)  # phase 18b-d: the sessions' image


def _rounds_vs_plain(pred, state0, clicks: int, label: str, card: str):
    """Each round of the kernels' session, from its input state, again with
    the attention and LN+MLP plain twins patched into `models.vit`
    (`_plain_twins`) on the card and the same prompt draws: the same
    oracle click, and the probabilities within TILED_BF16_TOL (phase 16b's
    tolerance, of max(1, the largest probability)). Rounds are compared
    one by one so that a bf16 difference in one round cannot move the next
    round's click. Returns the largest |dprob| and |dIoU|."""
    import torch
    from pvpuformer_tpu_torch.inference.predictor import (NOISE_SEED,
                                                         click_step)
    gen = torch.Generator().manual_seed(NOISE_SEED)
    st, worst, iou_err = state0, 0.0, 0.0
    with torch.no_grad():
        for k in range(clicks):
            twin = torch.Generator()
            twin.set_state(gen.get_state())
            nxt, iou = click_step(pred.model, pred.cfg, st, gen)
            _zero_counts()
            with _plain_twins():
                pnxt, piou = click_step(pred.model, pred.cfg, st, twin)
            torch.cuda.synchronize()
            counts = _counts()
            if counts["fused_attention"] or counts["fused_ln_mlp"]:
                raise AssertionError(f"{label}: a kernel ran under the "
                                     f"plain twins: {counts}")
            if not torch.equal(nxt.points, pnxt.points):
                raise AssertionError(f"{label} round {k}: the clicks differ")
            if not torch.isfinite(pnxt.prev_probs).all():
                raise AssertionError(f"{label} round {k}: plain non-finite")
            worst = max(worst, float(
                (nxt.prev_probs - pnxt.prev_probs).abs().max()))
            iou_err = max(iou_err, abs(float(iou) - float(piou)))
            st = nxt
    ok = worst <= TILED_BF16_TOL
    _log(f"  {label}: {clicks} rounds, kernels vs plain twins on the card "
         f"(bf16), each from the kernels' state: clicks equal, max |dprob| "
         f"{worst:.4e} (limit {TILED_BF16_TOL}), max |dIoU| {iou_err:.4e} "
         f"{'ok' if ok else 'FAIL'} ({card})")
    if not ok:
        raise AssertionError(f"{label}: kernels vs plain twins {worst}")
    return worst, iou_err


def _protocol_path(model, mcfg, crop, kw, image, gt, per_round, label,
                   dev, card, clicks: int = CLICKS):
    """Phase 18b-d: one protocol's sessions through `Predictor` at `crop`
    (PredictorConfig fields `kw`): two sessions with the launch checks,
    replayed rounds against the eager `click_scan` and each round against
    the plain twins. Returns (predictor, numbers, wrapper counts)."""
    from pvpuformer_tpu_torch.evaluate import at_crop
    from pvpuformer_tpu_torch.inference.predictor import (Predictor,
                                                         PredictorConfig,
                                                         init_session)
    m, c = at_crop(model, mcfg, crop)
    pred = Predictor(m, PredictorConfig(model=c, target_size=crop,
                                        with_flip=True, **kw), device=dev)
    sessions, session = _family_sessions(pred, image, gt, clicks)
    per_click, calls, device = _launch_checks(
        sessions, per_round, 2 * clicks, f"{label} sessions",
        traced=[(session, clicks)] * 2)
    state0 = init_session(image, gt, c.num_max_points,
                          pred._canvas(*image.shape[:2]), dev)
    rv = _replay_vs_eager(pred, state0, clicks, label, card)
    dprob, diou = _rounds_vs_plain(pred, state0, clicks, label, card)
    return pred, {"session_p50_ms": float(np.median(per_click)),
                  "replay_p50_ms": rv["replay_p50_ms"],
                  "eager_p50_ms": rv["eager_p50_ms"],
                  "replay_device_ms": rv["replay_device_ms"],
                  "plain_max_dprob": dprob, "plain_max_diou": diou,
                  "device_launches": device}, calls


def _cli_curves(folder, name):
    import pickle
    with open(os.path.join(folder, name), "rb") as f:
        return pickle.load(f)["all_ious"]


def phase_eval_cli(dev, card: str):
    """Phase 18: the evaluation CLI's protocol flags on ViT-B@448 bf16,
    seeded random weights (`--random-weights`). Returns the wrapper counts
    of the in-process sessions' eager and captured rounds."""
    import dataclasses as dc
    import tempfile
    import torch
    from PIL import Image
    from pvpuformer_tpu_torch import evaluate as cli
    from pvpuformer_tpu_torch.inference import graphs
    from pvpuformer_tpu_torch.inference import predictor as tpred
    from pvpuformer_tpu_torch.inference.datasets import SyntheticDataset
    from pvpuformer_tpu_torch.inference.evaluation import evaluate_dataset
    from pvpuformer_tpu_torch.inference.predictor import (Predictor,
                                                         PredictorConfig,
                                                         init_session)
    from pvpuformer_tpu_torch.models import registry

    t_phase = time.perf_counter()
    total, out = {}, {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    model, mcfg = cli.build_model(cli.parse_args(["--random-weights"]))
    depth = mcfg.backbone.depth
    graphs.clear()
    with tempfile.TemporaryDirectory() as tmp:
        # --- (a) the repo launcher's command, as a process, and beside it
        # (f, g), checked below (for time; neither is timed) ---
        logs_a, logs_f = os.path.join(tmp, "a"), os.path.join(tmp, "f")
        vis_cli = _start(
            [EVAL_CLI, "--random-weights", "--datasets", "Synthetic",
             "--limit", str(CLI_LIMIT), "--logs-path", logs_f,
             "--n-clicks", str(CLI_VIS_CLICKS), "--iou-analysis",
             "--vis-preds", "--clicks-limit", str(CLI_CLICKS_LIMIT),
             "--model-name", "vitb448-random"], tmp)
        try:
            text, secs = _subprocess(
                [EVAL_CLI, "--random-weights", "--datasets", "Synthetic",
                 "--limit", str(CLI_LIMIT), "--logs-path", logs_a]
                + LAUNCHER, tmp, "the launcher's command")
            text_f, secs_f = _finish(
                vis_cli, "--vis-preds --clicks-limit --model-name")
        except BaseException:
            _stop(vis_cli)
            raise
        name = "Synthetic_cvpr_NoBRS_20.pickle"
        got = _cli_curves(logs_a, name)
        crop, skip = cli.protocol_crop(cli.parse_args(LAUNCHER), "Synthetic",
                                       registry.crop_size(mcfg))
        m, c = cli.at_crop(model, mcfg, crop)
        pred = Predictor(m, PredictorConfig(
            model=c, target_size=crop, with_flip=True, skip_clicks=skip,
            cascade_step=1, cascade_adaptive=True, cascade_clicks=1),
            device=dev)
        want, _ = evaluate_dataset(
            cli._Subset(SyntheticDataset(), range(CLI_LIMIT)), pred,
            max_iou_thr=1.01, max_clicks=20)
        del pred, m
        same = (len(got) == len(want) == CLI_LIMIT
                and all(a.shape == (20,) and np.array_equal(a, b)
                        for a, b in zip(got, want)))
        table = [ln for ln in text.splitlines()
                 if ln.startswith(("|", "mIoU@k", "saved IoU"))]
        _log(f"  (a) python -m {EVAL_CLI} --random-weights --datasets "
             f"Synthetic --limit {CLI_LIMIT} {' '.join(LAUNCHER)}: rc 0 in "
             f"{secs:.1f} s (beside (f, g)); curves against an in-process evaluate_dataset "
             f"at target 1.01 on the same weights: "
             f"{'bit-identical' if same else 'DIFFER'}")
        for ln in table:
            _log(f"    {ln}")
        if not same or not any("NoC@90%" in ln for ln in table):
            raise AssertionError(f"(a) the launcher's command: {got} vs "
                                 f"{want}")
        out["launcher_s"] = secs

        # --- (e) --profile: the same curves, every click timed ---
        logs_e = os.path.join(tmp, "e")
        text, secs = _subprocess(
            [EVAL_CLI, "--random-weights", "--datasets", "Synthetic",
             "--limit", str(CLI_LIMIT), "--logs-path", logs_e, "--profile"]
            + LAUNCHER, tmp, "--profile")
        prof = next(ln for ln in text.splitlines()
                    if ln.startswith("per-click latency: "))
        summary = json.loads(prof[len("per-click latency: "):]
                             .replace("'", '"'))
        mem = next(ln for ln in text.splitlines()
                   if ln.startswith("memory: "))
        hist = [ln for ln in text.splitlines() if " ms:" in ln]
        pgot = _cli_curves(logs_e, name)
        same = all(np.array_equal(a, b) for a, b in zip(pgot, got))
        ok = (same and summary["count"] == 20 * CLI_LIMIT
              and len(hist) == 10 and '"cuda:0"' in mem.replace("'", '"')
              and "bytes_limit_mb" in mem)
        _log(f"  (e) --profile: rc 0 in {secs:.1f} s; curves equal (a)'s: "
             f"{same}; per-click p50 {summary['p50_ms']:.3f} ms, p90 "
             f"{summary['p90_ms']:.3f} ms, p99 {summary['p99_ms']:.3f} ms, "
             f"max {summary['max_ms']:.3f} ms over {summary['count']} "
             f"clicks; {mem} {'ok' if ok else 'FAIL'} ({card})")
        if not ok:
            raise AssertionError(f"(e) --profile: {text[-3000:]}")
        out["profile"] = dict(summary, memory=mem[len("memory: "):])

        # --- (f) --vis-preds and (g) --clicks-limit / --model-name ---
        text, secs = text_f, secs_f
        fgot = _cli_curves(logs_f, f"Synthetic_cvpr_NoBRS_"
                                   f"{CLI_VIS_CLICKS}.pickle")
        vis = os.path.join(logs_f, "vis", "Synthetic")
        pngs = sorted(os.listdir(vis)) if os.path.isdir(vis) else []
        h, w = SyntheticDataset().hw
        shapes = [np.asarray(Image.open(os.path.join(vis, f))).shape
                  for f in pngs]
        early = all(np.array_equal(a[:CLI_CLICKS_LIMIT],
                                   b[:CLI_CLICKS_LIMIT])
                    for a, b in zip(fgot, got))
        ok = (pngs == [f"{i}.png" for i in range(CLI_LIMIT)]
              and all(sh == (CLI_VIS_CLICKS * 2 * h, 3 * w, 3)
                      for sh in shapes)
              and "Eval results for model: vitb448-random" in
              text.splitlines() and early
              and all(len(a) == CLI_VIS_CLICKS for a in fgot))
        _log(f"  (f, g) --vis-preds --clicks-limit {CLI_CLICKS_LIMIT} "
             f"--model-name vitb448-random --n-clicks {CLI_VIS_CLICKS}: rc 0 "
             f"in {secs:.1f} s (beside (a)); PNGs {pngs} of {shapes} (click rows x "
             f"2 x {h}, 3 x {w}); header carries the name; the first "
             f"{CLI_CLICKS_LIMIT} clicks' IoUs equal (a)'s: {early} "
             f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"(f, g): {text[-3000:]}")

    # --- (b) the cascade, (c) --eval-ritm, (d) --eval-mode fixed ---
    sample = SyntheticDataset(1, PROTOCOL_HW, seed=5).get_sample(0)
    image, gt = sample.image, sample.gt_mask(0).astype(np.float32)
    fwd = {"fused_attention": depth, "fused_ln_mlp": depth,
           "minplus_rows": 1}
    cascade = {k: v * (CASCADE["cascade_step"] if k != "minplus_rows"
                       else 1) for k, v in fwd.items()}
    runs = (("cascade", "(b) cascade --cf-n 2 --cf-click 3 --acf",
             (448, 448), CASCADE, cascade),
            ("ritm400", "(c) --eval-ritm crop 400", RITM_CROP,
             {"skip_clicks": 1}, fwd),
            ("fixed448x672", "(d) --eval-mode fixed448,672", FIXED_CROP, {},
             fwd))
    for key, label, crop, kw, per_round in runs:
        pred, out[key], calls = _protocol_path(
            model, mcfg, crop, kw, image, gt, per_round, label, dev, card)
        add(calls)
        if key == "cascade":
            bpred = pred
        else:
            del pred
    # the cascade's p50 beside --cf-n 0 and --cf-n 2 without --acf, and a
    # box session with the cascade (its draws made once a click)
    m0 = bpred.model
    state0 = init_session(image, gt, mcfg.num_max_points,
                          bpred._canvas(*image.shape[:2]), dev)
    for tag, kw in (("cf_n0", {}), ("cf_n2_no_acf",
                                    dict(CASCADE, cascade_adaptive=False))):
        p = Predictor(m0, PredictorConfig(model=bpred.cfg.model,
                                          target_size=(448, 448),
                                          with_flip=True, **kw), device=dev)
        p.set_input(image, gt)
        p.run_clicks(2)                     # its eager and captured rounds
        out[tag] = _replay_vs_eager(p, state0, CLICKS, f"(b) {tag}", card)
        del p
    box = Predictor(m0, dc.replace(bpred.cfg, prompt_mode=1), device=dev)
    box_round = {"fused_attention": 3 * depth, "fused_ln_mlp": 3 * depth,
                 "minplus_rows": 1 + 3, "cc_labels": 3, "component_max": 3}

    def box_session():
        box.set_input(image, gt)
        ious = box.run_clicks(PROMPT_CLICKS)
        if not (np.isfinite(ious).all() and (ious >= 0).all()
                and (ious <= 1).all()):
            raise AssertionError(f"cascade box session IoUs {ious}")
        return ious
    _, calls, _ = _launch_checks(box_session, box_round, PROMPT_CLICKS,
                                 "(b) cascade box session (multi-prompt)")
    add(calls)
    draws = [0]

    def count(wrapped):
        def draw(*a, **kw):
            draws[0] += 1
            return wrapped(*a, **kw)
        return draw
    with _patched(tpred, "_prompt_noise", count):
        box_session()
    _log(f"  (b) cascade box session: {draws[0]} host prompt draws over "
         f"{PROMPT_CLICKS} replayed clicks of {CASCADE['cascade_step']} "
         f"forwards each "
         f"{'ok' if draws[0] == PROMPT_CLICKS else 'FAIL'}")
    if draws[0] != PROMPT_CLICKS:
        raise AssertionError(f"box draws {draws[0]}")
    out["box"] = _replay_vs_eager(box, state0, PROMPT_CLICKS,
                                  "(b) cascade box session", card)
    del box, bpred, m0
    graphs.clear()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    print(json.dumps({"phase18": {"card": card, **out,
                                  "kernels_at_protocol_shapes":
                                      PROTOCOL_SHAPES}}))
    _log(f"  phase 18: {out['seconds']:.1f} s")
    return total


# ---------------------------------------------------------------------------
# phase 19: the int8 accuracy gate (gate_int8.py) and reference checkpoints
# (utils/torch_ingest.py) on the card
# ---------------------------------------------------------------------------

GATE_DIMS = (768, 1024, 1280)
GATE_SAMPLES = 24         # 19a: JAX's envelope, 24 samples x 6 clicks
GATE_CLICKS = 6
GATE_TRAIN_STEPS = 60
GATE_MEAN, GATE_MAX = 0.005, 0.02    # tests/test_quant.py:101-164's bounds
REF_CLICKS = 5            # 19b: clicks of each reference-checkpoint session
REF_LOGIT_TOL = 1e-4      # 19b: card f32 forward vs the CPU's, of max |logit|


def _loss_windows(losses):
    """The first 10 and last 10 steps' mean loss, the same like against
    like, and per num_iters (1 + step % 3) the mean over its steps in each
    window. A step of r rounds sums the iterloss weights (1, 2, 3) of its
    r rounds, so its loss scales with r, and the two 10-step windows hold
    different mixes (three 3-round steps in the first, four in the last).
    Like against like divides each step's loss by the mean loss of the
    run's steps with its num_iters before the windows' means are taken."""
    steps = len(losses)
    kind = [1 + i % 3 for i in range(steps)]
    scale = {r: np.mean([v for v, k in zip(losses, kind) if k == r])
             for r in set(kind)}
    rel = [v / scale[k] for v, k in zip(losses, kind)]
    by = {}
    for r in sorted(scale):
        a = [losses[i] for i in range(10) if kind[i] == r]
        b = [losses[i] for i in range(steps - 10, steps) if kind[i] == r]
        by[r] = (float(np.mean(a)), float(np.mean(b)))
    return {"loss_first10": float(np.mean(losses[:10])),
            "loss_last10": float(np.mean(losses[-10:])),
            "relative_first10": float(np.mean(rel[:10])),
            "relative_last10": float(np.mean(rel[-10:])),
            "loss_by_num_iters": by}


def phase_gate(dev, card: str):
    """Phase 19a: `gate_int8.gate` at each width of GATE_DIMS, at the
    port's seeded init and after GATE_TRAIN_STEPS steps of
    `train_synthetic`, bf16 against int8 sessions of GATE_SAMPLES x
    GATE_CLICKS. Random init: mean |dIoU| < GATE_MEAN, max < GATE_MAX;
    trained: mean < GATE_MEAN, p95 < GATE_MAX (a trained max can be a
    path that parted, BASELINE.md:133-136); the first click equal in
    every session; the loss of the last 10 steps below the first 10's,
    like against like (`_loss_windows`). Returns (the wrapper counts of
    the runs, their summaries)."""
    import torch
    from pvpuformer_tpu_torch import gate_int8
    from pvpuformer_tpu_torch.inference import graphs
    total, runs = {}, []
    for dim in GATE_DIMS:
        for steps in (0, GATE_TRAIN_STEPS):
            graphs.clear()
            torch.cuda.empty_cache()
            _zero_counts()
            t = time.perf_counter()
            out, losses, _, _ = gate_int8.gate(
                dim, GATE_SAMPLES, GATE_CLICKS, steps, dev)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t
            for k, v in _counts().items():
                total[k] = total.get(k, 0) + v
            spread = "iou_delta_p95" if steps else "iou_delta_max"
            ok = (out["iou_delta_mean"] < GATE_MEAN
                  and out[spread] < GATE_MAX
                  and 0 not in out["first_divergent_click"])
            rec = {**out, "seconds": secs, "card": card}
            if steps:
                rec.update(_loss_windows(losses))
                ok = ok and rec["relative_last10"] < rec["relative_first10"]
            runs.append(rec)
            print(json.dumps({"gate": rec}), flush=True)
            kind = f"trained {steps}" if steps else "random"
            _log(f"  gate {dim} {kind}: mean {out['iou_delta_mean']}, p95 "
                 f"{out['iou_delta_p95']}, max {out['iou_delta_max']}, "
                 f"divergence "
                 f"{out['seq_divergence_rate']}"
                 + (f", loss first 10 {rec['loss_first10']:.4f} last 10 "
                    f"{rec['loss_last10']:.4f}, like against like "
                    f"{rec['relative_first10']:.4f} -> "
                    f"{rec['relative_last10']:.4f}, by num_iters (first, "
                    f"last) "
                    + str({r: (round(a, 4), round(b, 4)) for r, (a, b) in
                           rec["loss_by_num_iters"].items()})
                    if steps else "")
                 + f", {secs:.1f} s {'ok' if ok else 'FAIL'} ({card})")
            if not ok:
                raise AssertionError(f"int8 gate at {dim}, {steps} steps: "
                                     f"{rec}")
    graphs.clear()
    torch.cuda.empty_cache()
    return total, runs


def reference_vpu_sd(cfg, seed=0):
    """A made-up state dict with the reference VitMultiGaussianVector_ed_Model
    names and shapes (is_vpu_model.py:165-186, SimpleFPN, the two-way
    transformer, the head), the generator of tests/test_utils.py:155-258
    (chip_smoke imports nothing of the tests, which import JAX)."""
    r = np.random.default_rng(seed)
    d = cfg.backbone.embed_dim
    gh, gw = cfg.backbone.grid_size
    ph, pw = cfg.backbone.patch_size
    sd = {}

    def lin(name, i, o, bias=True):
        sd[f"{name}.weight"] = r.normal(0, 0.02, (o, i)).astype(np.float32)
        if bias:
            sd[f"{name}.bias"] = r.normal(0, 0.02, (o,)).astype(np.float32)

    def ln(name, c):
        sd[f"{name}.weight"] = np.ones((c,), np.float32)
        sd[f"{name}.bias"] = np.zeros((c,), np.float32)

    def conv(name, i, o, k=1, bias=True):
        sd[f"{name}.weight"] = r.normal(0, 0.02, (o, i, k, k)).astype(
            np.float32)
        if bias:
            sd[f"{name}.bias"] = np.zeros((o,), np.float32)

    def deconv(name, i, o):
        sd[f"{name}.weight"] = r.normal(0, 0.02, (i, o, 2, 2)).astype(
            np.float32)
        sd[f"{name}.bias"] = np.zeros((o,), np.float32)

    def attn(name, dim, internal):
        for part in ("q_proj", "k_proj", "v_proj"):
            lin(f"{name}.{part}", dim, internal)
        lin(f"{name}.out_proj", internal, dim)

    sd["backbone.patch_embed.proj.weight"] = r.normal(
        0, 0.02, (d, 3, ph, pw)).astype(np.float32)
    sd["backbone.patch_embed.proj.bias"] = np.zeros((d,), np.float32)
    sd["backbone.pos_embed"] = r.normal(
        0, 0.02, (1, gh * gw + 1, d)).astype(np.float32)
    sd["backbone.cls_token"] = np.zeros((1, 1, d), np.float32)
    for i in range(cfg.backbone.depth):
        b = f"backbone.blocks.{i}"
        ln(f"{b}.norm1", d)
        lin(f"{b}.attn.qkv", d, 3 * d)
        lin(f"{b}.attn.proj", d, d)
        ln(f"{b}.norm2", d)
        lin(f"{b}.mlp.fc1", d, int(d * cfg.backbone.mlp_ratio))
        lin(f"{b}.mlp.fc2", int(d * cfg.backbone.mlp_ratio), d)

    conv("patch_embed_coords.proj", 3, d, k=ph)
    sd["pe_layer.positional_encoding_gaussian_matrix"] = r.normal(
        0, 1, (2, d // 2)).astype(np.float32)
    for i in range(4):
        sd[f"point_embeddings.{i}.weight"] = r.normal(
            0, 1, (1, d)).astype(np.float32)
    sd["not_a_point_embed.weight"] = r.normal(0, 1, (1, d)).astype(np.float32)

    nc = cfg.neck
    lin("neck.ffn_layer.lin1", nc.prompt_dim, nc.hide_dim * 2)
    lin("neck.ffn_layer.lin2", nc.hide_dim * 2, d)
    tw = nc.two_way
    internal = tw.embedding_dim // tw.attention_downsample_rate
    for i in range(tw.depth):
        b = f"neck.att.layers.{i}"
        attn(f"{b}.self_attn", d, d)
        ln(f"{b}.norm1", d)
        attn(f"{b}.cross_attn_token_to_image", d, internal)
        ln(f"{b}.norm2", d)
        lin(f"{b}.mlp.lin1", d, tw.mlp_dim)
        lin(f"{b}.mlp.lin2", tw.mlp_dim, d)
        ln(f"{b}.norm3", d)
        attn(f"{b}.cross_attn_image_to_token", d, internal)
        ln(f"{b}.norm4", d)
    attn("neck.att.final_attn_token_to_image", d, internal)
    ln("neck.att.norm_final_attn", d)

    deconv("neck.down_4.0", d, nc.down4_chan)
    ln("neck.down_4.1", nc.down4_chan)
    deconv("neck.down_4.3", nc.down4_chan, nc.down4_chan // 2)
    ln("neck.down_4.4", nc.down4_chan // 2)
    conv("neck.down_4.5", nc.down4_chan // 2, nc.out_dims[0])
    ln("neck.down_4.6", nc.out_dims[0])
    deconv("neck.down_8.0", d, nc.down8_chan)
    ln("neck.down_8.1", nc.down8_chan)
    conv("neck.down_8.2", nc.down8_chan, nc.out_dims[1])
    ln("neck.down_8.3", nc.out_dims[1])
    conv("neck.down_16.0", d, nc.out_dims[2])
    ln("neck.down_16.1", nc.out_dims[2])
    conv("neck.down_32.0", d, nc.down32_chan, k=2)
    ln("neck.down_32.1", nc.down32_chan)
    conv("neck.down_32.2", nc.down32_chan, nc.out_dims[3])
    ln("neck.down_32.3", nc.out_dims[3])

    hc = cfg.head
    for i, ic in enumerate(hc.in_channels):
        conv(f"head.convs.{i}.conv", ic, hc.out_channels)
    conv("head.fusion_conv.conv", hc.out_channels * 4, hc.out_channels)
    conv("head.conv_seg", hc.channels, 1)
    sd["head.logit_scale"] = np.asarray(np.log(1 / 0.07), np.float32)
    lin("head.ffn_layer.lin1", hc.d_model, hc.d_model * 2)
    lin("head.ffn_layer.lin2", hc.d_model * 2, hc.out_channels)
    conv("head_aux", 128, 1)
    return sd


def reference_hrnet_sd(cfg, seed=0):
    """A made-up RITM HRNetModel state dict (hrnet_ocr.py names), the
    generator of tests/test_utils.py:336-426, with the conv biases in front
    of the OCR head's BNs (`conv3x3_ocr.0`, `aux_head.0`) drawn away from
    zero."""
    r = np.random.default_rng(seed)
    sd = {}

    def conv(name, i, o, k=3, bias=False):
        sd[f"{name}.weight"] = r.normal(0, 0.02, (o, i, k, k)).astype(
            np.float32)
        if bias:
            sd[f"{name}.bias"] = r.normal(0, 0.05, (o,)).astype(np.float32)

    def bn(name, c):
        sd[f"{name}.weight"] = np.ones((c,), np.float32)
        sd[f"{name}.bias"] = np.zeros((c,), np.float32)
        sd[f"{name}.running_mean"] = r.normal(0, 0.1, (c,)).astype(np.float32)
        sd[f"{name}.running_var"] = r.uniform(0.5, 2.0, (c,)).astype(
            np.float32)

    def cb(cname, bname, i, o, k=3, bias=False):
        conv(cname, i, o, k, bias)
        bn(bname, o)

    conv("maps_transform.0", 3, 16, k=1, bias=True)
    conv("maps_transform.2", 16, 64, k=3, bias=True)
    sd["maps_transform.3.scale"] = np.asarray([0.05], np.float32)

    fx = "feature_extractor."
    w = cfg.branch_widths
    blocks = cfg.blocks_per_module
    cb(f"{fx}conv1", f"{fx}bn1", 3, 64)
    cb(f"{fx}conv2", f"{fx}bn2", 64, 64)
    for j in range(blocks):
        p = f"{fx}layer1.{j}"
        cin = 64 if j == 0 else 256
        cb(f"{p}.conv1", f"{p}.bn1", cin, 64, k=1)
        cb(f"{p}.conv2", f"{p}.bn2", 64, 64, k=3)
        cb(f"{p}.conv3", f"{p}.bn3", 64, 256, k=1)
        if j == 0:
            cb(f"{p}.downsample.0", f"{p}.downsample.1", cin, 256, k=1)

    def transition(tname, prev, cur):
        for i, cw in enumerate(cur):
            base = f"{fx}{tname}.{i}"
            if i < len(prev):
                if prev[i] != cw:
                    cb(f"{base}.0", f"{base}.1", prev[i], cw)
            else:
                cb(f"{base}.0.0", f"{base}.0.1", prev[-1], cw)

    def stage(sname, widths, n_modules):
        for m in range(n_modules):
            p = f"{fx}{sname}.{m}"
            for b, bw in enumerate(widths):
                for j in range(blocks):
                    q = f"{p}.branches.{b}.{j}"
                    cb(f"{q}.conv1", f"{q}.bn1", bw, bw)
                    cb(f"{q}.conv2", f"{q}.bn2", bw, bw)
            nbr = len(widths)
            for i in range(nbr):
                for j in range(nbr):
                    f = f"{p}.fuse_layers.{i}.{j}"
                    if j > i:
                        cb(f"{f}.0", f"{f}.1", widths[j], widths[i], k=1)
                    elif j < i:
                        cin = widths[j]
                        for k in range(i - j):
                            cout = widths[i] if k == i - j - 1 else widths[j]
                            cb(f"{f}.{k}.0", f"{f}.{k}.1", cin, cout)
                            cin = cout

    transition("transition1", (256,), w[:2])
    stage("stage2", w[:2], cfg.num_modules[0])
    transition("transition2", w[:2], w[:3])
    stage("stage3", w[:3], cfg.num_modules[1])
    transition("transition3", w[:3], w)
    stage("stage4", w, cfg.num_modules[2])

    total = sum(w)
    mid, key = 2 * cfg.ocr_width, cfg.ocr_width
    cb(f"{fx}conv3x3_ocr.0", f"{fx}conv3x3_ocr.1", total, mid, bias=True)
    cb(f"{fx}aux_head.0", f"{fx}aux_head.1", total, total, k=1, bias=True)
    conv(f"{fx}aux_head.3", total, 1, k=1, bias=True)
    ob = f"{fx}ocr_distri_head.object_context_block"
    for name in ("f_pixel", "f_object"):
        cb(f"{ob}.{name}.0", f"{ob}.{name}.1.0", mid, key, k=1)
        cb(f"{ob}.{name}.2", f"{ob}.{name}.3.0", key, key, k=1)
    cb(f"{ob}.f_down.0", f"{ob}.f_down.1.0", mid, key, k=1)
    cb(f"{ob}.f_up.0", f"{ob}.f_up.1.0", key, mid, k=1)
    cb(f"{fx}ocr_distri_head.conv_bn_dropout.0",
       f"{fx}ocr_distri_head.conv_bn_dropout.1.0", 2 * mid, mid, k=1)
    conv(f"{fx}cls_head", mid, 1, k=1, bias=True)
    return sd


def _reference_session(name, cfg, load, dev, card: str, per_round):
    """19b for one family: `load(cfg)` reads the written reference .pth into
    a CPU module (strict, `registry.load`); a REF_CLICKS-click f32 session
    and the first forward on the card against the CPU (phase 4's check:
    identical clicks, IoU within 1e-5; the logits within REF_LOGIT_TOL of
    the largest); then the bf16 session twice with the launch checks, and
    its replayed rounds against the eager `click_scan` (bit-identical).
    Returns (wrapper counts, the record)."""
    import torch
    from pvpuformer_tpu_torch.inference import graphs
    from pvpuformer_tpu_torch.inference.predictor import (Predictor,
                                                         PredictorConfig,
                                                         init_session)
    from pvpuformer_tpu_torch.models import registry
    rng = np.random.default_rng(0)
    image = (rng.uniform(size=(448, 448, 3)) * 255).astype(np.uint8)
    gt = np.zeros((448, 448), np.float32)
    gt[96:352, 128:320] = 1.0
    f32 = cfg.replace(dtype=torch.float32)
    pcfg = PredictorConfig(model=f32, target_size=(448, 448), with_flip=True)
    runs, load_s = [], []
    for where in ("cpu", dev):
        t = time.perf_counter()
        model = load(f32)
        load_s.append(time.perf_counter() - t)
        pred = Predictor(model, pcfg, device=where)
        pred.set_input(image, gt)
        runs.append((model, pred.run_clicks(REF_CLICKS), pred.clicks))
    (cpu_model, iou_c, clk_c), (model, iou_g, clk_g) = runs
    del runs, pred
    err = float(np.abs(iou_c - iou_g).max())
    img = torch.from_numpy(np.concatenate(
        [image / np.float32(255), gt[..., None] * 0], -1)[None]
        .astype(np.float32))
    pts = torch.full((1, 2 * f32.num_max_points, 3), -1.0)
    pts[0, 0] = torch.tensor([224.0, 224.0, 0.0])
    fwd = registry.forward_for(f32)
    with torch.no_grad():
        lc = fwd(cpu_model, f32, img, pts)["instances"]
        lg = fwd(model, f32, img.to(dev), pts.to(dev))["instances"]
    del cpu_model
    logit_err = float((lg.cpu() - lc).abs().max()
                      / max(1.0, float(lc.abs().max())))
    ok = np.array_equal(clk_c, clk_g) and err <= 1e-5 \
        and logit_err <= REF_LOGIT_TOL
    _log(f"  {name} from a reference .pth, f32 card vs CPU: {REF_CLICKS}-"
         f"click session clicks "
         f"{'identical' if np.array_equal(clk_c, clk_g) else 'DIFFER'}, "
         f"max |dIoU| {err:.2e} (tol 1e-5); first forward's logits "
         f"{logit_err:.3e} of the largest (tol {REF_LOGIT_TOL}) "
         f"{'ok' if ok else 'FAIL'} ({card})")
    if not ok:
        raise AssertionError(f"{name} reference checkpoint f32: cpu {iou_c} "
                             f"{clk_c}\ncuda {iou_g} {clk_g}\nlogits "
                             f"{logit_err}")
    graphs.clear()
    pred = Predictor(model, PredictorConfig(model=cfg, target_size=(448, 448),
                                            with_flip=True), device=dev)
    sessions, session = _family_sessions(pred, image, gt, REF_CLICKS)
    per_click, calls, _ = _launch_checks(
        sessions, per_round, 2 * REF_CLICKS, f"{name} bf16 sessions",
        traced=[(session, REF_CLICKS)] * 2)
    state0 = init_session(image, gt, cfg.num_max_points, (448, 448), dev)
    rv = _replay_vs_eager(pred, state0, REF_CLICKS, f"{name} from a "
                          f"reference .pth, bf16", card)
    del pred, model
    graphs.clear()
    torch.cuda.empty_cache()
    return calls, {"f32_iou_err": err, "f32_logit_err": logit_err,
                   "session_p50_ms": float(np.median(per_click)), **rv,
                   "load_s_cpu": load_s[0], "load_s_card": load_s[1]}


def phase_reference(dev, card: str):
    """Phase 19b: the ViT-B@448 VPU (depth 12, a 28 x 28 grid) from a
    reference-named .pth through `load_vpu_checkpoint`, and HRNet-18s +
    OCR-64 from RITM-named keys through `convert_hrnet_checkpoint` (its OCR
    conv biases kept), each loaded strictly by `registry.load`. Returns
    (wrapper counts, records)."""
    import tempfile
    import torch
    from pvpuformer_tpu_torch.models import registry
    from pvpuformer_tpu_torch.models.vpu import vpu_base_config
    from pvpuformer_tpu_torch.models.zoo.hrnet import HRNetISConfig
    from pvpuformer_tpu_torch.utils import torch_ingest
    from pvpuformer_tpu_torch.utils.serialization import flatten_tree
    total, recs = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        vcfg = vpu_base_config(dtype=torch.bfloat16)
        if vcfg.backbone.grid_size != (28, 28) or vcfg.backbone.depth != 12:
            raise AssertionError(f"ViT-B@448 grid {vcfg.backbone.grid_size}")
        t = time.perf_counter()
        vpath = os.path.join(tmp, "vpu.pth")
        torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in
                                   reference_vpu_sd(vcfg).items()},
                    "config": {"arch": "VitMultiGaussianVector_ed_Model"}},
                   vpath)
        write_s = time.perf_counter() - t

        def load_vpu(c):
            return registry.load(flatten_tree(
                torch_ingest.load_vpu_checkpoint(vpath, c)), c)
        depth = vcfg.backbone.depth
        calls, recs["vpu_vitb448"] = _reference_session(
            "ViT-B@448 VPU", vcfg, load_vpu, dev, card,
            {"fused_attention": depth, "fused_ln_mlp": depth,
             "minplus_rows": 1})
        recs["vpu_vitb448"]["write_s"] = write_s
        for k, v in calls.items():
            total[k] = total.get(k, 0) + v
        os.remove(vpath)

        hcfg = HRNetISConfig(dtype=torch.bfloat16)
        hpath = os.path.join(tmp, "hrnet.pth")
        torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in
                                   reference_hrnet_sd(hcfg).items()}}, hpath)
        biases = ("ocr.conv3x3.conv.b", "ocr.aux.c1.conv.b")

        def load_hrnet(c):
            tree = torch_ingest.convert_hrnet_checkpoint(
                torch_ingest.load_torch_state_dict(hpath), c)
            m = registry.load(flatten_tree(tree), c)
            state = m.state_dict()
            if not all(b in state and state[b].abs().max() > 0
                       for b in biases):
                raise AssertionError("HRNet's OCR conv biases did not load")
            return m
        calls, recs["hrnet18s"] = _reference_session(
            "HRNet-18s + OCR-64", hcfg, load_hrnet, dev, card,
            {"minplus_rows": 1})
        for k, v in calls.items():
            total[k] = total.get(k, 0) + v
    return total, recs


def phase_gate_and_reference(dev, card: str):
    """Phase 19: (a) the int8 gate, (b) reference checkpoints; prints one
    {"phase19": ...} JSON line and returns the wrapper counts."""
    t = time.perf_counter()
    _log("  (a) the int8 accuracy gate: bf16 against int8 sessions at "
         f"{', '.join(map(str, GATE_DIMS))}, random init and after "
         f"{GATE_TRAIN_STEPS} training steps")
    total, runs = phase_gate(dev, card)
    t_gate = time.perf_counter() - t
    _log("  (b) reference checkpoints: ViT-B@448 VPU and HRNet-18s from "
         "reference-named .pth files")
    ref_total, refs = phase_reference(dev, card)
    for k, v in ref_total.items():
        total[k] = total.get(k, 0) + v
    secs = time.perf_counter() - t
    print(json.dumps({"phase19": {"card": card, "gate": runs,
                                  "reference": refs, "launches": total,
                                  "gate_s": t_gate, "seconds": secs}}),
          flush=True)
    _log(f"  phase 19: {secs:.1f} s (the gate {t_gate:.1f} s) ({card})")
    return total


# phase 20: the last model-side modules (caption co-training, the decoder,
# the CLIP towers and their converters, the token shuffle)
CAPTIONS = ["a red box on the left", "the small square", "an object",
            "the thing in the middle of the picture", "", "a dog",
            "two shapes that touch", "x" * 100]
CAPTION_BATCH = 8         # 20a: rows of the ViT-B@448 caption steps
CAPTION_STEPS = 3         # 20a: steps of CAPTION_ITERS rounds, each way
CAPTION_ITERS = 3
# 20a: tiny f32 caption step, card (kernels) against the CPU (plain
# versions): loss absolute, every gradient of max(max |g|, 1); phase 8's
CAPTION_TOL = 1e-4
# 20b / 20c: f32 forwards on the card against the CPU, of the largest
# magnitude (the same f32 math summed in another order; phase 19b's)
F32_TOL = 1e-4
DECODER_COS = 0.98        # 20b: int8 against bf16, JAX's bound
DECODER_GRID = (28, 28)   # 20b: ViT-B@448's token grid
TOWER_BATCH = 2           # 20c: images / captions a tower forward


def tiny_text():
    """20a's tiny text tower (tests/test_engine.py:253-291's)."""
    from pvpuformer_tpu_torch.models.zoo.clip_text import ClipTextConfig
    return ClipTextConfig(width=32, heads=2, layers=2, context_length=32,
                          embed_dim=16)


def _grads_spy(model, tx, into, take=None):
    """tx.step wrapped to append take(model) to `into` first (default:
    every gradient, copied to the CPU)."""
    step = tx.step

    def cpu_grads(m):
        return {n: None if p.grad is None else p.grad.detach().cpu()
                for n, p in m.named_parameters()}

    def spy():
        into.append((take or cpu_grads)(model))
        return step()
    tx.step = spy


def phase_caption_parity(dev):
    """Phase 20a(i): one 2-round f32 caption step (a box round and a click
    round) of the tiny config with tiny_text(), on the card (kernels) and
    on the CPU (plain versions), the same weights and draws: the loss and
    every gradient, those of clip_text and caption_proj among them, within
    CAPTION_TOL."""
    import torch
    from pvpuformer_tpu_torch.engine.optimizer import make_optimizer
    from pvpuformer_tpu_torch.engine.train_step import TrainConfig, train_step
    from pvpuformer_tpu_torch.models.vpu import init_vpu
    from pvpuformer_tpu_torch.models.zoo.clip_text import byte_tokenizer

    cfg = TrainConfig(model=tiny_config().replace(text=tiny_text()))
    seed = _box_seed(cfg, 2)
    batch = train_batch(2, 64, 6)
    batch["captions"] = byte_tokenizer(CAPTIONS[:2], 32)
    runs = {}
    for where in ("cpu", dev):
        model = init_vpu(cfg.model, torch.Generator().manual_seed(1), "cpu")
        model.to(where)
        tx = make_optimizer(model, "sgd", lr=5e-5, momentum=0.9)
        grads = []
        _grads_spy(model, tx, grads)
        thr = torch.tensor([0.4, 0.375, 0.425], device=where)
        logs, _, _ = train_step(model, tx, batch,
                                torch.Generator().manual_seed(seed), thr,
                                cfg=cfg, num_iters=2, device=where)
        runs[str(where)] = (float(logs["loss"]), grads[0])
    (lc, gc), (lg, gg) = runs["cpu"], runs[str(dev)]
    if {n for n in gc if gc[n] is None} != {n for n in gg if gg[n] is None}:
        raise AssertionError("caption parity: different parameters got no "
                             "gradient")
    scale = max([1.0] + [float(t.abs().max()) for t in gc.values()
                         if t is not None])
    err = max(float((gc[n] - gg[n]).abs().max()) for n in gc
              if gc[n] is not None)
    text = {pre: max(float(g.abs().max()) for n, g in gg.items()
                     if n.startswith(pre) and g is not None)
            for pre in ("clip_text.", "caption_proj.")}
    ok = (abs(lc - lg) <= CAPTION_TOL and err <= CAPTION_TOL * scale
          and all(v > 0 for v in text.values()))
    _log(f"  20a tiny f32 caption step (2 rounds, a box round), cuda vs "
         f"cpu: loss {lg} vs {lc} (|d| {abs(lc - lg):.2e}, tol "
         f"{CAPTION_TOL}), max |dgrad| {err:.2e} (tol {CAPTION_TOL} x "
         f"{scale:.3g}), largest |grad| of the text tower / caption_proj "
         f"{text} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("caption parity: CUDA and CPU steps disagree")
    return {"loss_err": abs(lc - lg), "grad_err": err, "grad_scale": scale}


def phase_caption_train(dev, card: str):
    """Phase 20a(ii): ViT-B@448 bf16 with the default ClipTextConfig()
    (vocab 49408, context 77, width 512, 8 heads, 12 layers, embed 512),
    batch CAPTION_BATCH: CAPTION_STEPS steps of CAPTION_ITERS rounds with
    byte_tokenizer captions, then the same steps without captions. Each
    round launches the attention forward, its backward and the LN+MLP
    kernel `depth` times; the host syncs of one more step each way, with
    captions none more than without. Returns (model, config, wrapper
    counts, record)."""
    import torch
    from pvpuformer_tpu_torch.engine.optimizer import make_optimizer
    from pvpuformer_tpu_torch.engine.train_step import (TrainConfig,
                                                        _train_noise,
                                                        train_step)
    from pvpuformer_tpu_torch.models.vpu import init_vpu, vpu_base_config
    from pvpuformer_tpu_torch.models.zoo.clip_text import (ClipTextConfig,
                                                           byte_tokenizer)

    text = ClipTextConfig()
    mcfg = vpu_base_config(dtype=torch.bfloat16).replace(text=text)
    cfg = TrainConfig(model=mcfg)
    depth, b, ni = mcfg.backbone.depth, CAPTION_BATCH, CAPTION_ITERS
    model = init_vpu(mcfg, torch.Generator().manual_seed(0), dev)
    tx = make_optimizer(model, "adam", lr=5e-5)
    prefixes = ("clip_text.token_embedding", "clip_text.blocks.0.",
                "clip_text.blocks.11.", "clip_text.text_projection",
                "caption_proj.")

    def text_norms(m):
        """The text tower's gradient norms, on the card (no host copy)."""
        sq = {pre: [p.grad.float().square().sum()
                    for n, p in m.named_parameters()
                    if n.startswith(pre) and p.grad is not None]
              for pre in prefixes}
        return {pre: torch.stack(v).sum().sqrt() if v else None
                for pre, v in sq.items()}
    grads = []
    _grads_spy(model, tx, grads, text_norms)
    batch = train_batch(b, mcfg.backbone.img_size[0], mcfg.num_max_points)
    caps = byte_tokenizer(CAPTIONS[:b], text.context_length)
    first = _box_seed(cfg, ni)
    seeds = [first + i for i in range(CAPTION_STEPS)]
    types = [_train_noise(cfg, torch.Generator().manual_seed(s), 1, 1, 1,
                          ni)["prompt_types"] for s in seeds]
    boxes = sum(t.count(1) for t in types)
    rounds = CAPTION_STEPS * ni
    want = {"fused_attention": depth * rounds,
            "fused_attention_bwd": depth * rounds,
            "flash_attention": 0, "flash_attention_bwd": 0,
            "fused_ln_mlp": depth * rounds, "fused_ln_mlp_bwd": depth * rounds,
            "minplus_rows": CAPTION_STEPS * (ni - 1),
            "cc_labels": boxes, "component_max": boxes}
    thr = torch.tensor([0.4, 0.375, 0.425], device=dev)

    def step(seed, with_caps):
        bt = dict(batch, captions=caps) if with_caps else batch
        return train_step(model, tx, bt, torch.Generator().manual_seed(seed),
                          thr, cfg=cfg, num_iters=ni, device=dev)
    for with_caps in (True, False):                  # warm-up, each way
        step(first, with_caps)
    torch.cuda.synchronize()
    grads.clear()
    rec, total = {"types": types, "card": card}, {}
    for with_caps in (True, False):
        key = "captions" if with_caps else "no_captions"
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        ms, losses = [], []
        for s in seeds:
            t = time.perf_counter()
            logs, _, _ = step(s, with_caps)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
            losses.append(float(logs["loss"]))
        counts = _counts()
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        syncs = _host_syncs(lambda: step(first, with_caps))
        rec[key] = {"ms_per_step": ms, "losses": losses,
                    "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                    "launches": counts, "host_syncs": syncs}
        ok = counts == want and np.isfinite(losses).all()
        _log(f"  20a ViT-B@448 bf16, batch {b}, {CAPTION_STEPS} steps x {ni} "
             f"rounds {'with' if with_caps else 'without'} captions (prompt "
             f"types {types}): ms per step {[round(x, 1) for x in ms]}, "
             f"losses {[round(x, 4) for x in losses]}, peak "
             f"{rec[key]['peak_gib']:.2f} GiB; launches {counts} (want "
             f"{want}); host syncs in one more step "
             f"{sum(syncs.values())} {json.dumps(syncs)} "
             f"{'ok' if ok else 'FAIL'} ({card})")
        if not ok:
            raise AssertionError(f"caption steps ({key}): launches {counts}, "
                                 f"want {want}; losses {losses}")
    norms = {pre: [0.0 if g[pre] is None else float(g[pre])
                   for g in grads[:CAPTION_STEPS]]   # the caption steps
             for pre in prefixes}
    rec["text_grad_norms"] = norms
    more = sum(rec["captions"]["host_syncs"].values()) - \
        sum(rec["no_captions"]["host_syncs"].values())
    ok = all(min(v) > 0 for v in norms.values()) and more <= 0
    _log(f"  20a gradient norms of the text tower, per caption step: "
         f"{json.dumps({k: [round(x, 6) for x in v] for k, v in norms.items()})}"
         f"; host syncs with captions minus without: {more} "
         f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("caption steps: a text-tower gradient is zero "
                             "or captions add a host sync")
    return model, mcfg, total, rec


def phase_decoder(dev, card: str):
    """Phase 20b: the decoder at DecoderConfig() (3 layers, d 512, 8 heads,
    ffn 2048) with return_intermediate, vis (2, 784, 512) on the 28 x 28
    grid and txt (2, 77, 512) (with both flags set, (2, 784, 512): JAX adds
    the text positions to the threaded vis tokens), in all four forms: f32
    on the card against the CPU within F32_TOL of the largest magnitude;
    int8 (`quantize_params`: each packed in-projection one QuantLinear)
    against bf16 on the card, cosine of the final outputs > DECODER_COS;
    ms per call of each."""
    import copy
    import torch
    from pvpuformer_tpu_torch import nn
    from pvpuformer_tpu_torch.models.decoder import (DecoderConfig,
                                                     decoder_forward,
                                                     init_decoder)
    cfg = DecoderConfig(return_intermediate=True)
    cpu = init_decoder(cfg, torch.Generator().manual_seed(0), "cpu")
    f32 = copy.deepcopy(cpu).to(dev)
    bf16 = nn.cast_params(copy.deepcopy(cpu), torch.bfloat16).to(dev)
    int8 = nn.quantize_params(cpu, dtype=torch.bfloat16).to(dev)
    r = np.random.default_rng(0)
    hw = DECODER_GRID[0] * DECODER_GRID[1]
    vis = torch.from_numpy(r.normal(size=(2, hw, 512)).astype(np.float32))
    txts = {n: torch.from_numpy(r.normal(size=(2, n, 512)).astype(np.float32))
            for n in (77, hw)}
    out = {}
    for as_text in (False, True):
        for i2t in (False, True):
            txt = txts[hw if as_text and i2t else 77]
            name = f"as_text={as_text} image_to_token={i2t}"

            def run(m, dt):
                return decoder_forward(m, cfg, vis.to(dev, dt),
                                       txt.to(dev, dt), DECODER_GRID,
                                       as_text, i2t)
            want = decoder_forward(cpu, cfg, vis, txt, DECODER_GRID, as_text,
                                   i2t)
            got = run(f32, torch.float32)
            err = max(float((g.cpu() - w).abs().max())
                      / max(1e-30, float(w.abs().max()))
                      for g, w in zip(got, want))
            fb, fq = run(bf16, torch.bfloat16)[-1], run(int8, torch.bfloat16)[-1]
            a, q = fb.float().flatten(), fq.float().flatten()
            cos = float(a @ q / (a.norm() * q.norm()))
            ms = {k: _time_ms(lambda m=m, dt=dt: run(m, dt), iters=5)
                  for k, m, dt in (("f32", f32, torch.float32),
                                   ("bf16", bf16, torch.bfloat16),
                                   ("int8", int8, torch.bfloat16))}
            ok = (len(got) == cfg.num_layers and err <= F32_TOL
                  and cos > DECODER_COS
                  and all(bool(torch.isfinite(t).all()) for t in (fb, fq)))
            out[name] = {"f32_err": err, "int8_cos": cos, "ms": ms}
            _log(f"  20b decoder {name}, txt {tuple(txt.shape)}: f32 cuda vs "
                 f"cpu {err:.3e} of the largest (tol {F32_TOL}, "
                 f"{len(got)} intermediates); int8 vs bf16 cosine {cos:.5f} "
                 f"(> {DECODER_COS}); ms per call "
                 f"{ {k: round(v, 3) for k, v in ms.items()} } "
                 f"{'ok' if ok else 'FAIL'} ({card})")
            if not ok:
                raise AssertionError(f"decoder {name}: {out[name]}")
    return out


def _normal(r, shape, fan_in=None):
    """A weight of the given shape at 1 / sqrt(fan_in) (activations stay of
    order one through the towers)."""
    fan_in = fan_in or int(np.prod(shape[1:]))
    return r.normal(0, fan_in ** -0.5, shape).astype(np.float32)


def _ref_ln(sd, r, name, c):
    sd[f"{name}.weight"] = (1 + r.normal(0, 0.1, c)).astype(np.float32)
    sd[f"{name}.bias"] = r.normal(0, 0.1, c).astype(np.float32)


def _ref_block(sd, r, b, w):
    """CLIP's ResidualAttentionBlock: ln_1, the packed nn.MultiheadAttention
    in-projection, out_proj, ln_2, mlp c_fc / c_proj."""
    _ref_ln(sd, r, f"{b}.ln_1", w)
    sd[f"{b}.attn.in_proj_weight"] = _normal(r, (3 * w, w))
    sd[f"{b}.attn.in_proj_bias"] = r.normal(0, 0.02, 3 * w).astype(np.float32)
    sd[f"{b}.attn.out_proj.weight"] = _normal(r, (w, w))
    sd[f"{b}.attn.out_proj.bias"] = r.normal(0, 0.02, w).astype(np.float32)
    _ref_ln(sd, r, f"{b}.ln_2", w)
    sd[f"{b}.mlp.c_fc.weight"] = _normal(r, (4 * w, w))
    sd[f"{b}.mlp.c_fc.bias"] = r.normal(0, 0.02, 4 * w).astype(np.float32)
    sd[f"{b}.mlp.c_proj.weight"] = _normal(r, (w, 4 * w))
    sd[f"{b}.mlp.c_proj.bias"] = r.normal(0, 0.02, w).astype(np.float32)


def clip_text_reference_sd(cfg, seed=0):
    """A made-up CLIP text-encoder state dict (modeling/clip.py:353-456
    names and shapes; chip_smoke imports nothing of the tests)."""
    r, w = np.random.default_rng(seed), cfg.width
    sd = {"token_embedding.weight": r.normal(0, 0.02, (cfg.vocab_size, w))
          .astype(np.float32),
          "positional_embedding": r.normal(0, 0.01, (cfg.context_length, w))
          .astype(np.float32),
          "text_projection": _normal(r, (w, cfg.embed_dim), w),
          "logit_scale": np.float32(np.log(1 / 0.07))}
    for i in range(cfg.layers):
        _ref_block(sd, r, f"transformer.resblocks.{i}", w)
    _ref_ln(sd, r, "ln_final", w)
    return sd


def clip_vit_reference_sd(cfg, seed=0):
    """A made-up CLIP VisionTransformer state dict (clip.py:286-332, under
    `visual.`)."""
    r, w = np.random.default_rng(seed), cfg.width
    grid = cfg.input_resolution // cfg.patch_size
    p = "visual."
    sd = {f"{p}conv1.weight": _normal(r, (w, 3, cfg.patch_size,
                                          cfg.patch_size)),
          f"{p}class_embedding": r.normal(0, w ** -0.5, w).astype(np.float32),
          f"{p}positional_embedding": r.normal(
              0, w ** -0.5, (grid * grid + 1, w)).astype(np.float32),
          f"{p}proj": _normal(r, (w, cfg.output_dim), w)}
    _ref_ln(sd, r, f"{p}ln_pre", w)
    for i in range(cfg.layers):
        _ref_block(sd, r, f"{p}transformer.resblocks.{i}", w)
    _ref_ln(sd, r, f"{p}ln_post", w)
    return sd


def clip_resnet_reference_sd(cfg, seed=0):
    """A made-up CLIP ModifiedResNet state dict (clip.py:147-223; the
    attention pool with its conv + BN `connect` residual), no prefix."""
    r, w, ed = np.random.default_rng(seed), cfg.width, cfg.embed_dim
    sd = {}

    def conv_bn(conv, bn, cin, cout, k=1):
        sd[f"{conv}.weight"] = _normal(r, (cout, cin, k, k))
        sd[f"{bn}.weight"] = (1 + r.normal(0, 0.1, cout)).astype(np.float32)
        sd[f"{bn}.bias"] = r.normal(0, 0.1, cout).astype(np.float32)
        sd[f"{bn}.running_mean"] = r.normal(0, 0.1, cout).astype(np.float32)
        sd[f"{bn}.running_var"] = r.uniform(0.5, 2, cout).astype(np.float32)

    def lin(name, i, o):
        sd[f"{name}.weight"] = _normal(r, (o, i))
        sd[f"{name}.bias"] = r.normal(0, 0.02, o).astype(np.float32)

    conv_bn("conv1", "bn1", 3, w // 2, 3)
    conv_bn("conv2", "bn2", w // 2, w // 2, 3)
    conv_bn("conv3", "bn3", w // 2, w, 3)
    cin = w
    for li, (blocks, mult) in enumerate(zip(cfg.layers, (1, 2, 4, 8))):
        planes = w * mult
        for j in range(blocks):
            b = f"layer{li + 1}.{j}"
            conv_bn(f"{b}.conv1", f"{b}.bn1", cin, planes)
            conv_bn(f"{b}.conv2", f"{b}.bn2", planes, planes, 3)
            conv_bn(f"{b}.conv3", f"{b}.bn3", planes, planes * 4)
            if j == 0:
                conv_bn(f"{b}.downsample.0", f"{b}.downsample.1", cin,
                        planes * 4)
            cin = planes * 4
    sd["attnpool.positional_embedding"] = r.normal(
        0, ed ** -0.5, (cfg.spacial_dim ** 2 + 1, ed)).astype(np.float32)
    for n in ("q", "k", "v"):
        lin(f"attnpool.{n}_proj", ed, ed)
    lin("attnpool.c_proj", ed, cfg.output_dim)
    conv_bn("attnpool.connect.0", "attnpool.connect.1", ed, cfg.output_dim)
    return sd


def phase_clip(dev, card: str):
    """Phase 20c: the CLIP towers at their default widths, built by the
    converters from reference-named state dicts (`convert_clip_resnet`,
    `convert_clip_vit`, `convert_clip_text`) and loaded strictly
    (`load_clip`: every converted leaf in the module bit for bit), f32 on
    the card against the CPU within F32_TOL of the largest magnitude: RN50
    at 224 (`ClipVisualConfig()`: x2, x3 and the attention-pooled x4),
    ViT-B/16 at 224 (`ClipViTConfig()`) and the text encoder
    (`ClipTextConfig()`) on byte_tokenizer captions; ms per call."""
    import copy
    import torch
    from pvpuformer_tpu_torch import nn
    from pvpuformer_tpu_torch.models.zoo import clip_text as C
    from pvpuformer_tpu_torch.utils import torch_ingest as ti
    from pvpuformer_tpu_torch.utils.serialization import (flatten_tree,
                                                          params_from_numpy)
    nn.resolve_device(dev)                 # full-f32 convs on the card
    r = np.random.default_rng(1)
    images = torch.from_numpy(r.normal(size=(TOWER_BATCH, 224, 224, 3))
                              .astype(np.float32))
    text = C.ClipTextConfig()
    tokens = torch.from_numpy(C.byte_tokenizer(CAPTIONS[:TOWER_BATCH],
                                               text.context_length))
    cases = (("RN50", C.ClipVisualConfig(), clip_resnet_reference_sd,
              ti.convert_clip_resnet, C.encode_image_resnet, images),
             ("ViT-B/16", C.ClipViTConfig(), clip_vit_reference_sd,
              ti.convert_clip_vit, C.encode_image_vit, images),
             ("text", text, clip_text_reference_sd, ti.convert_clip_text,
              C.encode_text, tokens))
    out = {}
    for name, cfg, make_sd, convert, encode, x in cases:
        tree = convert(make_sd(cfg), cfg)
        module = ti.load_clip(tree, cfg)
        state = module.state_dict()
        flat = params_from_numpy(flatten_tree(tree))
        same = set(state) == set(flat) and all(
            torch.equal(state[k], v) for k, v in flat.items())
        gpu = copy.deepcopy(module).to(dev)
        want = encode(module, cfg, x)
        got = encode(gpu, cfg, x.to(dev))
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        err = max(float((g.cpu() - w).abs().max())
                  / max(1e-30, float(w.abs().max())) for g, w in zip(got, want))
        ms = _time_ms(lambda: encode(gpu, cfg, x.to(dev)), iters=5)
        ok = same and err <= F32_TOL and all(
            bool(torch.isfinite(g).all()) for g in got)
        out[name] = {"f32_err": err, "ms": ms,
                     "shapes": [list(g.shape) for g in got],
                     "leaves": len(flat)}
        _log(f"  20c CLIP {name}: converted from a reference-named state "
             f"dict, {len(flat)} leaves loaded strictly "
             f"{'bit for bit' if same else 'DIFFER'}; f32 cuda vs cpu "
             f"{err:.3e} of the largest (tol {F32_TOL}), outputs "
             f"{out[name]['shapes']}, {ms:.3f} ms per call on the card "
             f"{'ok' if ok else 'FAIL'} ({card})")
        if not ok:
            raise AssertionError(f"CLIP {name}: {out[name]}")
    return out


def phase_shuffle(dev, card: str, model, mcfg):
    """Phase 20d: the token shuffle forward of ViT-B@448 bf16 (20a's model,
    batch CAPTION_BATCH, no captions): every block global on tokens
    gathered by its noise's stable argsort, so each forward launches the
    attention and LN+MLP kernels `depth` times; against the same forward
    with their plain twins patched into `models.vit` on the card
    (`_plain_twins`, no launch), and random noise against sorted noise
    (the identity permutation: attention is equivariant under a
    permutation of the tokens), each within TILED_BF16_TOL of max(1, the
    largest |logit|)."""
    import torch
    from pvpuformer_tpu_torch.models.vit import shuffle_noise
    from pvpuformer_tpu_torch.models.vpu import vpu_forward
    depth, b = mcfg.backbone.depth, CAPTION_BATCH
    batch = train_batch(b, mcfg.backbone.img_size[0], mcfg.num_max_points)
    img = torch.cat([torch.from_numpy(batch["image"]),
                     torch.zeros(b, *batch["image"].shape[1:3], 1)], -1)
    img, pts = img.to(dev), torch.from_numpy(batch["points"]).to(dev)
    noise = shuffle_noise(mcfg.backbone, torch.Generator().manual_seed(0),
                          b).to(dev)
    n = mcfg.backbone.num_patches
    ident = (torch.arange(n, device=dev) / n).expand(depth, b, n)

    def fwd(nz):
        with torch.no_grad():
            return vpu_forward(model, mcfg, img, pts,
                               shuffle_noise=nz)["instances"].float()
    fwd(noise)
    torch.cuda.synchronize()
    _zero_counts()
    got = fwd(noise)
    torch.cuda.synchronize()
    counts = _counts()
    want = {"fused_attention": depth, "fused_ln_mlp": depth}
    _round_counts([counts], want, "shuffle forward")
    _zero_counts()
    with _plain_twins():
        plain = fwd(noise)
    torch.cuda.synchronize()
    _round_counts([_counts()], {}, "shuffle forward, plain twins")
    same = fwd(ident)
    scale = max(1.0, float(plain.abs().max()))
    err_plain = float((got - plain).abs().max()) / scale
    err_perm = float((got - same).abs().max()) / max(
        1.0, float(same.abs().max()))
    ms = {"shuffle": _time_ms(lambda: fwd(noise), iters=5),
          "windowed (no noise)": _time_ms(lambda: fwd(None), iters=5)}
    ok = (bool(torch.isfinite(got).all()) and err_plain <= TILED_BF16_TOL
          and err_perm <= TILED_BF16_TOL)
    _log(f"  20d shuffle forward ViT-B@448 bf16, batch {b}: launches "
         f"{ {k: v for k, v in counts.items() if v} } (want {want}); "
         f"kernels vs plain twins {err_plain:.4e}, random vs sorted noise "
         f"{err_perm:.4e} of max(1, the largest |logit|) (limit "
         f"{TILED_BF16_TOL}); ms per forward "
         f"{ {k: round(v, 2) for k, v in ms.items()} } "
         f"{'ok' if ok else 'FAIL'} ({card})")
    if not ok:
        raise AssertionError(f"shuffle forward: {err_plain}, {err_perm}")
    return counts, {"vs_plain": err_plain, "vs_identity": err_perm,
                    "ms": ms, "launches": counts}


def phase_models(dev, card: str):
    """Phase 20: (a) caption co-training, (b) the decoder, (c) the CLIP
    towers and converters, (d) the token shuffle; prints one
    {"phase20": ...} JSON line and returns the wrapper counts."""
    import torch
    t0 = time.perf_counter()
    times, rec = {}, {"card": card}
    rec["caption_parity"] = phase_caption_parity(dev)
    times["20a_parity"] = time.perf_counter() - t0
    t = time.perf_counter()
    model, mcfg, total, rec["caption_steps"] = phase_caption_train(dev, card)
    times["20a_steps"] = time.perf_counter() - t
    t = time.perf_counter()
    counts, rec["shuffle"] = phase_shuffle(dev, card, model, mcfg)
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v
    times["20d"] = time.perf_counter() - t
    del model
    torch.cuda.empty_cache()
    t = time.perf_counter()
    rec["decoder"] = phase_decoder(dev, card)
    times["20b"] = time.perf_counter() - t
    t = time.perf_counter()
    rec["clip"] = phase_clip(dev, card)
    times["20c"] = time.perf_counter() - t
    torch.cuda.empty_cache()
    rec["seconds"] = dict(times, whole=time.perf_counter() - t0)
    rec["launches"] = total
    print(json.dumps({"phase20": rec}), flush=True)
    _log(f"  phase 20: {rec['seconds']['whole']:.1f} s "
         f"{ {k: round(v, 1) for k, v in times.items()} } ({card})")
    return total


# phase 21: the entry scripts
REHEARSAL_RUNS = 6        # prepare_data rehearse without --skip-large
REHEARSAL_TIMEOUT = 900   # s: the rehearsal's six evaluation processes
DEMO_IOU_GAIN = 0.3       # the demo's last logged AdaptiveIoU over its first
HBM_FIT_TOL = 0.10        # hbm_fit's num_iters=3 peak against phase 9's
LOADER_BENCH = ["--images", "16", "--batches", "3", "--workers", "4",
                "--types", "thread", "process"]


def _rehearsal(out: str):
    """prepare_data rehearse's output -> [(title, seconds, NoC row)]."""
    runs = []
    for part in out.split("--- rehearsing BASELINE ")[1:]:
        lines = part.splitlines()
        rows = [ln for ln in lines if ln.startswith("|") and "NoBRS" in ln]
        secs = [float(ln.split(" in ")[1].split()[0]) for ln in lines
                if ln.startswith("(rc 0 in ")]
        runs.append((lines[0], secs[0] if secs else None,
                     rows[-1] if rows else None))
    return runs


def _demo_train_counts(cfg, steps, depth: int):
    """The wrapper calls of the demo's training steps [(generator seed,
    num_iters)] (phase 9's count; f32, so no LN+MLP kernel)."""
    import torch
    from pvpuformer_tpu_torch.engine.train_step import _train_noise
    types = [_train_noise(cfg, torch.Generator().manual_seed(seed), 1, 1, 1,
                          ni)["prompt_types"] for seed, ni in steps]
    return _scale_launches(depth, types) | {"fused_ln_mlp": 0,
                                            "fused_ln_mlp_bwd": 0}


def _demo_and_fit(dev, card: str, rec, times, total):
    """Phase 21 (b) and (c), in this process: the demo, then hbm_fit;
    their results go into `rec` and `times`, their wrapper counts into
    `total`."""
    import copy
    import torch
    from pvpuformer_tpu_torch import demo_train_eval_synthetic as demo
    from pvpuformer_tpu_torch import hbm_fit
    from pvpuformer_tpu_torch.engine import trainer as ttr
    from pvpuformer_tpu_torch.engine.train_step import (TrainConfig,
                                                        _train_noise)
    from pvpuformer_tpu_torch.inference import graphs
    from pvpuformer_tpu_torch.models.vpu import init_vpu, vpu_base_config

    # (b) the demo
    t = time.perf_counter()
    mcfg = demo.model_config()
    model = init_vpu(mcfg, torch.Generator().manual_seed(0), "cpu")
    initial = copy.deepcopy(model)
    steps, step = [], ttr.train_step

    def rec_step(*a, **kw):
        steps.append((a[3].initial_seed(), kw["num_iters"]))
        return step(*a, **kw)

    ttr.train_step = rec_step
    _zero_counts()
    try:
        curve = demo.train(model, device=dev,
                           log=lambda ln: _log(f"  demo {ln}"))
    finally:
        ttr.train_step = step
    torch.cuda.synchronize()
    counts = _counts()
    want = dict.fromkeys(counts, 0) | _demo_train_counts(
        TrainConfig(model=mcfg), steps, mcfg.backbone.depth)
    times["21b_train"] = time.perf_counter() - t
    _log(f"  demo training: {len(steps)} steps, "
         f"{sum(n for _, n in steps)} rounds in "
         f"{times['21b_train']:.1f} s; launches "
         f"{ {k: v for k, v in counts.items() if v} } expected "
         f"{ {k: v for k, v in want.items() if v} }")
    if counts != want:
        raise AssertionError("the demo's training launched the kernels "
                             "other than its steps call them")
    total.update(counts)
    t = time.perf_counter()
    rows = {}
    for name, m, int8 in (("random", initial, False),
                          ("trained", model, False),
                          ("trained+int8", model, True)):
        r0 = dict(graphs.rounds)
        _zero_counts()
        noc, over, ious = demo.noc_row(m, int8, device=dev)
        torch.cuda.synchronize()
        counts = _counts()
        called = sum(graphs.rounds[k] - r0[k]
                     for k in ("eager", "captured"))
        want = dict.fromkeys(counts, 0) | {
            "fused_attention": mcfg.backbone.depth * called,
            "minplus_rows": called}
        got = {k: v for k, v in counts.items() if v}
        final = [round(float(a[-1]), 3) for a in ious]
        rows[name] = {"noc50": float(noc[0]), "noc80": float(noc[1]),
                      "over80": int(over[1]), "final": final,
                      "launches": got}
        _log(f"  demo {name}: NoC@50 {noc[0]:.2f} NoC@80 {noc[1]:.2f} "
             f">=10@80 {over[1]} final IoUs {final}; launches {got} "
             f"over {called} eager / captured rounds (expected "
             f"{ {k: v for k, v in want.items() if v} })")
        if counts != want or not all(np.isfinite(a).all() for a in ious):
            raise AssertionError(f"the demo's {name} row: launches {got}"
                                 f" (want {want}) or a curve not finite")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    times["21b_eval"] = time.perf_counter() - t
    ious_logged = [c["AdaptiveIoU"] for c in curve]
    gain = ious_logged[-1] - ious_logged[0]
    rec["demo"] = {"curve": [{"epoch": c["epoch"], "loss": c["loss"],
                              "AdaptiveIoU": c["AdaptiveIoU"]}
                             for c in curve], "rows": rows,
                   "steps": len(steps)}
    ok = (rows["trained"]["noc50"] < rows["random"]["noc50"]
          and gain >= DEMO_IOU_GAIN)
    _log(f"  demo: AdaptiveIoU {ious_logged[0]:.3f} -> "
         f"{ious_logged[-1]:.3f} (+{gain:.3f}, want >= {DEMO_IOU_GAIN}); "
         f"NoC@50 trained {rows['trained']['noc50']:.2f} against random "
         f"{rows['random']['noc50']:.2f} {'ok' if ok else 'FAIL'} "
         f"({card})")
    if not ok:
        raise AssertionError("the demo did not learn: NoC@50 or "
                             "AdaptiveIoU")
    del model, initial
    graphs.clear()
    torch.cuda.empty_cache()

    # (c) hbm_fit at its defaults; its peaks count what this process holds
    # already (`held`)
    held = torch.cuda.memory_allocated() / 2 ** 30
    t = time.perf_counter()
    _zero_counts()
    fit = hbm_fit.main([])
    counts = _counts()
    times["21c"] = time.perf_counter() - t
    bcfg = TrainConfig(model=vpu_base_config(dtype=torch.bfloat16))
    types = [_train_noise(bcfg, torch.Generator().manual_seed(1), 1, 1, 1,
                          r["num_iters"])["prompt_types"] for r in fit]
    want = dict.fromkeys(counts, 0) | _scale_launches(
        bcfg.model.backbone.depth, types)
    got = {k: v for k, v in counts.items() if v}
    peak3 = next(r["peak"] for r in fit if r["num_iters"] == 3) / 2 ** 30
    ref = TRAIN_PEAK_GIB.get("phase9")
    rel = abs(peak3 - ref) / ref if ref else None
    rec["hbm_fit"] = {"variants": fit, "phase9_peak_gib": ref,
                      "rel_to_phase9": rel, "held_gib": held,
                      "launches": got}
    table = [(r["num_iters"], r["fits"],
              r["peak"] and round(r["peak"] / 2 ** 30, 2),
              r["step_ms"] and round(r["step_ms"], 1)) for r in fit]
    _log(f"  hbm_fit: {table} "
         f"(num_iters, fits, peak GiB, step ms; {held:.2f} GiB held by "
         f"this process before it); num_iters=3 peak "
         f"{peak3:.2f} GiB against phase 9's "
         f"{'not run' if ref is None else f'{ref:.2f}'} GiB"
         f"{'' if rel is None else f' ({rel:.1%}, tol {HBM_FIT_TOL:.0%})'}"
         f"; launches {got} expected "
         f"{ {k: v for k, v in want.items() if v} } ({card})")
    if not all(r["fits"] for r in fit) or counts != want:
        raise AssertionError("hbm_fit: a variant did not fit, or the "
                             "kernels ran other than its steps call them")
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v
    torch.cuda.empty_cache()


def start_rehearsal():
    """Phase 21a, `python -m pvpuformer_tpu_torch.prepare_data rehearse`
    (without --skip-large) into a temporary directory, started before
    phase 19 so that its six evaluation processes run beside phases 19-21
    (for time; nothing there is a speed claim, and no graph pool of this
    process is large then): (the started process, the directory)."""
    import tempfile
    out = tempfile.mkdtemp(prefix="pvpu_rehearsal_")
    return _start(["pvpuformer_tpu_torch.prepare_data", "rehearse", "--out",
                   out, "--device", "cuda"], ROOT), out


def phase_scripts(dev, card: str, rehearsal):
    """Phase 21: the port's entry scripts. (a) the BASELINE rehearsal that
    `start_rehearsal` started: six evaluation processes at ViT-B / L / H
    @448 on the fixtures, each at rc 0 with its NoC row and seconds; (b)
    the demo at its defaults, in this process: 40 epochs of the tiny f32
    VPU, then the random, trained and trained+int8 NoC rows, with the
    launch counts of its training steps and of each row's eager and
    captured rounds; (c) `hbm_fit` at its defaults, in this process
    (ViT-B@448 bf16, batch 32, num_iters 1-3), its launches and its
    num_iters=3 peak against phase 9's; (d) `python -m
    pvpuformer_tpu_torch.bench_loader` reduced (LOADER_BENCH), after the
    rehearsal has ended. Prints one {"phase21": ...} JSON line; returns the
    in-process wrapper counts."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    times, rec, total = {}, {"card": card}, {}
    started, fixtures = rehearsal
    try:
        _demo_and_fit(dev, card, rec, times, total)
        out, _ = _finish(started, "the BASELINE rehearsal",
                         timeout=REHEARSAL_TIMEOUT)
    finally:
        _stop(started)
        shutil.rmtree(fixtures, ignore_errors=True)
    runs = _rehearsal(out)
    times["21a"] = sum(s for _, s, _ in runs if s)
    rec["rehearsal"] = [{"config": t, "seconds": s, "noc_row": r}
                        for t, s, r in runs]
    for t, s, r in runs:
        _log(f"  rehearsal {t}: rc 0 in {s} s; {r}")
    if len(runs) != REHEARSAL_RUNS or any(r is None for *_, r in runs) \
            or "ALL BASELINE commands ran end-to-end" not in out:
        raise AssertionError(f"the rehearsal ran {len(runs)} of "
                             f"{REHEARSAL_RUNS} configurations:\n{out}")

    with tempfile.TemporaryDirectory() as tmp:
        lout, times["21d"] = _subprocess(
            ["pvpuformer_tpu_torch.bench_loader", *LOADER_BENCH, "--root",
             tmp], ROOT, "the loader bench")
    lines = [ln for ln in lout.splitlines()
             if "samples/s" in ln or ln.startswith("#")]
    rates = {ln.split()[0]: float(ln.split(":")[1].split()[0])
             for ln in lines if "workers=" in ln}
    rec["loader"] = {"lines": lines, "rates": rates}
    for ln in lines:
        _log(f"  bench_loader {ln}")
    if set(rates) != {"thread", "process"} or \
            not all(v > 0 for v in rates.values()):
        raise AssertionError(f"the loader bench printed no rate of a "
                             f"worker type:\n{lout}")
    rec["seconds"] = dict(times, whole=time.perf_counter() - t0)
    rec["launches"] = total
    print(json.dumps({"phase21": rec}), flush=True)
    _log(f"  phase 21: {rec['seconds']['whole']:.1f} s "
         f"{ {k: round(v, 1) for k, v in times.items()} } (21a: the "
         f"rehearsal's runs, beside phases 19-21) ({card})")
    return total


def _timed(phase, *args):
    """phase(*args), its wall time logged (the script's time budget)."""
    t = time.perf_counter()
    out = phase(*args)
    _log(f"  ({phase.__name__}: {time.perf_counter() - t:.1f} s)")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test needs a GPU",
              file=sys.stderr)
        return 2
    args = sys.argv[1:]
    if args[:1] == ["--worker"]:          # a rank that phase 17 starts
        {"scaleout": worker_scaleout, "fsdp": worker_fsdp}[args[1]](args[2])
        return 0
    t_script = time.perf_counter()
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    mm = torch.backends.cuda.matmul
    _log(f"[1/21] environment: {smi} | torch {torch.__version__} "
         f"cuda {torch.version.cuda} | torch's precision flags as they come "
         f"(the package pins its own): cudnn.allow_tf32 "
         f"{torch.backends.cudnn.allow_tf32}, matmul.allow_tf32 "
         f"{mm.allow_tf32}, allow_bf16_reduced_precision_reduction "
         f"{mm.allow_bf16_reduced_precision_reduction}")

    from pvpuformer_tpu_torch.inference import graphs
    from pvpuformer_tpu_torch.ops import _build
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    _log(f"[2/21] build: {lib_path} in {time.perf_counter() - t0:.1f} s")
    if "--profile" in sys.argv[1:]:
        _log("[profile] ViT-B@448 bf16 clicks under torch.profiler, then "
             "PlainVit and the zoo families")
        print(json.dumps({"profile": profile_paths(dev, smi), "card": smi}))
        graphs.clear()
        torch.cuda.empty_cache()
        print(json.dumps({"profile_families": profile_families(dev, smi),
                          "card": smi}))
        return 0

    _log("[3/21] kernels vs plain versions")
    res = _timed(phase_kernels, dev)
    _log("[4/21] model parity, tiny config f32")
    _timed(phase_parity, dev)
    _log("[5/21] main path: ViT-B@448 bf16 click sessions")
    launches, model = _timed(phase_main, dev, smi)
    _log("[6/21] prompt parity, tiny config f32, four prompt variants")
    _timed(phase_prompt_parity, dev)
    _log("[7/21] prompt path: ViT-B@448 bf16 box / scribble sessions")
    prompt_launches, _ = _timed(phase_prompts, dev, smi, model)
    for name in ("cc_labels", "component_max"):        # slice 2's path
        launches[name] = prompt_launches[name]
    del model
    graphs.clear()                  # the captured rounds' memory
    torch.cuda.empty_cache()
    _log("[8/21] training parity, tiny config f32")
    _timed(phase_train_parity, dev)
    _log("[9/21] training path: ViT-B@448 bf16 Trainer steps")
    train_launches = _timed(phase_train, dev, smi)
    launches["fused_attention_bwd"] = train_launches["fused_attention_bwd"]
    torch.cuda.empty_cache()
    _log("[10/21] evaluation parity, tiny config f32: sequential and "
         "batched, CUDA vs the CPU")
    _timed(phase_eval_parity, dev)
    _log("[11/21] batched evaluation: ViT-B@448 bf16, 21 objects x "
         f"{EVAL_CLICKS} clicks, sequential and B = "
         f"{' / '.join(map(str, EVAL_BATCHES))}")
    _timed(phase_batched, dev, smi)
    torch.cuda.empty_cache()
    _timed(phase_graph_cache, dev, smi)
    _log("[12/21] presets: ViT-L@448 and ViT-H@448 bf16 sessions")
    _timed(phase_presets, dev, smi)
    graphs.clear()
    torch.cuda.empty_cache()
    _log("[13/21] the training entry point: the tiny recipe and the "
         "evaluation CLI as processes; tiny steps CUDA vs the CPU; the "
         "shipped recipe through the data pipeline")
    _timed(phase_entry, dev)
    _timed(phase_recipe, dev, smi)
    torch.cuda.empty_cache()
    _log("[14/21] serving parity, tiny config f32: controller, int8 and BRS "
         "sessions, CUDA vs the CPU")
    _timed(phase_serving_parity, dev)
    _log("[15/21] serving at ViT-B@448 bf16: the HTTP service, the demo, "
         "user clicks (bf16 and int8), f-BRS-B and RGB-BRS")
    serving = _timed(phase_serving, dev, smi)
    for name in ("fused_attention", "fused_attention_bwd", "minplus_rows",
                 "fused_ln_mlp"):
        launches[name] += serving.get(name, 0)
    graphs.clear()
    torch.cuda.empty_cache()
    _log("[16/21] model families: PlainVit ViT-B@448 and the zoo at their "
         "default configs, bf16; tiny f32 parity")
    families = _timed(phase_families, dev, smi)
    for name in launches:
        launches[name] += families.get(name, 0)
    graphs.clear()
    torch.cuda.empty_cache()
    _log("[17/21] scale-out: 2 gloo ranks on the card (ViT-B@448 bf16 "
         f"at depth {SCALE_DEPTH}: training, sharded batched evaluation, "
         "tensor parallelism tp and "
         "tp+fsdp at M = 2), FSDP at world size 1 under NCCL (the ViT-L "
         f"recipe at depth {FSDP_DEPTH}), evaluate --eval-mesh 1")
    scale = _timed(phase_scaleout, dev, smi)
    for name in launches:
        launches[name] += scale.get(name, 0)
    # launch (b') runs on the TP leg's path only: one per forward call of
    # the tensor-parallel LN+MLP
    launches["fc2_partial"] = scale.get("fused_ln_mlp_tp", 0)
    graphs.clear()
    torch.cuda.empty_cache()
    _log("[18/21] the evaluation CLI's protocols: the launcher's command, "
         "--profile and --vis-preds as processes; the CFR cascade, "
         "--eval-ritm and --eval-mode fixed448,672 sessions at ViT-B@448 "
         "bf16")
    cli_launches = _timed(phase_eval_cli, dev, smi)
    for name in launches:
        launches[name] += cli_launches.get(name, 0)
    graphs.clear()
    torch.cuda.empty_cache()
    rehearsal = start_rehearsal()       # phase 21a, beside phases 19-21
    try:
        _log("[19/21] the int8 accuracy gate at the ViT-B/L/H widths "
             "(random and trained weights) and reference checkpoints: the "
             "ViT-B@448 VPU and HRNet-18s from reference-named .pth files")
        gate_launches = _timed(phase_gate_and_reference, dev, smi)
        for name in launches:
            launches[name] += gate_launches.get(name, 0)
        graphs.clear()
        torch.cuda.empty_cache()
        _log("[20/21] the last model-side modules: caption co-training at "
             "ViT-B@448 bf16 with the CLIP text tower, the vision-language "
             "decoder (f32, bf16, int8), the CLIP towers from their "
             "converters, the token shuffle forward")
        model_launches = _timed(phase_models, dev, smi)
        for name in launches:
            launches[name] += model_launches.get(name, 0)
        graphs.clear()
        torch.cuda.empty_cache()
        _log("[21/21] the entry scripts: the BASELINE rehearsal at ViT-B / "
             "L / H@448 (six evaluation processes, started before phase "
             "19), the train-then-evaluate demo, hbm_fit at batch 32 and "
             "the on-disk loader bench")
        script_launches = _timed(phase_scripts, dev, smi, rehearsal)
    except BaseException:
        _stop(rehearsal[0])
        raise
    for name in launches:
        launches[name] += script_launches.get(name, 0)
    _log(f"whole script: {time.perf_counter() - t_script:.1f} s, of which "
         f"{TRACE_COST['seconds']:.1f} s in {TRACE_COST['windows']} "
         f"profiler windows (this process's launch checks, the traced "
         f"work included)")

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
        # the same TPU kernel under tensor parallelism: launch (b')
        "fc2_partial": ("pvpuformer_tpu_torch/csrc/fused_mlp.cu",
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
