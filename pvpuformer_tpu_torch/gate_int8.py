"""Protocol-level int8-vs-bf16 accuracy gate of the int8 serving path
(scripts/gate_int8.py in the port's idiom).

Runs the click loop (`Predictor.run_clicks`, the program the port's bench
times) twice on one model, float and int8 (`nn.quantize_params`), over
synthetic ellipse samples at the depth-4 protocol config of a chosen
width, and reports:

  * click-sequence divergence: the share of sessions whose (sign, y, x)
    click sequences differ anywhere, and each one's first divergent click;
  * per-click |IoU(float) - IoU(int8)| mean / p95 / max;
  * NoC@50/80 under both paths and the final mIoU.

`--train-steps K` first fits the model on synthetic blobs for K steps
(Adam 5e-5, the iterloss step) so that the comparison also covers trained
decision boundaries. The summary has the keys and rounding of the JAX
script's JSON.

The gate computes in bfloat16, the dtype the port serves on the card.
`protocol_cfg` at its default dtype builds the JAX script's config, whose
dtype is float32; on a TPU, JAX's default matmul precision rounds float32
operands to bf16, which is what the JAX script calls its bf16 path.

    python -m pvpuformer_tpu_torch.gate_int8 [--samples 24] [--clicks 6]
        [--train-steps 0] [--dim {768,1024,1280}] [--device cpu]

Without `--device` it runs on the card, and raises where there is none.
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .models.fpn import NeckConfig
from .models.seg_head import HeadConfig
from .models.two_way import TwoWayConfig
from .models.vit import ViTConfig
from .models.vpu import VPUConfig
from .nn import resolve_device


def protocol_cfg(nmp: int = 24, crop=(224, 224), dim: int = 768,
                 dtype=torch.float32) -> VPUConfig:
    """The depth-4 protocol config at a chosen width: 768 = ViT-B (12
    heads, patch 16), 1024 = ViT-L (16 heads, patch 16), 1280 = ViT-H (16
    heads, patch 14: a 16x16 token grid at 224 like the others). Depth
    stays 4, so that the gate measures the quantized linears' geometry at
    that fan-in and fan-out; the two-way neck and the head's d_model are
    at full width. At the default dtype the fields are the JAX script's."""
    heads = {768: 12, 1024: 16, 1280: 16}[dim]
    patch = 14 if dim == 1280 else 16
    return VPUConfig(
        backbone=ViTConfig(img_size=crop, patch_size=(patch, patch),
                           embed_dim=dim, depth=4, num_heads=heads),
        neck=NeckConfig(in_dim=dim, out_dims=(128, 256, 512, 1024),
                        img_size=crop,
                        two_way=TwoWayConfig(embedding_dim=dim)),
        head=HeadConfig(in_channels=(128, 256, 512, 1024), channels=256,
                        upsample="x1", d_model=dim),
        num_max_points=nmp, dtype=dtype)


def synth_sample(seed: int, h: int = 96, w: int = 128
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """A random-noise image with one ellipse as its ground truth."""
    r = np.random.default_rng(seed)
    image = (r.uniform(size=(h, w, 3)) * 255).astype(np.uint8)
    yy, xx = np.mgrid[:h, :w]
    cy, cx = r.integers(h // 4, 3 * h // 4), r.integers(w // 4, 3 * w // 4)
    ry, rx = r.integers(12, h // 3), r.integers(12, w // 3)
    gt = (((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0)
    return image, gt.astype(np.float32)


def train_batch(step: int, batch: int, h: int, w: int, sampler,
                rng: np.random.Generator) -> Dict[str, np.ndarray]:
    """Step `step`'s batch of synthetic blobs on an (h, w) canvas, with the
    sampler's clicks drawn from `rng` (one stream over all steps)."""
    imgs, gts, pts = [], [], []
    for i in range(batch):
        img, gt = synth_sample(10_000 + step * batch + i, h, w)
        canvas_img = np.zeros((h, w, 3), np.float32)
        canvas_gt = np.zeros((h, w), np.float32)
        canvas_img[:img.shape[0], :img.shape[1]] = img / 255.0
        canvas_gt[:gt.shape[0], :gt.shape[1]] = gt
        imgs.append(canvas_img)
        gts.append(canvas_gt)
        pts.append(sampler.sample(rng, [canvas_gt > 0.5])[0])
    return {"image": np.stack(imgs),
            "instances": np.stack(gts)[..., None],
            "points": np.stack(pts).astype(np.float32),
            "scribbles": np.zeros((batch, 1000, 2), np.float32),
            "scribble_rects": np.zeros((batch, 4), np.float32)}


def train_synthetic(model, mcfg: VPUConfig, steps: int, batch: int = 4,
                    gen: Optional[torch.Generator] = None,
                    device=None) -> List[float]:
    """Fit `model` in place on synthetic blobs (the synthetic training
    recipe at the gate's crop): Adam 5e-5, num_iters 1 + step % 3. Each
    step's draws come from `gen` (a CPU generator; seeded 0 when None).
    Returns the per-step losses."""
    from .data.points_sampler import MultiPointSampler
    from .engine.optimizer import make_optimizer
    from .engine.train_step import TrainConfig, train_step

    h, w = mcfg.backbone.img_size
    tcfg = TrainConfig(model=mcfg)
    tx = make_optimizer(model, "adam", lr=5e-5, milestones=(), gamma=1.0,
                        steps_per_epoch=steps)
    sampler = MultiPointSampler(mcfg.num_max_points, prob_gamma=0.8)
    thr = torch.tensor([0.5], device=resolve_device(device))
    rng = np.random.default_rng(0)
    if gen is None:
        gen = torch.Generator().manual_seed(0)
    logs = []
    for step in range(steps):
        b = train_batch(step, batch, h, w, sampler, rng)
        out, _, _ = train_step(model, tx, b, gen, thr, cfg=tcfg,
                               num_iters=1 + step % 3, device=device)
        logs.append(out["loss"])
        if step % 25 == 0:
            print(f"  train step {step}: loss {float(out['loss']):.4f}",
                  flush=True)
    for p in model.parameters():
        p.requires_grad_(False)
    return [float(v) for v in torch.stack(logs).cpu()]


def click_sequence(points: np.ndarray) -> List[Tuple[bool, int, int]]:
    """A session's clicks (2N, 3) as (positive, y, x) in click order."""
    n = points.shape[0] // 2
    return [(bool(i < n), int(points[i, 0]), int(points[i, 1]))
            for i in np.argsort(points[:, 2]) if points[i, 2] >= 0]


def run_sessions(model, mcfg: VPUConfig, n_samples: int, clicks: int,
                 int8: bool, device=None):
    """`n_samples` oracle sessions of `clicks` clicks on synth_sample(s):
    the IoU curves (n_samples, clicks) and each session's click sequence."""
    from .inference.predictor import Predictor, PredictorConfig

    pcfg = PredictorConfig(model=mcfg, target_size=mcfg.backbone.img_size,
                           with_flip=True, skip_clicks=-1, min_crop_size=200)
    pred = Predictor(model, pcfg, device=device, int8=int8)
    curves, seqs = [], []
    for s in range(n_samples):
        image, gt = synth_sample(s)
        pred.set_input(image, gt)
        curves.append(pred.run_clicks(clicks))
        seqs.append(click_sequence(pred.clicks))
    return np.stack(curves), seqs


def noc(curves: np.ndarray, thr: float, max_clicks: int) -> float:
    reached = curves >= thr
    first = np.where(reached.any(axis=1), reached.argmax(axis=1) + 1,
                     max_clicks)
    return float(first.mean())


def first_divergence(a: Sequence, b: Sequence) -> int:
    """The first click index at which two click sequences differ."""
    return next(j for j in range(min(len(a), len(b)) + 1)
                if j >= len(a) or j >= len(b) or a[j] != b[j])


def summarize(bf: np.ndarray, q: np.ndarray, seq_bf, seq_q, dim: int,
              samples: int, clicks: int, train_steps: int) -> dict:
    """The gate's summary of float curves `bf` and int8 curves `q`."""
    diverged = [i for i in range(samples) if seq_bf[i] != seq_q[i]]
    delta = np.abs(bf - q)
    return {
        "dim": dim,
        "samples": samples, "clicks": clicks,
        "train_steps": train_steps,
        "seq_divergence_rate": round(len(diverged) / samples, 4),
        "first_divergent_click": [first_divergence(seq_bf[i], seq_q[i])
                                  for i in diverged],
        "iou_delta_mean": round(float(delta.mean()), 5),
        "iou_delta_p95": round(float(np.percentile(delta, 95)), 5),
        "iou_delta_max": round(float(delta.max()), 5),
        "noc50_bf16": round(noc(bf, 0.5, clicks), 3),
        "noc50_int8": round(noc(q, 0.5, clicks), 3),
        "noc80_bf16": round(noc(bf, 0.8, clicks), 3),
        "noc80_int8": round(noc(q, 0.8, clicks), 3),
        "final_miou_bf16": round(float(bf[:, -1].mean()), 4),
        "final_miou_int8": round(float(q[:, -1].mean()), 4),
    }


def gate(dim: int, samples: int, clicks: int, train_steps: int = 0,
         device=None):
    """One gate run in bf16: the model at the port's init seeded 0,
    optionally trained, then float and int8 sessions. Returns (summary,
    training losses, float curves, int8 curves)."""
    from .models.vpu import init_vpu

    mcfg = protocol_cfg(dim=dim, dtype=torch.bfloat16)
    model = init_vpu(mcfg, torch.Generator().manual_seed(0), device=device)
    losses: List[float] = []
    if train_steps:
        print(f"# training {train_steps} steps on synthetic blobs",
              flush=True)
        losses = train_synthetic(model, mcfg, train_steps, device=device)
    print(f"# gate: depth-4/{dim}@224, {samples} samples x {clicks} "
          f"clicks, bfloat16, weights="
          f"{'trained' if train_steps else 'random-init'}", flush=True)
    bf, seq_bf = run_sessions(model, mcfg, samples, clicks, False, device)
    q, seq_q = run_sessions(model, mcfg, samples, clicks, True, device)
    out = summarize(bf, q, seq_bf, seq_q, dim, samples, clicks, train_steps)
    return out, losses, bf, q


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--samples", type=int, default=24)
    ap.add_argument("--clicks", type=int, default=6)
    ap.add_argument("--train-steps", type=int, default=0)
    ap.add_argument("--dim", type=int, default=768, choices=[768, 1024, 1280],
                    help="quantization geometry: ViT-B/L/H widths")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; no fallback)")
    args = ap.parse_args(argv)
    out = gate(args.dim, args.samples, args.clicks, args.train_steps,
               args.device)[0]
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
