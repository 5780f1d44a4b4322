"""End-to-end validation demo of the port (scripts/demo_train_eval_synthetic.py
in the port's idiom): train the tiny VPU on synthetic data, then
NoC-evaluate the random, trained and trained+int8 weights through the click
loop.

The tiny config (64 x 64 crop, ViT depth 4, width 64, 6 points), the
sampler, the dataset sizes, `Loader(batch_size=16, num_workers=2)`, Adam
3e-4 and 40 epochs are the JAX script's; so are NoC@50 / NoC@80 over
`SyntheticDataset(n_samples=6, hw=(64, 64), seed=123)` at 10 clicks. The
training draws come from the Trainer's `torch.Generator`, so the curve is
not the JAX run's; at random init both packages evaluate the same weights
alike.

    python -m pvpuformer_tpu_torch.demo_train_eval_synthetic [--device cpu]

Without --device it runs on the card, and raises where there is none.
"""
from __future__ import annotations

import argparse
import copy
from typing import Callable, Dict, List, Optional

import torch

from .data import Loader, MultiPointSampler, SyntheticTrainDataset
from .engine.optimizer import make_optimizer
from .engine.train_step import TrainConfig
from .engine.trainer import Trainer
from .inference.datasets import SyntheticDataset
from .inference.evaluation import compute_noc_metric, evaluate_dataset
from .inference.predictor import Predictor, PredictorConfig
from .models.fpn import NeckConfig
from .models.seg_head import HeadConfig
from .models.two_way import TwoWayConfig
from .models.vit import ViTConfig
from .models.vpu import VPUConfig, VPUModel, init_vpu
from .nn import resolve_device

CROP = (64, 64)
EPOCHS = 40
EVAL_SAMPLES = 6
CLICKS = 10


def model_config() -> VPUConfig:
    """The demo's tiny VPU (f32)."""
    return VPUConfig(
        backbone=ViTConfig(img_size=CROP, patch_size=(16, 16), embed_dim=64,
                           depth=4, num_heads=2),
        neck=NeckConfig(in_dim=64, out_dims=(16, 32, 48, 64), img_size=CROP,
                        hide_dim=64,
                        two_way=TwoWayConfig(depth=3, embedding_dim=64,
                                             num_heads=4, mlp_dim=64)),
        head=HeadConfig(in_channels=(16, 32, 48, 64), channels=32,
                        d_model=64),
        num_max_points=6)


def train(model: VPUModel, epochs: int = EPOCHS, device="cuda",
          log: Callable[[str], None] = print) -> List[Dict[str, float]]:
    """`epochs` epochs of 4 steps at batch 16 on the synthetic train set,
    in place on `model`; every 8th epoch's means (loss, AdaptiveIoU), each
    also logged."""
    mcfg = model_config()
    sampler = MultiPointSampler(6, prob_gamma=0.8)
    ds = SyntheticTrainDataset(n_samples=64, hw=CROP, points_sampler=sampler,
                               epoch_len=64)
    loader = Loader(ds, batch_size=16, num_workers=2)
    tx = make_optimizer(model, "adam", lr=3e-4)
    tr = Trainer(model, TrainConfig(model=mcfg), tx, loader, log_every=1000,
                 device=device)
    curve = []
    for ep in range(epochs):
        means = tr.training(ep)
        if ep % 8 == 7:
            log(f"epoch {ep}: loss {means['loss']:.3f} "
                f"iou {means['AdaptiveIoU']:.3f}")
            curve.append({"epoch": ep, **means})
    return curve


def noc_row(model: VPUModel, int8: bool, samples: int = EVAL_SAMPLES,
            clicks: int = CLICKS, device="cuda"):
    """NoC@50 / NoC@80 of `model` (moved to `device`, quantized when
    `int8`) over the evaluation set: (noc, over, per-object IoU curves)."""
    eval_ds = SyntheticDataset(n_samples=samples, hw=(64, 64), seed=123)
    pcfg = PredictorConfig(model=model_config(), target_size=CROP,
                           min_crop_size=32)
    pred = Predictor(model, pcfg, device=device, int8=int8)
    ious, _ = evaluate_dataset(eval_ds, pred, max_iou_thr=0.80,
                               max_clicks=clicks)
    noc, _, over = compute_noc_metric(ious, [0.5, 0.8], max_clicks=clicks)
    return noc, over, ious


def run(epochs: int = EPOCHS, eval_samples: int = EVAL_SAMPLES,
        clicks: int = CLICKS, device="cuda", model: Optional[VPUModel] = None,
        log: Callable[[str], None] = print):
    """The demo: train (from `model`, default the seed-0 init, on the CPU
    until the Trainer moves it), then the random / trained / trained+int8
    NoC rows. Returns (the logged epochs, {row name: (noc, over, ious)})."""
    dev = resolve_device(device)
    if model is None:
        model = init_vpu(model_config(), torch.Generator().manual_seed(0),
                         "cpu")
    initial = copy.deepcopy(model)
    curve = train(model, epochs, dev, log)
    rows = {}
    for name, m, int8 in (("random", initial, False),
                          ("trained", model, False),
                          ("trained+int8", model, True)):
        noc, over, ious = rows[name] = noc_row(m, int8, eval_samples, clicks,
                                               dev)
        final = [round(float(a[-1]), 3) for a in ious]
        log(f"{name}: NoC@50 {noc[0]:.2f} NoC@80 {noc[1]:.2f} "
            f">={clicks}@80 {over[1]} final IoUs {final}")
    return curve, rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card; no fallback)")
    run(device=ap.parse_args(argv).device,
        log=lambda line: print(line, flush=True))


if __name__ == "__main__":
    main()
