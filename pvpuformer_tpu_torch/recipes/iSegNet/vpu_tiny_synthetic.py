"""Tiny synthetic smoke recipe (the port's copy of
models/iSegNet/vpu_tiny_synthetic.py): the full training stack (data
pipeline, iterloss rounds, checkpointing) in minutes on the CPU or the card.

    python -m pvpuformer_tpu_torch.train \
        pvpuformer_tpu_torch/recipes/iSegNet/vpu_tiny_synthetic.py --debug
"""
from __future__ import annotations

import torch

from pvpuformer_tpu_torch.data import (Loader, MultiPointSampler,
                                       SyntheticTrainDataset, transforms as T)
from pvpuformer_tpu_torch.engine.metrics import AdaptiveIoU
from pvpuformer_tpu_torch.engine.optimizer import (make_optimizer,
                                                   with_grad_accumulation)
from pvpuformer_tpu_torch.engine.train_step import TrainConfig
from pvpuformer_tpu_torch.engine.trainer import Trainer
from pvpuformer_tpu_torch.models.fpn import NeckConfig
from pvpuformer_tpu_torch.models.seg_head import HeadConfig
from pvpuformer_tpu_torch.models.two_way import TwoWayConfig
from pvpuformer_tpu_torch.models.vit import ViTConfig
from pvpuformer_tpu_torch.models.vpu import VPUConfig, init_vpu
from pvpuformer_tpu_torch.train import run

MODEL_NAME = "vpu_tiny_synthetic"
CROP = (64, 64)


def init_model(cfg):
    mcfg = VPUConfig(
        backbone=ViTConfig(img_size=CROP, patch_size=(16, 16), embed_dim=64,
                           depth=4, num_heads=2),
        neck=NeckConfig(in_dim=64, out_dims=(16, 32, 48, 64), img_size=CROP,
                        hide_dim=64,
                        two_way=TwoWayConfig(depth=3, embedding_dim=64,
                                             num_heads=4, mlp_dim=64)),
        head=HeadConfig(in_channels=(16, 32, 48, 64), channels=32, d_model=64),
        num_max_points=6,
    )
    return init_vpu(mcfg, torch.Generator().manual_seed(0), "cpu"), mcfg


def make_trainset() -> SyntheticTrainDataset:
    sampler = MultiPointSampler(6, prob_gamma=0.8, merge_objects_prob=0.15,
                                max_num_merged_objects=2)
    return SyntheticTrainDataset(n_samples=32, hw=CROP,
                                 points_sampler=sampler,
                                 augmentator=T.train_augmentator(CROP),
                                 epoch_len=32)


def build_trainer(cfg, trainset, valset=None) -> Trainer:
    model, mcfg = init_model(cfg)
    batch_size = cfg.batch_size if cfg.get("batch_size", -1) > 0 else 8
    loader = Loader(trainset, batch_size, num_workers=cfg.get("workers", 2))
    tcfg = TrainConfig(model=mcfg, max_num_next_clicks=3)
    tx = make_optimizer(model, "adam", lr=1e-3, milestones=(1,), gamma=0.5,
                        steps_per_epoch=len(loader))
    tx = with_grad_accumulation(tx, cfg.get("accumulate_grad", 1))
    return Trainer(model, tcfg, tx, loader,
                   checkpoint_dir=cfg.CHECKPOINTS_PATH,
                   checkpoint_interval=1, metrics=[AdaptiveIoU()],
                   device=cfg.get("device"))


def main(cfg):
    run(cfg, build_trainer(cfg, make_trainset()), 2)
