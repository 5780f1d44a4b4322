"""The shipped training recipe: VPU ViT-B/448 on CocoLvis (C+L).

The port's copy of models/iSegNet/vpu_base448_cocolvis.py (itself the
reference's only published model script,
`models/iSegNet/vpu_base448_cocolvis.py:1-181`): same model shape, losses
(NFL a=0.5 g=2 + naive Dice + 2x P2CL BCE), augmentations, MultiPointSampler
(24 points, gamma 0.8, merge 0.15/2), 230 epochs x 30000 samples, batch 32,
Adam 5e-5, MultiStepLR [190, 210] x 0.1, iterloss weights [1, 2, 3],
checkpoints every 5 epochs then every epoch from 190.

    python -m pvpuformer_tpu_torch.train \
        pvpuformer_tpu_torch/recipes/iSegNet/vpu_base448_cocolvis.py

`build_trainer(cfg, trainset, valset)` builds the Trainer from any datasets;
`main(cfg)` builds the CocoLvis datasets (config.yml's LVIS_v1_PATH) and
runs. Under torch.distributed.run the ranks form the ("data", "model")
mesh of --model-parallel M (default 1), each data rank loads its rows of
the global batch (--batch-size), and the Trainer places the parameters on
the mesh by --param-mode (default here "replicated"; "tp" and "tp+fsdp"
split the ViT blocks over "model").
"""
from __future__ import annotations

from pathlib import Path

import torch

from pvpuformer_tpu_torch.data import (CocoLvisDataset, Loader,
                                       MultiPointSampler, transforms as T)
from pvpuformer_tpu_torch.engine.metrics import AdaptiveIoU
from pvpuformer_tpu_torch.engine.optimizer import (make_optimizer,
                                                   with_grad_accumulation)
from pvpuformer_tpu_torch.engine.train_step import TrainConfig
from pvpuformer_tpu_torch.engine.trainer import Trainer
from pvpuformer_tpu_torch.models.vpu import init_vpu, vpu_base_config
from pvpuformer_tpu_torch.parallel import make_mesh
from pvpuformer_tpu_torch.parallel.mesh import data_rank, data_size
from pvpuformer_tpu_torch.train import run
from pvpuformer_tpu_torch.utils.torch_ingest import (load_mae_pretrained,
                                                     load_vit_state)

MODEL_NAME = "vpu_base448_cocolvis"

CROP_SIZE = (448, 448)
NUM_MAX_POINTS = 24
EPOCH_LEN = 30000
VAL_EPOCH_LEN = 2000
NUM_EPOCHS = 230
MILESTONES = (190, 210)
BASE_LR = 5e-5


def init_model(cfg, make_config=vpu_base_config, mae_key="MAE_BASE"):
    """(model on the CPU, its config): seeded random weights, the backbone
    from the MAE checkpoint that config.yml names, when the file exists."""
    dtype = torch.bfloat16 if cfg.get("dtype", "bfloat16") == "bfloat16" \
        else torch.float32
    mcfg = make_config(crop=CROP_SIZE, upsample=cfg.get("upsample", "x1"),
                       dtype=dtype)
    model = init_vpu(mcfg, torch.Generator().manual_seed(0), "cpu")
    mae = (cfg.get("IMAGENET_PRETRAINED_MODELS") or {}).get(mae_key)
    if mae and Path(mae).exists():
        load_vit_state(model.backbone, load_mae_pretrained(mae, mcfg.backbone))
    return model, mcfg


def points_sampler() -> MultiPointSampler:
    return MultiPointSampler(NUM_MAX_POINTS, prob_gamma=0.80,
                             merge_objects_prob=0.15,
                             max_num_merged_objects=2)


def train_kwargs(sampler: MultiPointSampler) -> dict:
    """The training set's augmentation, object filter and sampling."""
    return dict(augmentator=T.train_augmentator(CROP_SIZE),
                min_object_area=1000, keep_background_prob=0.05,
                points_sampler=sampler, epoch_len=EPOCH_LEN)


def val_kwargs(sampler: MultiPointSampler) -> dict:
    return dict(augmentator=T.val_augmentator(CROP_SIZE), min_object_area=1000,
                points_sampler=sampler, epoch_len=VAL_EPOCH_LEN)


def loader_shard(mesh) -> dict:
    """This process's share of every global batch (`Loader` arguments): its
    data rank on the mesh (the ranks of one model group load the same
    rows)."""
    return dict(process_index=data_rank(mesh), process_count=data_size(mesh))


def build_trainer(cfg, trainset, valset, init=init_model,
                  layerwise_decay: bool = False,
                  param_mode: str = "replicated") -> Trainer:
    """The recipe's Trainer over `trainset` / `valset` (cfg: the experiment
    config with train.py's flags). `layerwise_decay` and `param_mode` are
    the defaults of --layerwise-decay and --param-mode."""
    model, mcfg = init(cfg)
    mesh = make_mesh(model_parallel=cfg.get("model_parallel", 1))
    batch_size = cfg.batch_size if cfg.get("batch_size", -1) > 0 else 32
    train_loader = Loader(trainset, batch_size,
                          num_workers=cfg.get("workers", 4),
                          **loader_shard(mesh))
    val_loader = Loader(valset, batch_size, shuffle=False,
                        num_workers=cfg.get("workers", 4),
                        **loader_shard(mesh))

    tcfg = TrainConfig(model=mcfg, max_num_next_clicks=3,
                       iterloss_weights=(1.0, 2.0, 3.0),
                       instance_loss_weight=1.0, instance_aux_loss_weight=1.0,
                       instance_aux3_loss_weight=2.0,
                       use_random_clicks=True, as_allmask=False)
    tx = make_optimizer(model, "adam", lr=BASE_LR, betas=(0.9, 0.999),
                        eps=1e-8, milestones=MILESTONES, gamma=0.1,
                        steps_per_epoch=len(train_loader),
                        layerwise_decay=cfg.get("layerwise_decay",
                                                layerwise_decay))
    tx = with_grad_accumulation(tx, cfg.get("accumulate_grad", 1))
    return Trainer(model, tcfg, tx, train_loader, val_loader,
                   checkpoint_dir=cfg.CHECKPOINTS_PATH,
                   checkpoint_interval=[(0, 5), (190, 1)],
                   metrics=[AdaptiveIoU()], tb_dir=str(cfg.LOGS_PATH),
                   device=cfg.get("device"),
                   mesh=mesh, param_mode=cfg.get("param_mode") or param_mode)


def main(cfg):
    sampler = points_sampler()
    trainset = CocoLvisDataset(cfg.LVIS_v1_PATH, split="train",
                               stuff_prob=0.30, **train_kwargs(sampler))
    valset = CocoLvisDataset(cfg.LVIS_v1_PATH, split="val",
                             **val_kwargs(sampler))
    run(cfg, build_trainer(cfg, trainset, valset), NUM_EPOCHS)
