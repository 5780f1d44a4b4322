"""VPU ViT-H/448 on CocoLvis — the BASELINE config-5 model at training time
(the port's copy of models/iSegNet/vpu_huge448_cocolvis.py).

The reference publishes only the ViT-B recipe
(`models/iSegNet/vpu_base448_cocolvis.py:1-181`); its backbone zoo ships the
ViT-H constructor (`isegm/model/modeling/models_vit.py:316-319`) with no
training script. This recipe follows the SimpleClick lineage for large
backbones (the acknowledged ancestry, reference `README.md:128`): the base
recipe's losses, sampler, augmentations, schedule and checkpoints, the
MAE_HUGE backbone, and layer-wise lr decay as the recipe's default
(BEiT 0.75^depth over 32 blocks; train.py's --layerwise-decay flag, absent,
reads as off, as with the JAX package's train.py) and FSDP parameter
sharding as the default --param-mode, as in the JAX recipe (with one
process and no process group every mode is one device's).
"""
from __future__ import annotations

from functools import partial

from pvpuformer_tpu_torch.data import CocoLvisDataset
from pvpuformer_tpu_torch.models.vpu import vpu_huge_config
from pvpuformer_tpu_torch.recipes.iSegNet import vpu_base448_cocolvis as base
from pvpuformer_tpu_torch.train import run

MODEL_NAME = "vpu_huge448_cocolvis"

init_model = partial(base.init_model, make_config=vpu_huge_config,
                     mae_key="MAE_HUGE")


def build_trainer(cfg, trainset, valset):
    return base.build_trainer(cfg, trainset, valset, init=init_model,
                              layerwise_decay=True, param_mode="fsdp")


def main(cfg):
    sampler = base.points_sampler()
    trainset = CocoLvisDataset(cfg.LVIS_v1_PATH, split="train",
                               stuff_prob=0.30, **base.train_kwargs(sampler))
    valset = CocoLvisDataset(cfg.LVIS_v1_PATH, split="val",
                             **base.val_kwargs(sampler))
    run(cfg, build_trainer(cfg, trainset, valset), base.NUM_EPOCHS)
