"""Training entry point of the port — config-as-code recipes
(the JAX package's train.py, itself the reference's `train.py:9-106`):

    python -m pvpuformer_tpu_torch.train \
        pvpuformer_tpu_torch/recipes/iSegNet/vpu_base448_cocolvis.py \
        --batch-size 32 --exp-name run1 [--resume-exp 003] [--debug] \
        [--device cpu] [--param-mode replicated|tp|fsdp|tp+fsdp]
        [--model-parallel M]

    python -m torch.distributed.run --nproc-per-node 8 \
        -m pvpuformer_tpu_torch.train <recipe> --param-mode fsdp

    python -m torch.distributed.run --nproc-per-node 4 \
        -m pvpuformer_tpu_torch.train <recipe> --model-parallel 2 \
        --param-mode tp+fsdp

The recipe defines MODEL_NAME, init_model(cfg) and main(cfg); the model,
data and schedule live there. Paths come from the config.yml cascade
(utils/exp.py); the experiment goes to
<EXPS_PATH>/<recipe dir>/<recipe>/NNN[_name]/ with checkpoints/, vis/, logs/
and a copy of the recipe. It trains on the card unless --device cpu is
given (--platform in the JAX CLI).

Under torch.distributed.run each process is one rank: the process group
starts first (parallel/dist.init: NCCL on cuda:LOCAL_RANK, gloo with
--device cpu), rank 0 makes the experiment and the others join it, and
--batch-size is the global batch. The ranks form the ("data", "model")
mesh of shape (W / M, M), M = --model-parallel (it must divide the number
of ranks W); each data rank loads its rows, and the M ranks of one model
group load the same ones. --param-mode places the parameters
("replicated": full copies, one gradient all-reduce per step; "fsdp":
FSDP2 shards over "data"; "tp": the ViT blocks split over "model",
Megatron-style; "tp+fsdp": both; default: the recipe's).
"""
from __future__ import annotations

import argparse
import os
from pathlib import Path

import torch.distributed as tdist

from .parallel import dist
from .parallel.mesh import MODES
from .utils.exp import init_experiment, load_module

ROOT = Path(__file__).resolve().parents[1]


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("model_path", help="config-as-code recipe")
    p.add_argument("--batch-size", type=int, default=-1)
    p.add_argument("--epochs", type=int, default=-1)
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--exp-name", default="")
    p.add_argument("--resume-exp", default=None,
                   help="experiment prefix to resume (e.g. 003): its "
                        "checkpoint <resume-prefix>*.npz is loaded")
    p.add_argument("--resume-prefix", default="last_checkpoint",
                   help="checkpoint file prefix inside the experiment")
    p.add_argument("--start-epoch", type=int, default=-1,
                   help="epoch to continue from (default: the checkpoint's "
                        "next, or 0)")
    p.add_argument("--weights", default=None,
                   help="initial weights checkpoint (.npz)")
    p.add_argument("--layerwise-decay", action="store_true")
    p.add_argument("--upsample", default="x1", choices=["x1", "x2", "x4"])
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--model-parallel", type=int, default=1,
                   help="tensor-parallel ways M: the mesh's \"model\" axis "
                        "(it must divide the number of ranks)")
    p.add_argument("--param-mode", default=None, choices=MODES,
                   help="parameter placement over the mesh (default: the "
                        "recipe's): replicated, tp (ViT blocks split over "
                        "\"model\"), fsdp (sharded over \"data\"), tp+fsdp")
    p.add_argument("--accumulate-grad", type=int, default=1,
                   help="apply the optimizer every K steps, averaging "
                        "gradients in between (reference train.py "
                        "--accumulate-grad / trainer.py:188-202)")
    p.add_argument("--debug", action="store_true", help="1 epoch smoke run")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; cuda:LOCAL_RANK "
                        "under torch.distributed.run)")
    return p.parse_args(argv)


def run(cfg, trainer, num_epochs: int) -> None:
    """What train.py's flags ask of a recipe's Trainer, then train:
    --weights or --resume-exp's checkpoint, --start-epoch, --epochs (else
    `num_epochs`) and --debug (one epoch)."""
    if cfg.get("resume_exp"):
        found = sorted(Path(cfg.CHECKPOINTS_PATH).glob(
            f"{cfg.get('resume_prefix', 'last_checkpoint')}*.npz"))
        if len(found) != 1:
            raise FileNotFoundError(
                f"--resume-exp needs one checkpoint {cfg.resume_prefix}*.npz "
                f"under {cfg.CHECKPOINTS_PATH}, found {len(found)}")
        trainer.resume(found[0])
    elif cfg.get("weights"):
        trainer.resume(cfg.weights)
    epochs = cfg.epochs if cfg.get("epochs", -1) > 0 else num_epochs
    start = cfg.start_epoch if cfg.get("start_epoch", -1) >= 0 else None
    trainer.run(num_epochs=1 if cfg.get("debug") else epochs,
                start_epoch=start, validation=False)


def experiment(args):
    """The experiment config: rank 0 makes it (or finds --resume-exp's),
    the other ranks of a process group join the one rank 0 names."""
    name = [None]
    if dist.is_master():
        cfg = init_experiment(args.model_path, exp_suffix=args.exp_name,
                              resume_exp=args.resume_exp, repo_root=ROOT)
        name = [cfg.EXP_PATH.name]
    if dist.get_world_size() > 1:
        tdist.broadcast_object_list(name, src=0)
    if dist.is_master():
        return cfg
    return init_experiment(args.model_path, resume_exp=name[0],
                           repo_root=ROOT, rank=dist.get_rank())


def main(argv=None) -> None:
    args = parse_args(argv)
    launched = "WORLD_SIZE" in os.environ       # torch.distributed.run
    if launched:
        args.device = str(dist.init(args.device))
    try:
        cfg = experiment(args)
        for k, v in vars(args).items():
            setattr(cfg, k, v)
        load_module(args.model_path).main(cfg)
    finally:
        if launched:
            dist.shutdown()


if __name__ == "__main__":
    main()
