"""NoC evaluation CLI of the port (the JAX package's scripts/evaluate.py,
itself the reference's scripts/evaluate_vpumodel.py):

    python -m pvpuformer_tpu_torch.evaluate NoBRS --checkpoint ckpt.npz \
        --datasets GrabCut,Berkeley,DAVIS,SBD,PascalVOC \
        [--n-clicks 20] [--target-iou 0.95] [--thresh 0.49] [--batched B] \
        [--print-ious] [--save-ious] [--prompt-mode 0|1|2] [--int8] \
        [--device cpu]

    python -m torch.distributed.run --nproc-per-node D \
        -m pvpuformer_tpu_torch.evaluate --batched B --eval-mesh D ...

The mode is NoBRS, f-BRS-A / B / C, RGB-BRS or DistMap-BRS
(inference/brs.py); --int8 (NoBRS only) runs the int8 PTQ model.

Protocol constants follow evaluate_vpumodel.py: 20 clicks at most, target
IoU 0.95, threshold 0.49, flip TTA on, zoom-in target the model's crop
(672 for DAVIS, the position embedding resampled bicubically) with
skip_clicks=-1 (evaluate_vpumodel.py:54-58,87-90,132,187-204); a model
without a ViT backbone (the zoo families) zooms to 448 x 448 and keeps its
weights. A checkpoint in the JAX package's format carries its config, of
any registered family (models/registry.py);
--random-weights builds a seeded ViT-B / L / H for pipeline runs. It runs
on the card unless --device cpu is given. The table and the pickles are
those of the JAX CLI. --eval-mesh D shares each batch of B sessions
between the D ranks of a process group that torch.distributed.run starts
(NCCL on cuda:LOCAL_RANK, gloo with --device cpu; B must divide by D);
rank 0 prints and saves. Not ported yet: SAM and --vis-preds; each exits
with an error.
"""
from __future__ import annotations

import argparse
import dataclasses
import glob
import os
import pickle
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
DATASET_ZOOM = {"DAVIS": (672, 672)}           # evaluate_vpumodel.py:187-204
DATASET_PATH_KEYS = {
    "GrabCut": "GRABCUT_PATH", "Berkeley": "BERKELEY_PATH",
    "DAVIS": "DAVIS_PATH", "COCO_MVal": "COCO_MVAL_PATH",
    "PascalVOC": "PASCALVOC_PATH", "SBD": "SBD_EVAL_PATH",
    "SBD_Train": "SBD_EVAL_PATH", "BraTS": "BraTS_PATH",
    "ssTEM": "ssTEM_PATH", "OAIZIB": "OAIZIB_PATH",
    "HARD": "HARD_PATH", "ADE20K": "ADE20K_PATH",
}
EVAL_MODE = "cvpr"                 # the JAX CLI's default, in pickle names
MODES = ("NoBRS", "f-BRS-A", "f-BRS-B", "f-BRS-C", "RGB-BRS", "DistMap-BRS")


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("mode", nargs="?", default="NoBRS",
                   help=" / ".join(MODES) + " (SAM is not ported yet)")
    p.add_argument("--checkpoint", default=None,
                   help="a .npz checkpoint in the JAX package's format")
    p.add_argument("--random-weights", action="store_true",
                   help="seeded random weights (pipeline runs)")
    p.add_argument("--model-size", default="base",
                   choices=["base", "large", "huge"],
                   help="model for --random-weights: ViT-B / ViT-L / ViT-H")
    p.add_argument("--datasets", default="GrabCut,Berkeley,SBD,DAVIS,"
                                         "PascalVOC,COCO_MVal")
    p.add_argument("--n-clicks", type=int, default=20)
    p.add_argument("--target-iou", type=float, default=0.95)
    p.add_argument("--min-n-clicks", type=int, default=1)
    p.add_argument("--thresh", type=float, default=0.49)
    p.add_argument("--print-ious", action="store_true")
    p.add_argument("--save-ious", action="store_true")
    p.add_argument("--prompt-mode", type=int, default=0, choices=[0, 1, 2],
                   help="0 clicks / 1 +boxes / 2 +scribbles")
    p.add_argument("--batched", type=int, default=0, metavar="B",
                   help="evaluate B sessions per batch (NoBRS clicks only; "
                        "0 = one session at a time)")
    p.add_argument("--eval-mesh", type=int, default=0, metavar="D",
                   help="with --batched B: share each batch between the D "
                        "ranks of torch.distributed.run (B must divide by "
                        "D); 0 = one process")
    p.add_argument("--int8", action="store_true",
                   help="int8 PTQ of every linear (per-channel weights, "
                        "dynamic per-row activations); NoBRS only")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    p.add_argument("--logs-path", default="./experiments/evaluation_logs")
    p.add_argument("--config-path", default=None,
                   help="config.yml with dataset paths (default: repo root)")
    p.add_argument("--limit", type=int, default=0,
                   help="evaluate only the first N samples")
    p.add_argument("--shard", default=None, metavar="I/N",
                   help="evaluate shard I of N (one process each, with "
                        "--save-ious; --merge-shards reprints the table)")
    p.add_argument("--merge-shards", default=None, metavar="GLOB",
                   help="merge the IoU pickles matching GLOB and reprint the "
                        "per-dataset NoC tables; no model is loaded")
    not_ported = p.add_argument_group("not ported yet")
    for flag in ("--sam-checkpoint", "--sam-model-type"):
        not_ported.add_argument(flag, default=None)
    for flag in ("--sam-multimask", "--sam-feedback-mask", "--vis-preds"):
        not_ported.add_argument(flag, action="store_true")
    args = p.parse_args(argv)
    for name in ("sam_checkpoint", "sam_model_type", "sam_multimask",
                 "sam_feedback_mask", "vis_preds"):
        if getattr(args, name):
            p.error(f"--{name.replace('_', '-')} is not ported yet")
    nobrs = args.mode.lower() == "nobrs"
    if not nobrs and args.mode.lower() not in {m.lower() for m in MODES}:
        p.error(f"mode {args.mode} is not ported yet ({', '.join(MODES)} "
                f"are)")
    if args.int8 and not nobrs:
        p.error("--int8 is NoBRS only (BRS differentiates the forward; the "
                "int8 rounding has no useful gradient)")
    if args.batched > 0 and not nobrs:
        p.error("--batched runs NoBRS only")
    if args.eval_mesh:
        world = int(os.environ.get("WORLD_SIZE", 0))
        if args.batched <= 0 or args.batched % args.eval_mesh:
            p.error("--eval-mesh D needs --batched B with B divisible by D")
        if world != args.eval_mesh:
            p.error(f"--eval-mesh {args.eval_mesh} needs a process group of "
                    f"{args.eval_mesh} ranks: run under python -m "
                    f"torch.distributed.run --nproc-per-node "
                    f"{args.eval_mesh} (WORLD_SIZE is {world or 'unset'})")
    return args


def build_model(args):
    """(model on the CPU, its config in the chosen dtype)."""
    import torch
    from .models import registry
    from .models.vpu import (init_vpu, vpu_base_config, vpu_huge_config,
                             vpu_large_config)
    from .utils.serialization import load_checkpoint

    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    if args.checkpoint:
        flat, cfg, _, _ = load_checkpoint(args.checkpoint)
        mcfg = cfg.model if hasattr(cfg, "model") else cfg
        return registry.load(flat, mcfg), mcfg.replace(dtype=dtype)
    if not args.random_weights:
        raise SystemExit("--checkpoint or --random-weights required")
    make = {"base": vpu_base_config, "large": vpu_large_config,
            "huge": vpu_huge_config}[args.model_size]
    mcfg = make(dtype=dtype)
    return init_vpu(mcfg, torch.Generator().manual_seed(0), "cpu"), mcfg


def at_crop(model, mcfg, crop):
    """A copy of the model at a zoom-in crop (the caller's model is left as
    it is: `Predictor` moves and casts its model in place). At another crop
    than the model's, the position embedding's grid tokens are resampled
    bicubically (align_corners=False, in f64), as the reference does at
    evaluation (pos_embed.py:99-128); a model without a ViT backbone has
    no position embedding and is copied as it is."""
    import torch
    import torch.nn.functional as F
    from .models import registry
    sd = model.state_dict()
    if registry.crop_size(mcfg) not in (None, tuple(crop)):
        (gh, gw), bcfg = mcfg.backbone.grid_size, dataclasses.replace(
            mcfg.backbone, img_size=tuple(crop))
        pos = sd["backbone.pos_embed"]
        d = pos.shape[-1]
        grid = pos[:, 1:].double().reshape(1, gh, gw, d).permute(0, 3, 1, 2)
        grid = F.interpolate(grid, size=bcfg.grid_size, mode="bicubic",
                             align_corners=False)
        sd["backbone.pos_embed"] = torch.cat(
            [pos[:, :1],
             grid.permute(0, 2, 3, 1).reshape(1, -1, d).to(pos.dtype)], 1)
        mcfg = mcfg.replace(backbone=bcfg)
    out = registry.model_for(mcfg)(mcfg)
    out.load_state_dict(sd)
    return out, mcfg


def merge_shards(pattern: str) -> None:
    """--merge-shards: the per-shard IoU pickles -> the full-dataset NoC
    tables. SPC comes from the summed clicks and wall clock; the Time column
    shows the longest shard (the shards ran at the same time)."""
    from .inference.evaluation import (compute_noc_metric, get_results_table,
                                       get_time_metrics, merge_shard_pickles)
    paths = sorted(glob.glob(pattern))
    if not paths:
        raise SystemExit(f"--merge-shards: no pickles match {pattern!r}")
    print(f"merging {len(paths)} shard pickle(s):")
    for p in paths:
        print(f"  {p}")
    for (dataset, mode), m in sorted(merge_shard_pickles(paths).items()):
        n_clicks = m["n_clicks"] or 20
        mean_spc, _ = get_time_metrics(m["all_ious"], m["elapsed"])
        noc, _, over_max = compute_noc_metric(
            m["all_ious"], iou_thrs=[0.8, 0.85, 0.9, 0.95],
            max_clicks=n_clicks)
        header, row = get_results_table(
            noc, over_max, mode, dataset, mean_spc, m["elapsed_max"],
            n_clicks)
        print(f"\n{dataset}: {len(m['all_ious'])} instances from "
              f"{m['shards']} shard(s)")
        print(header)
        print(row)


class _Subset:
    """The samples `ids` of a dataset."""

    def __init__(self, dataset, ids):
        self.dataset, self.ids = dataset, list(ids)
        self.name = getattr(dataset, "name", type(dataset).__name__)

    def __len__(self):
        return len(self.ids)

    def get_sample(self, i):
        return self.dataset.get_sample(self.ids[i])


def main(argv=None) -> None:
    args = parse_args(argv)
    if args.merge_shards:
        merge_shards(args.merge_shards)
        return
    from .nn import resolve_device
    from .parallel import dist
    from .parallel.mesh import make_mesh

    mesh = None
    if args.eval_mesh:
        device = dist.init(args.device)
        mesh = make_mesh(args.eval_mesh)
    else:
        device = resolve_device(args.device)
    try:
        _evaluate(args, device, mesh)
    finally:
        if mesh is not None:
            dist.shutdown()


def _evaluate(args, device, mesh) -> None:
    """Every dataset of --datasets: its NoC table (and pickles), printed
    and written by rank 0 alone under --eval-mesh."""
    from .inference.batched import BatchedEvaluator
    from .inference.datasets import get_dataset
    from .inference.evaluation import (compute_noc_metric, evaluate_dataset,
                                       get_results_table, get_time_metrics,
                                       mean_iou_per_click)
    from .inference.brs import get_predictor
    from .inference.predictor import PredictorConfig
    from .models import registry
    from .parallel import dist
    from .utils.exp import load_config_file

    master = dist.is_master()
    model, mcfg = build_model(args)
    logs_dir = Path(args.logs_path)
    logs_dir.mkdir(parents=True, exist_ok=True)

    for name in (n.strip() for n in args.datasets.split(",")):
        if name == "Synthetic":
            dataset = get_dataset("Synthetic")
        else:
            cfg_path = Path(args.config_path or ROOT / "config.yml")
            paths = load_config_file(cfg_path) if cfg_path.exists() else {}
            key = DATASET_PATH_KEYS.get(name)
            path = paths.get(key) if key else None
            if not path or not Path(path).exists():
                print(f"[skip] {name}: dataset path not found "
                      f"({key}={path}) — set it in config.yml")
                continue
            dataset = get_dataset(name, path)
        if args.limit:
            dataset = _Subset(dataset, range(min(args.limit, len(dataset))))
        if args.shard:
            si, sn = (int(v) for v in args.shard.split("/"))
            dataset = _Subset(dataset, range(si, len(dataset), sn))

        # a ViT model zooms to its crop; the size-agnostic zoo to 448 x 448
        default_crop = registry.crop_size(mcfg) or (448, 448)
        crop = DATASET_ZOOM.get(name, default_crop)
        ds_model, ds_mcfg = at_crop(model, mcfg, crop)
        pcfg = PredictorConfig(model=ds_mcfg, target_size=crop,
                               with_flip=True, prob_thresh=args.thresh,
                               skip_clicks=-1, prompt_mode=args.prompt_mode)
        if args.batched > 0:
            bev = BatchedEvaluator(ds_model, pcfg, batch_size=args.batched,
                                   device=device, int8=args.int8, mesh=mesh)
            all_ious, elapsed, stats = bev.evaluate(
                dataset, max_clicks=args.n_clicks,
                max_iou_thr=args.target_iou, min_clicks=args.min_n_clicks)
            if master:
                print(f"throughput: {stats['objects_per_sec']:.3f} obj/s, "
                      f"{stats['clicks_per_sec']:.2f} clicks/s")
        else:
            predictor = get_predictor(ds_model, pcfg, brs_mode=args.mode,
                                      int8=args.int8, device=device)
            all_ious, elapsed = evaluate_dataset(
                dataset, predictor,
                max_iou_thr=args.target_iou, pred_thr=args.thresh,
                min_clicks=args.min_n_clicks, max_clicks=args.n_clicks,
                progress=True)

        if not master:
            continue
        mean_spc, mean_spi = get_time_metrics(all_ious, elapsed)
        noc, _, over_max = compute_noc_metric(
            all_ious, iou_thrs=[0.8, 0.85, 0.9, 0.95],
            max_clicks=args.n_clicks)
        header, row = get_results_table(noc, over_max, args.mode, name,
                                        mean_spc, elapsed, args.n_clicks)
        print(header)
        print(row)
        print(f"SPI: {mean_spi:.3f}s per instance")
        if args.print_ious:
            miou = mean_iou_per_click(all_ious, max_clicks=args.n_clicks)
            print("mIoU@k:", np.array2string(miou, precision=4))
        if args.save_ious:
            shard_tag = (f"_s{args.shard.replace('/', 'of')}"
                         if args.shard else "")
            out = logs_dir / (f"{name}_{EVAL_MODE}_{args.mode}"
                              f"_{args.n_clicks}{shard_tag}.pickle")
            with open(out, "wb") as f:
                pickle.dump({"all_ious": all_ious, "dataset": name,
                             "mode": args.mode, "elapsed": elapsed,
                             "n_clicks": args.n_clicks}, f)
            print("saved IoU curves to", out)


if __name__ == "__main__":
    main()
