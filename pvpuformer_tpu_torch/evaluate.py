"""NoC evaluation CLI of the port (the JAX package's scripts/evaluate.py,
itself the reference's scripts/evaluate_vpumodel.py):

    python -m pvpuformer_tpu_torch.evaluate NoBRS --checkpoint ckpt.npz \
        --datasets GrabCut,Berkeley,DAVIS,SBD,PascalVOC \
        [--n-clicks 20] [--target-iou 0.95] [--thresh 0.49] [--batched B] \
        [--cf-n N --cf-click K --acf] [--clicks-limit K] \
        [--eval-ritm | --eval-mode fixedH[,W]] [--iou-analysis] \
        [--print-ious] [--save-ious] [--vis-preds] [--profile] \
        [--prompt-mode 0|1|2] [--int8] [--parity] [--device cpu]

    python -m pvpuformer_tpu_torch.evaluate SAM --sam-checkpoint sam.pth ...

    python -m torch.distributed.run --nproc-per-node D \
        -m pvpuformer_tpu_torch.evaluate --batched B --eval-mesh D ...

The mode is NoBRS, f-BRS-A / B / C, RGB-BRS, DistMap-BRS
(inference/brs.py) or SAM (segment_anything's predictor in the same
clicker loop, inference/sam_compat.py; no model is built); --int8 (NoBRS
only) runs the int8 PTQ model.

Protocol constants follow evaluate_vpumodel.py: 20 clicks at most, target
IoU 0.95 (1.01 under --iou-analysis, which also writes the IoU pickle),
threshold 0.49, flip TTA on, zoom-in target the model's crop (672 for
DAVIS, the position embedding resampled bicubically) with skip_clicks=-1
(evaluate_vpumodel.py:54-58,87-90,132,187-204); a model without a ViT
backbone (the zoo families) zooms to 448 x 448 and keeps its weights.
--eval-mode fixedH[,W] fixes the zoom-in target; --eval-ritm takes RITM's
protocol, 400 (600 for DAVIS) with skip_clicks=1; a ViT refuses a crop
that is not a multiple of its patch. --cf-n / --cf-click / --acf run the
CFR cascade, --clicks-limit feeds the network only the first K clicks (-1:
--n-clicks). A checkpoint in the JAX package's format carries its config,
of any registered family (models/registry.py); --exp-path rel/exp[:prefix]
takes the newest checkpoints/prefix*.npz of the newest experiment
<EXPS_PATH>/rel/exp*; --random-weights builds a seeded ViT-B / L / H for
pipeline runs. It runs on the card unless --device cpu is given; --parity
is --dtype float32 with full-f32 products. The table and the pickles are
those of the JAX CLI. --vis-preds writes one PNG per sample (its panel
rows stacked over the clicks) under <logs-path>/vis/<dataset>/ and runs
one session at a time; --profile times every click (percentiles, a
histogram, the memory counters) on the sequential path, and prints the
port's round tracing (utils/profiling.py: spans, host reads a round, and
on the card the device ms a replayed round by model stage) on either
path. --eval-mesh D
shares each batch of B sessions between the D ranks of a process group
that torch.distributed.run starts (NCCL on cuda:LOCAL_RANK, gloo with
--device cpu; B must divide by D); rank 0 prints and saves.
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
MODES = ("NoBRS", "f-BRS-A", "f-BRS-B", "f-BRS-C", "RGB-BRS", "DistMap-BRS",
         "SAM")


def build_parser() -> argparse.ArgumentParser:
    """Every option of scripts/evaluate.py with its default and type, but
    --platform, which --device replaces."""
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("mode", nargs="?", default="NoBRS",
                   help=" / ".join(MODES))
    p.add_argument("--checkpoint", default=None,
                   help="a .npz checkpoint in the JAX package's format")
    p.add_argument("--sam-checkpoint", default=None,
                   help="SAM mode: segment_anything checkpoint .pth (variant "
                        "from the file name, evaluate_sammodel.py:134-139)")
    p.add_argument("--sam-model-type", default=None,
                   choices=[None, "vit_b", "vit_l", "vit_h"])
    p.add_argument("--sam-multimask", action="store_true",
                   help="multimask_output=True, the best-scored mask")
    p.add_argument("--sam-feedback-mask", action="store_true",
                   help="feed the previous low-res logits back as mask_input "
                        "(predictors/sam_base.py)")
    p.add_argument("--random-weights", action="store_true",
                   help="seeded random weights (pipeline runs)")
    p.add_argument("--model-size", default="base",
                   choices=["base", "large", "huge"],
                   help="model for --random-weights: ViT-B / ViT-L / ViT-H")
    p.add_argument("--exp-path", default=None,
                   help="the checkpoint from the experiments tree: "
                        "'rel/exp[:prefix]' takes the newest "
                        "checkpoints/prefix*.npz of the newest "
                        "<EXPS_PATH>/rel/exp* (evaluate_vpumodel.py:211-232)")
    p.add_argument("--cf-n", type=int, default=0,
                   help="CFR cascade: N more forwards a click "
                        "(evaluate_vpumodel.py:162)")
    p.add_argument("--cf-click", type=int, default=1,
                   help="the cascade refines the first K clicks only")
    p.add_argument("--acf", action="store_true",
                   help="adaptive cascade: stop once fewer than 21 pixels "
                        "change")
    p.add_argument("--clicks-limit", type=int, default=None,
                   help="feed the network only the first K clicks (-1: "
                        "--n-clicks; evaluate_vpumodel.py:167-170)")
    p.add_argument("--eval-ritm", action="store_true",
                   help="RITM protocol: zoom-in target 400 (600 for DAVIS), "
                        "skip_clicks=1 (evaluate_vpumodel.py:173-185)")
    p.add_argument("--model-name", default=None,
                   help="label in the results table's header")
    p.add_argument("--datasets", default="GrabCut,Berkeley,SBD,DAVIS,"
                                         "PascalVOC,COCO_MVal")
    p.add_argument("--n-clicks", type=int, default=20)
    p.add_argument("--target-iou", type=float, default=0.95)
    p.add_argument("--min-n-clicks", type=int, default=1)
    p.add_argument("--thresh", type=float, default=0.49)
    p.add_argument("--iou-analysis", action="store_true",
                   help="target IoU 1.01 (every session runs --n-clicks "
                        "clicks); the IoU pickle is written")
    p.add_argument("--print-ious", action="store_true")
    p.add_argument("--save-ious", action="store_true")
    p.add_argument("--vis-preds", action="store_true",
                   help="one PNG per sample under <logs-path>/vis/<dataset>/ "
                        "(sessions one at a time)")
    p.add_argument("--prompt-mode", type=int, default=0, choices=[0, 1, 2],
                   help="0 clicks / 1 +boxes / 2 +scribbles")
    p.add_argument("--eval-mode", default="cvpr",
                   help="cvpr, or fixedH[,W]: the zoom-in target")
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
    p.add_argument("--parity", action="store_true",
                   help="--dtype float32 with full-f32 products (no TF32)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    p.add_argument("--logs-path", default="./experiments/evaluation_logs")
    p.add_argument("--config-path", default=None,
                   help="config.yml with dataset paths (default: repo root)")
    p.add_argument("--limit", type=int, default=0,
                   help="evaluate only the first N samples")
    p.add_argument("--profile", action="store_true",
                   help="per-click latency percentiles and histogram, and "
                        "the device memory counters (sessions one at a "
                        "time, every click timed); the round tracing's "
                        "report")
    p.add_argument("--shard", default=None, metavar="I/N",
                   help="evaluate shard I of N (one process each, with "
                        "--save-ious; --merge-shards reprints the table)")
    p.add_argument("--merge-shards", default=None, metavar="GLOB",
                   help="merge the IoU pickles matching GLOB and reprint the "
                        "per-dataset NoC tables; no model is loaded")
    return p


def parse_args(argv=None):
    p = build_parser()
    args = p.parse_args(argv)
    nobrs = args.mode.lower() == "nobrs"
    if args.mode.lower() not in {m.lower() for m in MODES}:
        p.error(f"mode {args.mode} is not one of {', '.join(MODES)}")
    if args.int8 and not nobrs:
        p.error("--int8 is NoBRS only (BRS differentiates the forward; the "
                "int8 rounding has no useful gradient)")
    if args.batched > 0 and not nobrs:
        p.error("--batched runs NoBRS only")
    if args.eval_mesh:
        world = int(os.environ.get("WORLD_SIZE", 0))
        if args.batched <= 0 or args.batched % args.eval_mesh:
            p.error("--eval-mesh D needs --batched B with B divisible by D")
        if args.vis_preds:
            p.error("--vis-preds runs one session at a time: it takes no "
                    "--eval-mesh")
        if world != args.eval_mesh:
            p.error(f"--eval-mesh {args.eval_mesh} needs a process group of "
                    f"{args.eval_mesh} ranks: run under python -m "
                    f"torch.distributed.run --nproc-per-node "
                    f"{args.eval_mesh} (WORLD_SIZE is {world or 'unset'})")
    return args


def resolve_exp_checkpoint(args) -> str:
    """--exp-path 'rel/exp[:prefix]' -> the newest
    <EXPS_PATH>/rel/exp*/checkpoints/prefix*.npz, as
    get_checkpoints_list_and_logs_path picks it
    (evaluate_vpumodel.py:211-232); EXPS_PATH from config.yml."""
    from .utils.exp import load_config_file
    cfg_path = Path(args.config_path or ROOT / "config.yml")
    paths = load_config_file(cfg_path) if cfg_path.exists() else {}
    exps = Path(paths.get("EXPS_PATH", ROOT / "experiments"))
    rel, _, prefix = args.exp_path.partition(":")
    target = exps / rel
    candidates = sorted(target.parent.glob(target.name + "*"))
    if not candidates:
        raise SystemExit(f"--exp-path: no experiment matches {target}*")
    ckpts = sorted((candidates[-1] / "checkpoints").glob(
        (prefix or "") + "*.npz"), reverse=True)
    if not ckpts:
        raise SystemExit(f"--exp-path: no checkpoints under "
                         f"{candidates[-1]}/checkpoints")
    return str(ckpts[0])


def build_model(args):
    """(model on the CPU, its config in the chosen dtype)."""
    import torch
    from .models import registry
    from .models.vpu import (init_vpu, vpu_base_config, vpu_huge_config,
                             vpu_large_config)
    from .utils.serialization import load_checkpoint

    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    if args.exp_path and not args.checkpoint:
        args.checkpoint = resolve_exp_checkpoint(args)
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
    no position embedding and is copied as it is. A ViT refuses a crop that
    is not a multiple of its patch (JAX's patch embedding cannot reshape
    it either, and raises at the first forward)."""
    import torch
    import torch.nn.functional as F
    from .models import registry
    sd = model.state_dict()
    if registry.crop_size(mcfg) not in (None, tuple(crop)):
        ph, pw = mcfg.backbone.patch_size
        if crop[0] % ph or crop[1] % pw:
            raise ValueError(
                f"zoom-in crop {tuple(crop)} is not a multiple of the ViT "
                f"patch {(ph, pw)}: the patch embedding cannot tile it")
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


def merge_shards(pattern: str, model_name=None) -> None:
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
            n_clicks, model_name=model_name)
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


def protocol_crop(args, name: str, default_crop):
    """(zoom-in crop, skip_clicks) of dataset `name`
    (scripts/evaluate.py:300-324): --eval-mode fixedH[,W] fixes the crop;
    --eval-ritm takes RITM's 400 (600 for DAVIS) with skip_clicks=1
    (evaluate_vpumodel.py:173-185, zoom_in.py:12); otherwise the
    per-dataset zoom (672 for DAVIS) or `default_crop`, skip_clicks=-1."""
    if args.eval_mode.startswith("fixed"):
        sizes = args.eval_mode.split(",")
        ch = int(sizes[0][5:])
        return (ch, int(sizes[1]) if len(sizes) == 2 else ch), -1
    if args.eval_ritm:
        return ((600, 600) if name == "DAVIS" else (400, 400)), 1
    return DATASET_ZOOM.get(name, default_crop), -1


def main(argv=None) -> None:
    args = parse_args(argv)
    if args.merge_shards:
        merge_shards(args.merge_shards, model_name=args.model_name)
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
    import torch
    from .inference.batched import BatchedEvaluator
    from .inference.brs import get_predictor
    from .inference.datasets import get_dataset
    from .inference.evaluation import (compute_noc_metric, evaluate_dataset,
                                       get_results_table, get_time_metrics,
                                       mean_iou_per_click)
    from .inference.predictor import PredictorConfig
    from .models import registry
    from .parallel import dist
    from .utils import profiling
    from .utils.exp import load_config_file

    if args.parity:
        # f32 activations, f32 products in full f32 (torch's default; set
        # here as JAX's --parity sets "highest"); f32 convs on the card run
        # with cuDNN's TF32 off (nn.resolve_device)
        args.dtype = "float32"
        torch.set_float32_matmul_precision("highest")
    master = dist.is_master()
    sam_mode = args.mode.upper() == "SAM"
    model, mcfg = (None, None) if sam_mode else build_model(args)
    target_iou = 1.01 if args.iou_analysis else args.target_iou
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

        if not sam_mode:
            # a ViT model zooms to its crop; the size-agnostic zoo to 448
            crop, skip_clicks = protocol_crop(
                args, name, registry.crop_size(mcfg) or (448, 448))
            clicks_limit = (args.n_clicks if args.clicks_limit == -1
                            else args.clicks_limit)
            ds_model, ds_mcfg = at_crop(model, mcfg, crop)
            pcfg = PredictorConfig(
                model=ds_mcfg, target_size=crop, with_flip=True,
                prob_thresh=args.thresh, skip_clicks=skip_clicks,
                prompt_mode=args.prompt_mode, cascade_step=args.cf_n + 1,
                cascade_adaptive=args.acf, cascade_clicks=args.cf_click,
                net_clicks_limit=clicks_limit)
        vis = (VisDump(logs_dir / "vis" / name, prompt_mode=args.prompt_mode,
                       prob_thresh=args.thresh) if args.vis_preds else None)
        if args.profile:
            profiling.reset()
        if args.batched > 0 and vis is None:
            bev = BatchedEvaluator(ds_model, pcfg, batch_size=args.batched,
                                   device=device, int8=args.int8, mesh=mesh)
            all_ious, elapsed, stats = bev.evaluate(
                dataset, max_clicks=args.n_clicks, max_iou_thr=target_iou,
                min_clicks=args.min_n_clicks)
            if master:
                print(f"throughput: {stats['objects_per_sec']:.3f} obj/s, "
                      f"{stats['clicks_per_sec']:.2f} clicks/s")
                if args.profile:
                    print("\n".join(profiling.report()))
        else:
            if sam_mode:
                from .inference.sam_compat import SamCompatPredictor
                predictor = SamCompatPredictor(
                    checkpoint=args.sam_checkpoint,
                    model_type=args.sam_model_type,
                    multimask=args.sam_multimask,
                    feedback_mask=args.sam_feedback_mask,
                    device=device if device.type == "cuda" else None)
            else:
                predictor = get_predictor(ds_model, pcfg, brs_mode=args.mode,
                                          int8=args.int8, device=device)
            callback, recorder = vis, None
            if args.profile:
                recorder = profiling.LatencyRecorder()
                next_click = predictor.next_click

                def timed_next_click():
                    with recorder.measure():
                        return next_click()
                predictor.next_click = timed_next_click
                # the per-click path, so that every click is timed
                callback = callback or (lambda *a: None)
            all_ious, elapsed = evaluate_dataset(
                dataset, predictor, max_iou_thr=target_iou,
                pred_thr=args.thresh, min_clicks=args.min_n_clicks,
                max_clicks=args.n_clicks, callback=callback, progress=True)
            if vis is not None:
                vis.close()
            if recorder is not None and recorder.samples_ms:
                print("per-click latency:", recorder.summary())
                counts, edges = recorder.histogram(bins=10)
                for c, lo, hi in zip(counts, edges[:-1], edges[1:]):
                    print(f"  {lo:8.2f}-{hi:8.2f} ms: {'#' * int(c)}")
                print("memory:", profiling.memory_stats(device))
                print("\n".join(profiling.report()))

        if not master:
            continue
        mean_spc, mean_spi = get_time_metrics(all_ious, elapsed)
        noc, _, over_max = compute_noc_metric(
            all_ious, iou_thrs=[0.8, 0.85, 0.9, 0.95],
            max_clicks=args.n_clicks)
        header, row = get_results_table(noc, over_max, args.mode, name,
                                        mean_spc, elapsed, args.n_clicks,
                                        model_name=args.model_name)
        print(header)
        print(row)
        print(f"SPI: {mean_spi:.3f}s per instance")
        if args.print_ious:
            miou = mean_iou_per_click(all_ious, max_clicks=args.n_clicks)
            print("mIoU@k:", np.array2string(miou, precision=4))
        if args.save_ious or args.iou_analysis:
            shard_tag = (f"_s{args.shard.replace('/', 'of')}"
                         if args.shard else "")
            out = logs_dir / (f"{name}_{args.eval_mode}_{args.mode}"
                              f"_{args.n_clicks}{shard_tag}.pickle")
            with open(out, "wb") as f:
                pickle.dump({"all_ious": all_ious, "dataset": name,
                             "mode": args.mode, "elapsed": elapsed,
                             "n_clicks": args.n_clicks}, f)
            print("saved IoU curves to", out)


def display_box(gt_mask, probs, prob_thresh):
    """The round's box prompt recomputed on the host for display
    (scripts/evaluate.py:_display_box): the bbox of the dominant FN / FP
    region as prompt_mode=1 draws it without jitter (cal_box semantics,
    trainer.py:1061-1131), (cx, cy, w, h, 0); None without an error."""
    from scipy import ndimage
    gtb = gt_mask > 0.5
    pred = probs > prob_thresh
    fn = gtb & ~pred
    fp = ~gtb & pred
    err = fn if fn.sum() > fp.sum() else fp
    if not err.any():
        return None
    lab, _ = ndimage.label(err, structure=np.ones((3, 3)))
    sizes = np.bincount(lab.ravel())
    sizes[0] = 0
    keep = (lab == sizes.argmax()) | (sizes[lab] > 0.1 * err.sum())
    ys, xs = np.nonzero(err & keep)
    y0, y1, x0, x1 = ys.min(), ys.max(), xs.min(), xs.max()
    return np.array([(x0 + x1) // 2, (y0 + y1) // 2, x1 - x0, y1 - y0, 0])


class VisDump:
    """--vis-preds (scripts/evaluate.py:_make_vis_callback, the reference's
    evaluate_vpumodel.py:326-427): the evaluation loop's callback. Each
    click adds its 2 x 3 panel row (`utils/vis.eval_panel`: gt blends, pred
    blend with the round's prompts, FN / FP map, prob map, pred mask with
    IoU / NoC) under the session's earlier rows; a session's stack is
    written as <sample id>.png (`utils/vis.write_png`) when the next
    session starts and at `close()`, so a sample's file holds its last
    object's session, as JAX's JPEG does."""

    def __init__(self, out_dir: Path, prompt_mode: int = 0,
                 prob_thresh: float = 0.49):
        self.out_dir = Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.prompt_mode, self.prob_thresh = prompt_mode, prob_thresh
        self.sample_id, self.click_indx, self.rows = None, -1, []

    def __call__(self, image, gt_mask, probs, iou, sample_id, click_indx,
                 clicks):
        from .utils.vis import eval_panel
        if sample_id != self.sample_id or click_indx < self.click_indx:
            self.close()
            self.sample_id = sample_id
        self.click_indx = click_indx
        boxes = (display_box(gt_mask, probs, self.prob_thresh)
                 if self.prompt_mode == 1 else None)
        self.rows.append(eval_panel(
            image, gt_mask, probs, iou, click_indx, clicks_list=clicks,
            boxes=boxes, prompt_type=self.prompt_mode,
            prob_thresh=self.prob_thresh))

    def close(self) -> None:
        """Write the open session's stack."""
        from .utils.vis import write_png
        if self.rows:
            write_png(self.out_dir / f"{self.sample_id}.png",
                      np.concatenate(self.rows, axis=0))
        self.rows = []


if __name__ == "__main__":
    main()
