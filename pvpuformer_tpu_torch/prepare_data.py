"""Dataset preparation and the BASELINE dress rehearsal of the port
(scripts/prepare_data.py in the port's idiom).

The reference never published its data layer; the on-disk layouts read
here are the RITM-lineage ones its evaluation CLI expects
(`isegm/inference/utils.py:48-76`, the download table of the reference
README.md:76-100). Four subcommands:

  check      for each dataset of config.yml: its key, layout, download
             pointer and a real parse (`inference/datasets.get_dataset` and
             one sample) -> PRESENT / MISSING / BROKEN.
  fixtures   tiny synthetic fixtures in every real on-disk layout under
             --out, and a config file that points at them.
  commands   the five BASELINE.json configurations as command lines of the
             port's evaluation CLI.
  rehearse   fixtures, then the five configurations run end to end on them
             by `python -m pvpuformer_tpu_torch.evaluate --random-weights`,
             each a process: ViT-B@448 for configs 1-3, ViT-L@448 on SBD
             with --iou-analysis --save-ious for config 4, ViT-H@448
             --batched 2 on COCO_MVal for config 5 (configs 2-5 at 2 clicks,
             3-5 at --limit 1).

    python -m pvpuformer_tpu_torch.prepare_data check [--config config.yml]
    python -m pvpuformer_tpu_torch.prepare_data fixtures --out DIR
    python -m pvpuformer_tpu_torch.prepare_data commands
    python -m pvpuformer_tpu_torch.prepare_data rehearse --out DIR \
        [--device cpu] [--skip-large]

`rehearse` runs on the card unless --device cpu is given, and raises where
there is none.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
CLI = "python -m pvpuformer_tpu_torch.evaluate"

# name -> (config.yml key, layout description, download pointer
#          [reference README.md:76-100])
DATASETS = {
    "GrabCut": ("GRABCUT_PATH",
                "data_GT/*.bmp images + boundary_GT/*.bmp masks "
                "(128 = ignore band)",
                "GrabCut.zip (11 MB) — link in reference README 'Datasets'"),
    "Berkeley": ("BERKELEY_PATH", "images/*.jpg + masks/*.png",
                 "Berkeley.zip (7 MB) — reference README"),
    "DAVIS": ("DAVIS_PATH", "img/*.jpg + gt/*.png",
              "DAVIS.zip (43 MB) — reference README"),
    "COCO_MVal": ("COCO_MVAL_PATH", "img/*.jpg + gt/*.png (DAVIS layout)",
                  "COCO_MVal.zip (127 MB) — reference README"),
    "PascalVOC": ("PASCALVOC_PATH",
                  "VOC2012 devkit: JPEGImages/ + SegmentationObject/ + "
                  "ImageSets/Segmentation/val.txt",
                  "http://host.robots.ox.ac.uk/pascal/VOC/voc2012/"),
    "SBD": ("SBD_EVAL_PATH",
            "img/*.jpg + inst/*.mat (GTinst.Segmentation) + val.txt",
            "http://home.bharathh.info/pubs/codes/SBD/download.html"),
    "BraTS": ("BraTS_PATH", "images/*.png + masks/*.png slices",
              "BraTS20.zip (4.2 MB) — reference README"),
    "ssTEM": ("ssTEM_PATH", "raw/*.png + mitochondria/*.png",
              "github.com/unidesigner/groundtruth-drosophila-vnc"),
    "OAIZIB": ("OAIZIB_PATH", "images/*.png + masks/*.png (2 = tibia id)",
               "OAI-ZIB.zip (27 MB) — reference README"),
    "HARD": ("HARD_PATH", "images/*.jpg + masks/*.png",
             "reference README (ablation set)"),
    "ADE20K": ("ADE20K_PATH",
               "ADEChallengeData2016: images/validation/*.jpg + "
               "annotations_instance/validation/*.png (R=class, G=instance)",
               "http://sceneparsing.csail.mit.edu/"),
}

# training sets (data/cocolvis.py layouts)
TRAIN_SETS = {
    "CocoLvis": ("LVIS_v1_PATH",
                 "train/images/*.jpg + train/masks/*.pickle + "
                 "train/hannotation.pickle (RITM combined annotations)",
                 "LVIS images + combined annotations — reference README"),
    "SBD_train": ("SBD_PATH", "img/*.jpg + inst/*.mat + train.txt",
                  "SBD official site"),
}

# The five BASELINE.json configs -> command lines. {ckpt_*} resolve to
# downloaded or trained checkpoints; the rehearsal takes --random-weights.
BASELINE_COMMANDS = [
    ("1: ViT-B@448 single-click NoBRS on GrabCut",
     f"{CLI} NoBRS --checkpoint {{ckpt_base}} "
     "--datasets GrabCut --n-clicks 1 --target-iou 1.01 --print-ious"),
    ("2: ViT-B multi-round click loop + zoom-in on Berkeley+DAVIS (NoC@90)",
     f"{CLI} NoBRS --checkpoint {{ckpt_base}} "
     "--datasets Berkeley,DAVIS --n-clicks 20 --target-iou 0.90"),
    ("3: ViT-B unified prompts (box / scribble PPuE) on PascalVOC",
     f"{CLI} NoBRS --checkpoint {{ckpt_base}} "
     "--datasets PascalVOC --n-clicks 20 --prompt-mode {prompt_mode}"),
    ("4: ViT-L@448 full 20-click iterative eval on SBD (iou-analysis)",
     f"{CLI} NoBRS --checkpoint {{ckpt_large}} "
     "--datasets SBD --n-clicks 20 --iou-analysis --save-ious"),
    ("5: ViT-H batched multi-instance eval (throughput stress)",
     f"{CLI} NoBRS --checkpoint {{ckpt_huge}} "
     "--datasets COCO_MVal --n-clicks 20 --batched 8"),
]


def cmd_check(args) -> int:
    from .inference.datasets import get_dataset
    from .utils.exp import load_config_file

    cfg_path = Path(args.config)
    paths = load_config_file(cfg_path) if cfg_path.exists() else {}
    missing = 0
    for table in (DATASETS, TRAIN_SETS):
        for name, (key, layout, link) in table.items():
            path = paths.get(key)
            status = "MISSING"
            detail = ""
            if path and Path(path).exists():
                if table is DATASETS:
                    try:
                        ds = get_dataset(name, path)
                        s = ds.get_sample(0)
                        status = "PRESENT"
                        detail = f"{len(ds)} samples, first {s.image.shape}"
                    except Exception as e:          # noqa: BLE001
                        # a report line per dataset, as the tool's output
                        status = "BROKEN"
                        detail = f"{type(e).__name__}: {e}"
                else:
                    status = "PRESENT"
            else:
                missing += 1
            print(f"{name:10s} {status:8s} {key}={path}")
            print(f"{'':10s} layout: {layout}")
            if status != "PRESENT":
                print(f"{'':10s} get it: {link}   {detail}")
            elif detail:
                print(f"{'':10s} {detail}")
    return 0 if missing == 0 else 1


def write_fixtures(out: Path) -> Path:
    """Tiny synthetic fixtures in every real evaluation layout; the same
    files, from the same draws, as the JAX package's tool writes."""
    from PIL import Image
    from scipy.io import savemat

    r = np.random.default_rng(3)
    h, w = 80, 100

    def img(p):
        p.parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(
            r.integers(0, 255, (h, w, 3)).astype(np.uint8)).save(p)

    def mask(p, ignore=None):
        p.parent.mkdir(parents=True, exist_ok=True)
        m = np.zeros((h, w), np.uint8)
        m[20:60, 30:70] = 255
        if ignore is not None:
            m[20:22, 30:70] = ignore
        Image.fromarray(m).save(p)

    g = out / "GrabCut"
    img(g / "data_GT" / "pic1.bmp")
    mask(g / "boundary_GT" / "pic1.bmp", ignore=128)
    b = out / "Berkeley"
    img(b / "images" / "im1.jpg")
    mask(b / "masks" / "im1.png")
    for dname in ("DAVIS", "COCO_MVal"):
        d = out / dname
        img(d / "img" / "f0.jpg")
        mask(d / "gt" / "f0.png")
    v = out / "VOC2012"
    img(v / "JPEGImages" / "2007_000001.jpg")
    so = np.zeros((h, w), np.uint8)
    so[20:40, 30:70] = 1
    so[45:60, 30:70] = 2
    so[40:42, 30:70] = 255
    (v / "SegmentationObject").mkdir(parents=True, exist_ok=True)
    Image.fromarray(so).save(v / "SegmentationObject" / "2007_000001.png")
    (v / "ImageSets" / "Segmentation").mkdir(parents=True, exist_ok=True)
    (v / "ImageSets" / "Segmentation" / "val.txt").write_text("2007_000001\n")
    s = out / "SBD"
    img(s / "img" / "x1.jpg")
    inst = np.zeros((h, w), np.uint8)
    inst[20:60, 30:70] = 1
    (s / "inst").mkdir(parents=True, exist_ok=True)
    savemat(str(s / "inst" / "x1.mat"),
            {"GTinst": np.array([[(inst,)]], dtype=[("Segmentation", "O")])})
    (s / "val.txt").write_text("x1\n")

    cfg = out / "config.yml"
    cfg.write_text(
        "EXPS_PATH: ./experiments\n"
        f"GRABCUT_PATH: {g}\nBERKELEY_PATH: {b}\n"
        f"DAVIS_PATH: {out / 'DAVIS'}\nCOCO_MVAL_PATH: {out / 'COCO_MVal'}\n"
        f"PASCALVOC_PATH: {v}\nSBD_EVAL_PATH: {s}\n")
    return cfg


def cmd_fixtures(args) -> int:
    cfg = write_fixtures(Path(args.out))
    print(f"fixtures written; config: {cfg}")
    return 0


def cmd_commands(args) -> int:
    for title, cmd in BASELINE_COMMANDS:
        print(f"# BASELINE config {title}")
        for pm in ((1, 2) if "{prompt_mode}" in cmd else (None,)):
            print(cmd.format(ckpt_base="<vpu_base448_cocolvis.npz>",
                             ckpt_large="<vpu_large448_cocolvis.npz>",
                             ckpt_huge="<vpu_huge448_cocolvis.npz>",
                             prompt_mode=pm))
        print()
    return 0


def rehearsal_runs(cfg: Path, out: Path, device: str,
                   skip_large: bool = False):
    """[(title, argv)] of the rehearsal: the BASELINE configurations on the
    fixtures of `cfg`, random weights."""
    base = [sys.executable, "-m", "pvpuformer_tpu_torch.evaluate", "NoBRS",
            "--random-weights", "--config-path", str(cfg),
            "--logs-path", str(out / "logs"), "--device", device]
    runs = [
        ("config 1 (ViT-B GrabCut 1-click)",
         base + ["--datasets", "GrabCut", "--n-clicks", "1",
                 "--target-iou", "1.01", "--print-ious"]),
        ("config 2 (ViT-B Berkeley+DAVIS NoC@90)",
         base + ["--datasets", "Berkeley,DAVIS", "--n-clicks", "2",
                 "--target-iou", "0.90"]),
        ("config 3 (ViT-B PascalVOC box prompts)",
         base + ["--datasets", "PascalVOC", "--n-clicks", "2",
                 "--prompt-mode", "1", "--limit", "1"]),
        ("config 3b (ViT-B PascalVOC scribble prompts)",
         base + ["--datasets", "PascalVOC", "--n-clicks", "2",
                 "--prompt-mode", "2", "--limit", "1"]),
    ]
    if not skip_large:
        runs += [
            ("config 4 (ViT-L SBD iou-analysis)",
             base + ["--model-size", "large", "--datasets", "SBD",
                     "--n-clicks", "2", "--iou-analysis", "--save-ious",
                     "--limit", "1"]),
            ("config 5 (ViT-H COCO_MVal batched)",
             base + ["--model-size", "huge", "--datasets", "COCO_MVal",
                     "--n-clicks", "2", "--batched", "2", "--limit", "1"]),
        ]
    return runs


def cmd_rehearse(args) -> int:
    from .nn import resolve_device
    device = str(resolve_device(args.device))
    out = Path(args.out)
    cfg = write_fixtures(out)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    for title, cmd in rehearsal_runs(cfg, out, device, args.skip_large):
        print(f"--- rehearsing BASELINE {title}", flush=True)
        t = time.perf_counter()
        r = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                           text=True)
        tail = r.stdout.strip().splitlines()[-6:]
        print("\n".join(tail))
        print(f"(rc {r.returncode} in {time.perf_counter() - t:.1f} s)",
              flush=True)
        if r.returncode != 0:
            print(r.stderr[-3000:])
            return 1
    print("dress rehearsal: ALL BASELINE commands ran end-to-end on the "
          "fixture formats")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("check")
    c.add_argument("--config", default=str(ROOT / "config.yml"))
    f = sub.add_parser("fixtures")
    f.add_argument("--out", required=True)
    sub.add_parser("commands")
    rh = sub.add_parser("rehearse")
    rh.add_argument("--out", required=True)
    rh.add_argument("--device", default="cuda",
                    help="torch device of the evaluation runs (default: the "
                         "card; no fallback)")
    rh.add_argument("--skip-large", action="store_true",
                    help="skip the ViT-L/H runs")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return {"check": cmd_check, "fixtures": cmd_fixtures,
            "commands": cmd_commands, "rehearse": cmd_rehearse}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
