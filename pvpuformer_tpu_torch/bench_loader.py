"""Host input-pipeline throughput against the shipped recipe's rate
(scripts/bench_loader.py in the port's idiom): can data/loader.py feed the
card?

Writes a synthetic CocoLvis-format train split to disk (~640 x 480 JPEG
images, png-encoded mask layers: the layout data/cocolvis.py parses), then
times the full record path: JPEG decode -> layer decode ->
train_augmentator(448) (resize / flip / pad / crop / brightness / rgbshift
with retry) -> MultiPointSampler -> scribble synthesis -> collate, through
the Loader's prefetching pool at batch 32, on thread and on process
workers. Each rate is printed beside the recipe's demand, its batch of 32
over its mean training step on the card (RECIPE_STEP_MS).

    python -m pvpuformer_tpu_torch.bench_loader [--images 64] [--batches 20]
        [--workers 1 4 8] [--types thread process] [--device cpu]

The pipeline runs on the host (numpy and scipy; the workers never touch
CUDA). Without --device the tool asks for the card it feeds, and raises
where there is none.
"""
from __future__ import annotations

import argparse
import os
import pickle
import tempfile
import time
from pathlib import Path

import numpy as np

# The shipped recipe's mean step at batch 32 on an NVIDIA H100 80GB HBM3 at
# 700 W: num_iters is drawn uniformly from 1-3, and `python -m
# pvpuformer_tpu_torch.hbm_fit` (its defaults, alone on the card) took
# 276.6 / 513.1 / 855.8 ms for the steps of 1 / 2 / 3 rounds.
RECIPE_STEP_MS = (276.6 + 513.1 + 855.8) / 3
RECIPE_BATCH = 32


def write_cocolvis_like(root: Path, n_images: int, hw=(480, 640),
                        n_objects: int = 4) -> None:
    """CocoLvis-format train split with realistic image geometry
    (data/cocolvis.py's layout; LVIS images are ~640x480 median); the same
    files, from the same draws, as the JAX package's tool writes."""
    import cv2
    from PIL import Image

    split = root / "train"
    (split / "images").mkdir(parents=True, exist_ok=True)
    (split / "masks").mkdir(parents=True, exist_ok=True)
    h, w = hw
    anno = {}
    r = np.random.default_rng(0)
    for i in range(n_images):
        image_id = f"im{i:05d}"
        # textured image so JPEG decode cost is realistic (~35-60 KB files)
        base = r.integers(0, 255, (h // 8, w // 8, 3)).astype(np.uint8)
        img = cv2.resize(base, (w, h), interpolation=cv2.INTER_CUBIC)
        noise = r.integers(0, 40, (h, w, 3)).astype(np.uint8)
        Image.fromarray(cv2.add(img, noise)).save(
            split / "images" / f"{image_id}.jpg", quality=85)
        layer = np.zeros((h, w), np.uint8)
        mapping = []
        for k in range(n_objects):
            cy, cx = r.integers(60, h - 60), r.integers(60, w - 60)
            ry, rx = r.integers(30, 90, 2)
            yy, xx = np.mgrid[:h, :w]
            m = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
            layer[m] = k + 1
            mapping.append((0, k + 1))
        ok, enc = cv2.imencode(".png", layer)
        if not ok:
            raise RuntimeError(f"cv2 could not encode {image_id}'s layer")
        with open(split / "masks" / f"{image_id}.pickle", "wb") as f:
            pickle.dump([enc.tobytes()], f)
        anno[image_id] = {"num_instance_masks": n_objects,
                          "objs_mapping": mapping}
    with open(split / "hannotation.pickle", "wb") as f:
        pickle.dump(anno, f)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--images", type=int, default=64)
    ap.add_argument("--batches", type=int, default=20)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--workers", type=int, nargs="+", default=[1, 4, 8])
    ap.add_argument("--types", nargs="+", default=["thread", "process"])
    ap.add_argument("--root", default=os.path.join(tempfile.gettempdir(),
                                                   "pvpu_loader_bench"))
    ap.add_argument("--device", default="cuda",
                    help="the card the pipeline feeds (default; no "
                         "fallback) or cpu")
    return ap


def main(argv=None) -> dict:
    """Prints the serial cost and a line per (type, workers); returns
    {"serial_ms": ms per record, "demand": records/s,
    (type, workers): records/s}."""
    args = build_parser().parse_args(argv)
    from .nn import resolve_device
    resolve_device(args.device)

    from .data import MultiPointSampler
    from .data.cocolvis import CocoLvisDataset
    from .data.loader import Loader
    from .data import transforms as T

    root = Path(args.root)
    if not (root / "train" / "hannotation.pickle").exists():
        print(f"# writing {args.images} CocoLvis-format fixtures to {root}")
        write_cocolvis_like(root, args.images)

    sampler = MultiPointSampler(24, prob_gamma=0.80,
                                merge_objects_prob=0.15,
                                max_num_merged_objects=2)
    n_records = args.batch_size * (args.batches + 2)
    ds = CocoLvisDataset(root, split="train",
                         augmentator=T.train_augmentator((448, 448)),
                         min_object_area=1000, keep_background_prob=0.05,
                         points_sampler=sampler, epoch_len=n_records,
                         stuff_prob=0.30)

    # single-record cost first (the serial floor). Warm up: the first
    # records pay one-time costs (imports, library init) that a
    # long-running training process never sees again.
    for i in range(6):
        ds[i]
    t0 = time.perf_counter()
    n_ser = 24
    for i in range(6, 6 + n_ser):
        ds[i]
    ser = (time.perf_counter() - t0) / n_ser
    print(f"# warm serial record assembly: {ser * 1e3:.1f} ms/record "
          f"({1 / ser:.1f} samples/s per core)")
    demand = RECIPE_BATCH / (RECIPE_STEP_MS / 1e3)
    print(f"# host cores: {os.cpu_count()}; b{RECIPE_BATCH} recipe demand "
          f"{demand:.1f} samples/s (a {RECIPE_STEP_MS:.1f} ms mean step on "
          f"the H100) -> needs ~{demand * ser:.1f} busy cores at this "
          f"per-record cost")
    out = {"serial_ms": ser * 1e3, "demand": demand}

    for wt in args.types:
        for nw in args.workers:
            loader = Loader(ds, batch_size=args.batch_size, shuffle=True,
                            num_workers=nw, worker_type=wt)
            it = iter(loader)
            next(it)                     # pool spin-up + first prefetch
            t0 = time.perf_counter()
            got = 0
            for _ in range(args.batches):
                b = next(it)
                got += b["image"].shape[0]
            dt = time.perf_counter() - t0
            it.close()
            out[(wt, nw)] = got / dt
            print(f"{wt:7s} workers={nw}: {got / dt:7.1f} samples/s "
                  f"({dt / args.batches * 1e3:6.1f} ms/batch{args.batch_size}"
                  f"; {got / dt / demand:.2f}x the recipe's demand)",
                  flush=True)
    return out


if __name__ == "__main__":
    main()
