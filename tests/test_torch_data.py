"""The port's data pipeline (pvpuformer_tpu_torch/data) against the JAX
package's (pvpuformer_tpu/data) on the same seeds, on the CPU: resizes
bit-exact against cv2, every transform, the point sampler, scribbles,
records, the Loader's batches (thread and process workers, sharding) and
the on-disk datasets. Everything is numpy, so every comparison is exact."""
import dataclasses
import pickle
import sys

import numpy as np
import pytest

from pvpuformer_tpu import data as jdata
from pvpuformer_tpu.data import scribbles as jscr, transforms as jT
from pvpuformer_tpu_torch import data as tdata
from pvpuformer_tpu_torch.data import scribbles as tscr, transforms as tT

cv2 = pytest.importorskip("cv2")


def _equal(a, b):
    """Equal dtypes, shapes and bytes, or equal nested dicts / tuples /
    dataclasses."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__
        _equal(dataclasses.asdict(a), dataclasses.asdict(b))
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def _sample(seed, hw=(60, 80), k=3):
    r = np.random.default_rng(seed)
    img = r.integers(0, 256, (*hw, 3), dtype=np.uint8)
    yy, xx = np.mgrid[:hw[0], :hw[1]]
    masks = []
    for _ in range(k):
        cy, cx = r.integers(10, hw[0] - 10), r.integers(10, hw[1] - 10)
        ry, rx = r.integers(4, 14, 2)
        masks.append((((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1)
                     .astype(np.int32))
    return img, np.stack(masks)


# ------------------------------------------------------------------ resizes

# (src h, src w, dst h, dst w): odd up- and down-scales, 1-pixel edges, and
# the shipped pipeline's scales of a COCO-sized image (0.75 and 1.40)
RESIZES = [(37, 53, 61, 29), (5, 7, 13, 3), (1, 9, 4, 17), (9, 1, 2, 5),
           (64, 64, 47, 89), (100, 131, 131, 100), (480, 640, 360, 480),
           (480, 640, 672, 896), (333, 500, 250, 375)]


@pytest.mark.parametrize("src_h,src_w,h,w", RESIZES)
def test_resize_image_bit_exact_against_cv2(src_h, src_w, h, w):
    r = np.random.default_rng(src_h * 1000 + w)
    for c in (3, 1):
        img = r.integers(0, 256, (src_h, src_w, c), dtype=np.uint8)
        want = cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)
        got = tT._resize_image(img, h, w)
        np.testing.assert_array_equal(got, want.reshape(h, w, c))
        if c == 3:                      # the JAX package's path to cv2
            np.testing.assert_array_equal(got, jT._resize_image(img, h, w))


def test_resize_image_bit_exact_over_random_shapes():
    r = np.random.default_rng(7)
    for _ in range(150):
        (sh, sw), (h, w) = r.integers(1, 120, 2), r.integers(1, 160, 2)
        img = r.integers(0, 256, (sh, sw, 3), dtype=np.uint8)
        np.testing.assert_array_equal(tT._resize_image(img, h, w),
                                      jT._resize_image(img, h, w))


@pytest.mark.parametrize("dtype", [np.int32, np.uint8, np.float32, bool])
def test_resize_mask_exact(dtype):
    r = np.random.default_rng(3)
    for _ in range(100):
        (sh, sw), (h, w) = r.integers(1, 150, 2), r.integers(1, 200, 2)
        m = r.integers(0, 3, (sh, sw)).astype(dtype)
        _equal(tT._resize_mask(m, h, w), jT._resize_mask(m, h, w))


# --------------------------------------------------------------- transforms

TRANSFORMS = {
    "resize": lambda T: T.UniformRandomResize(scale_range=(0.75, 1.40)),
    "resize_p": lambda T: T.UniformRandomResize(p=0.5),
    "hflip": lambda T: T.HorizontalFlip(),
    "pad": lambda T: T.PadIfNeeded(72, 96),
    "crop": lambda T: T.RandomCrop(40, 48),
    "brightness_contrast": lambda T: T.RandomBrightnessContrast(),
    "rgb_shift": lambda T: T.RGBShift(),
    "train": lambda T: T.train_augmentator((64, 64)),
    "val": lambda T: T.val_augmentator((64, 64)),
    "compose_p": lambda T: T.Compose([T.HorizontalFlip(p=1.0),
                                      T.RGBShift(p=1.0)], p=0.5),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_matches_jax(name):
    for seed in range(12):
        img, masks = _sample(seed)
        rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
        want = TRANSFORMS[name](jT)(rj, img, masks)
        got = TRANSFORMS[name](tT)(rt, img, masks)
        _equal(got, want)
        assert rt.uniform() == rj.uniform()          # the same draws


# ------------------------------------------------------- sampler, scribbles

SAMPLERS = {
    "recipe": dict(max_num_points=24, prob_gamma=0.80,
                   merge_objects_prob=0.15, max_num_merged_objects=2),
    "default": dict(max_num_points=6),
    "merge_all": dict(max_num_points=4, merge_objects_prob=1.0,
                      max_num_merged_objects=3, positive_erode_prob=0.0),
}


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_points_sampler_matches_jax(name):
    js = jdata.MultiPointSampler(**SAMPLERS[name])
    ts = tdata.MultiPointSampler(**SAMPLERS[name])
    for seed in range(60):
        _, masks = _sample(seed, k=1 + seed % 4)
        if seed % 7 == 0:
            masks[:] = 0                          # the degenerate sample
        rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
        _equal(ts.sample(rt, list(masks)), js.sample(rj, list(masks)))
        assert rt.uniform() == rj.uniform()


def test_scribbles_match_jax():
    for seed in range(80):
        _, masks = _sample(seed, k=2)
        gt = masks[0] | (masks[1] if seed % 2 else 0)
        if seed % 11 == 0:
            gt[:] = 0
        rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
        _equal(tscr.cal_scribble_single(rt, gt, num_samples=200),
               jscr.cal_scribble_single(rj, gt, num_samples=200))
        assert rt.uniform() == rj.uniform()
    gts = np.stack([_sample(s)[1][0] for s in range(4)])
    _equal(tscr.batch_scribbles(np.random.default_rng(1), gts, 100),
           jscr.batch_scribbles(np.random.default_rng(1), gts, 100))
    ctrl = np.random.default_rng(2).uniform(0, 50, (6, 2))
    _equal(tscr.bezier_multi(ctrl, 33), jscr.bezier_multi(ctrl, 33))


# ------------------------------------------------------- records, Loader

def _synthetic(pkg, **kw):
    kw = {"n_samples": 6, "hw": (72, 88), "keep_background_prob": 0.0,
          "min_object_area": 20, "epoch_len": 12, "num_scribble_samples": 64,
          "seed": 3, **kw}
    T = jT if pkg is jdata else tT
    return pkg.SyntheticTrainDataset(
        augmentator=T.train_augmentator((64, 64)),
        points_sampler=pkg.MultiPointSampler(**SAMPLERS["recipe"]), **kw)


def test_synthetic_records_match_jax():
    jds, tds = _synthetic(jdata), _synthetic(tdata)
    assert len(tds) == len(jds) == 12
    for i in range(len(jds)):
        rec = tds[i]
        _equal(rec, jds[i])
        assert rec["image"].shape == (64, 64, 3)
        assert rec["image"].dtype == rec["instances"].dtype == np.float32
        assert rec["points"].shape == (48, 3)
        assert rec["scribbles"].shape == (64, 2)
        assert rec["scribble_rects"].shape == (4,)
    _equal(tds.get_raw_sample(2), jds.get_raw_sample(2))


@pytest.mark.parametrize("workers,worker_type,shard,drop_last", [
    (0, "thread", (0, 1), True), (3, "thread", (0, 1), True),
    (3, "thread", (1, 2), False), (2, "process", (0, 1), True),
    (2, "process", (1, 2), True)])
def test_loader_batches_match_jax(workers, worker_type, shard, drop_last):
    kw = dict(batch_size=4, seed=11, num_workers=workers, prefetch=2,
              drop_last=drop_last, process_index=shard[0],
              process_count=shard[1], worker_type=worker_type)
    jl = jdata.Loader(_synthetic(jdata, epoch_len=10), **kw)
    tl = tdata.Loader(_synthetic(tdata, epoch_len=10), **kw)
    assert len(tl) == len(jl) == (2 if drop_last else 3)
    for epoch in (0, 1):
        jl.set_epoch(epoch)
        tl.set_epoch(epoch)
        jb, tb = list(jl), list(tl)
        assert len(tb) == len(jb) == len(jl)
        _equal(tb, jb)
        assert tb[0]["image"].shape[0] == 4 // shard[1]


# ----------------------------------------------------------- disk datasets

def _cocolvis_fixture(root, png_layers):
    """tests/test_data.py:249-275's layout: images/<id>.jpg,
    masks/<id>.pickle (an array, or png-encoded layers), hannotation.pickle;
    image "b" adds a stuff object after its two instances."""
    from PIL import Image
    (root / "train" / "images").mkdir(parents=True)
    (root / "train" / "masks").mkdir(parents=True)
    r = np.random.default_rng(0)
    anno = {}
    for iid in ("a", "b"):
        img = (r.uniform(size=(48, 64, 3)) * 255).astype(np.uint8)
        Image.fromarray(img).save(root / "train" / "images" / f"{iid}.jpg")
        layer = np.zeros((48, 64), np.uint8)
        layer[8:24, 8:24] = 1
        layer[30:44, 30:60] = 2
        layer[2:6, 40:62] = 3
        mapping = [(0, 1), (0, 2)] + ([(0, 3)] if iid == "b" else [])
        stored = ([cv2.imencode(".png", layer)[1].tobytes()] if png_layers
                  else layer[:, :, None].astype(np.int32))
        with open(root / "train" / "masks" / f"{iid}.pickle", "wb") as f:
            pickle.dump(stored, f)
        anno[iid] = {"num_instance_masks": 2, "objs_mapping": mapping}
    with open(root / "train" / "hannotation.pickle", "wb") as f:
        pickle.dump(anno, f)


def _sbd_fixture(root):
    """tests/test_data.py:290-303's layout."""
    from PIL import Image
    from scipy.io import savemat
    (root / "img").mkdir(parents=True)
    (root / "inst").mkdir(parents=True)
    r = np.random.default_rng(0)
    for iid in ("x", "y"):
        inst = np.zeros((32, 40), np.uint8)
        inst[4:12, 4:12] = 1
        inst[20:30, 20:36] = 2
        Image.fromarray((r.uniform(size=(32, 40, 3)) * 255).astype(np.uint8)
                        ).save(root / "img" / f"{iid}.jpg")
        savemat(root / "inst" / f"{iid}.mat",
                {"GTinst": np.array([[(inst,)]],
                                    dtype=[("Segmentation", object)])})
    (root / "train.txt").write_text("x\ny\n")


def _imagedir_fixture(root):
    from PIL import Image
    (root / "images").mkdir(parents=True)
    (root / "masks").mkdir(parents=True)
    r = np.random.default_rng(1)
    for iid in ("p", "q"):
        Image.fromarray((r.uniform(size=(36, 44, 3)) * 255).astype(np.uint8)
                        ).save(root / "images" / f"{iid}.jpg")
        m = np.zeros((36, 44), np.uint8)
        m[3:15, 5:20] = 1
        m[20:33, 22:40] = 2 if iid == "p" else 255
        Image.fromarray(m).save(root / "masks" / f"{iid}.png")


DISK = {
    "cocolvis": (lambda root: _cocolvis_fixture(root, False),
                 lambda pkg, root, **kw: pkg.CocoLvisDataset(
                     root, split="train", stuff_prob=0.5, **kw)),
    "cocolvis_png": (lambda root: _cocolvis_fixture(root, True),
                     lambda pkg, root, **kw: pkg.CocoLvisDataset(
                         root, split="train", stuff_prob=0.5, **kw)),
    "sbd": (_sbd_fixture, lambda pkg, root, **kw: pkg.SBDTrainDataset(
        root, split="train", **kw)),
    "imagedir": (_imagedir_fixture,
                 lambda pkg, root, **kw: pkg.ImageDirTrainDataset(root, **kw)),
}


@pytest.mark.parametrize("name", sorted(DISK))
def test_disk_dataset_records_match_jax(tmp_path, name):
    write, make = DISK[name]
    write(tmp_path)
    sets = [make(pkg, tmp_path, epoch_len=6, min_object_area=10,
                 keep_background_prob=0.0, num_scribble_samples=32,
                 augmentator=T.val_augmentator((32, 32)),
                 points_sampler=pkg.MultiPointSampler(4, prob_gamma=0.8))
            for pkg, T in ((jdata, jT), (tdata, tT))]
    jds, tds = sets
    assert tds.get_samples_number() == jds.get_samples_number() == 2
    for i in range(2):
        _equal(tds.get_raw_sample(i), jds.get_raw_sample(i))
    for i in range(len(jds)):
        _equal(tds[i], jds[i])


def test_missing_decoder_names_it(tmp_path, monkeypatch):
    _cocolvis_fixture(tmp_path, True)
    ds = tdata.CocoLvisDataset(tmp_path, split="train",
                               points_sampler=tdata.MultiPointSampler(4))
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="'cv2'"):
        ds.get_raw_sample(0)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    with pytest.raises(ImportError, match="'PIL.Image'"):
        ds.get_raw_sample(0)
