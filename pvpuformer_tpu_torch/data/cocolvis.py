"""CocoLvis training dataset (the "C+L" recipe, vpu_base448_cocolvis.py:100-125);
a copy of pvpuformer_tpu/data/cocolvis.py.

The reference's `isegm.data.datasets.CocoLvisDataset` was never published;
this follows the RITM-lineage on-disk layout its config paths imply
(`config.yml:10` LVIS_v1_PATH -> <root>/<split>/ with):

    <root>/<split>/images/<image>.jpg
    <root>/<split>/masks/<image>.pickle       # (layers png-encoded or array)
    <root>/<split>/hannotation.pickle         # per-image object metadata

Each hannotation entry: {image_id: {'num_instance_masks': int,
'hierarchy': {...}, 'objs_mapping': [(layer_idx, mask_id), ...]}}. A mask
layer is an (H, W) int array; object k occupies pixels == mask_id in layer
layer_idx. `stuff_prob` mixes in non-instance (stuff/semantic) objects, which
the layout stores after the instance masks.

Also provides `ImageDirTrainDataset` — a plain <images>/<instance png>
layout fallback so training runs on any simple dataset dump.

The decoders (PIL for images, cv2 for png-encoded mask layers) are imported
where a sample is read; without one, reading raises an ImportError that
names it.
"""
from __future__ import annotations

import importlib
import pickle
from pathlib import Path
from typing import List

import numpy as np

from .base import ISTrainDataset, TrainSample


def _decoder(module: str):
    """`module` (cv2, PIL.Image), imported where a sample is read."""
    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise ImportError(f"reading this dataset needs the decoder {module!r}, "
                          f"which is not installed") from e


class CocoLvisDataset(ISTrainDataset):
    def __init__(self, dataset_path, split: str = "train",
                 stuff_prob: float = 0.0,
                 copy_paste_prob: float = 0.0,
                 image_mix_prob: float = 0.0,
                 anno_file: str = "hannotation.pickle",
                 **kw):
        super().__init__(**kw)
        self.path = Path(dataset_path) / split
        self.split = split
        self.stuff_prob = stuff_prob
        self.copy_paste_prob = copy_paste_prob
        self.image_mix_prob = image_mix_prob
        with open(self.path / anno_file, "rb") as f:
            self.dataset_samples = sorted(pickle.load(f).items())
        self._images_path = self.path / "images"
        self._masks_path = self.path / "masks"

    def get_samples_number(self) -> int:
        return len(self.dataset_samples)

    def _load_layers(self, image_id: str) -> np.ndarray:
        with open(self._masks_path / f"{image_id}.pickle", "rb") as f:
            encoded = pickle.load(f)
        if isinstance(encoded, np.ndarray):
            return encoded
        # layers stored as a list of png-encoded arrays (RITM convention)
        cv2 = _decoder("cv2")
        layers = [cv2.imdecode(np.frombuffer(e, np.uint8),
                               cv2.IMREAD_UNCHANGED) for e in encoded]
        return np.stack(layers, axis=2)

    def get_raw_sample(self, index: int) -> TrainSample:
        Image = _decoder("PIL.Image")
        image_id, anno = self.dataset_samples[index]
        image = np.asarray(Image.open(self._images_path / f"{image_id}.jpg")
                           .convert("RGB"))
        layers = self._load_layers(image_id)
        if layers.ndim == 2:
            layers = layers[:, :, None]

        n_inst = anno.get("num_instance_masks", 0)
        objs_mapping = anno.get("objs_mapping", [])
        rng = np.random.default_rng((hash(image_id) & 0xFFFF, index))
        take_stuff = rng.uniform() < self.stuff_prob
        masks: List[np.ndarray] = []
        for k, (layer_idx, mask_id) in enumerate(objs_mapping):
            if k >= n_inst and not take_stuff:
                continue
            masks.append((layers[:, :, layer_idx] == mask_id).astype(np.int32))
        if not masks:
            masks = [np.zeros(image.shape[:2], np.int32)]
        return TrainSample(image=image, masks=masks)


class ImageDirTrainDataset(ISTrainDataset):
    """<root>/images/*.jpg + <root>/masks/<stem>.png with per-instance ids."""

    def __init__(self, dataset_path, images_dir: str = "images",
                 masks_dir: str = "masks", **kw):
        super().__init__(**kw)
        self.root = Path(dataset_path)
        self.images = sorted((self.root / images_dir).glob("*.*"))
        self.masks_dir = self.root / masks_dir
        assert self.images, f"no images under {self.root / images_dir}"

    def get_samples_number(self) -> int:
        return len(self.images)

    def get_raw_sample(self, index: int) -> TrainSample:
        Image = _decoder("PIL.Image")
        ipath = self.images[index]
        image = np.asarray(Image.open(ipath).convert("RGB"))
        mpath = next(iter(self.masks_dir.glob(ipath.stem + ".*")))
        raw = np.asarray(Image.open(mpath))
        if raw.ndim == 3:
            raw = raw[..., 0]
        masks = [(raw == oid).astype(np.int32)
                 for oid in np.unique(raw) if oid not in (0, 255)]
        if not masks:
            masks = [(raw > 0).astype(np.int32)]
        return TrainSample(image=image, masks=masks)


class SBDTrainDataset(ISTrainDataset):
    """SBD train split from the .mat instance annotations
    (commented-out recipe at vpu_base448_cocolvis.py:128-146)."""

    def __init__(self, dataset_path, split: str = "train", **kw):
        super().__init__(**kw)
        self.root = Path(dataset_path)
        split_file = self.root / f"{split}.txt"
        self.ids = [l.strip() for l in split_file.read_text().splitlines()
                    if l.strip()]

    def get_samples_number(self) -> int:
        return len(self.ids)

    def get_raw_sample(self, index: int) -> TrainSample:
        Image = _decoder("PIL.Image")
        from scipy.io import loadmat
        iid = self.ids[index]
        image = np.asarray(Image.open(self.root / "img" / f"{iid}.jpg")
                           .convert("RGB"))
        inst = loadmat(str(self.root / "inst" / f"{iid}.mat"))["GTinst"][0][0][0]
        masks = [(inst == oid).astype(np.int32)
                 for oid in np.unique(inst) if oid != 0]
        if not masks:
            masks = [np.zeros(image.shape[:2], np.int32)]
        return TrainSample(image=image, masks=masks)
