"""Evaluation datasets (pvpuformer_tpu/inference/datasets.py).

A dataset has `len(ds)` and `ds.get_sample(i)`, which returns a `DSample`
with `.image` (H, W, 3 uint8), `.objects_ids` and `.gt_mask(obj_id)` (the
call sites of isegm/inference/vpu_evaluation.py:22-27 and
isegm/inference/utils.py:49-77). The file-backed layouts follow the
RITM-lineage conventions of config.yml's paths; `SyntheticDataset` draws
the same images and masks as the JAX package's for the same seed.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class DSample:
    image: np.ndarray                       # (H, W, 3) uint8
    masks: Dict[int, np.ndarray]            # obj_id -> (H, W) {0,1,-1}

    @property
    def objects_ids(self) -> List[int]:
        return list(self.masks.keys())

    def gt_mask(self, obj_id: int) -> np.ndarray:
        return self.masks[obj_id]


class EvalDataset:
    def __len__(self) -> int:
        raise NotImplementedError

    def get_sample(self, index: int) -> DSample:
        raise NotImplementedError

    @property
    def name(self) -> str:
        return type(self).__name__


def _imread(path: Path) -> np.ndarray:
    from PIL import Image
    return np.asarray(Image.open(path).convert("RGB"))


def _maskread(path: Path) -> np.ndarray:
    from PIL import Image
    return np.asarray(Image.open(path))


class ImageMaskDataset(EvalDataset):
    """Generic <images dir> + <masks dir> dataset (GrabCut / Berkeley / DAVIS
    / COCO_MVal layout). Mask decode: 0 -> background, `ignore_value` -> -1,
    anything else -> 1."""

    def __init__(self, root, images_dir: str, masks_dir: str,
                 image_glob: str = "*.*", ignore_value: Optional[int] = 128):
        self.root = Path(root)
        self.images = sorted((self.root / images_dir).glob(image_glob))
        self.masks_dir = self.root / masks_dir
        self.ignore_value = ignore_value
        assert self.images, f"no images under {self.root / images_dir}"

    def __len__(self):
        return len(self.images)

    def _mask_path(self, image_path: Path) -> Path:
        cands = list(self.masks_dir.glob(image_path.stem + ".*"))
        assert cands, f"no mask for {image_path}"
        return cands[0]

    def get_sample(self, index: int) -> DSample:
        ipath = self.images[index]
        image = _imread(ipath)
        raw = _maskread(self._mask_path(ipath))
        if raw.ndim == 3:
            raw = raw[..., 0]
        mask = np.zeros(raw.shape, np.int32)
        mask[raw > 0] = 1
        if self.ignore_value is not None:
            mask[raw == self.ignore_value] = -1
        return DSample(image=image, masks={0: mask})


class GrabCutDataset(ImageMaskDataset):
    """GrabCut-50: data_GT images + boundary_GT masks (128 = ignore band)."""

    def __init__(self, root):
        super().__init__(root, "data_GT", "boundary_GT", ignore_value=128)


class BerkeleyDataset(ImageMaskDataset):
    def __init__(self, root):
        super().__init__(root, "images", "masks", ignore_value=None)


class DavisDataset(ImageMaskDataset):
    """DAVIS-345 / COCO_MVal layout: img/ + gt/."""

    def __init__(self, root):
        super().__init__(root, "img", "gt", ignore_value=None)


class PascalVocDataset(EvalDataset):
    """VOC2012 instance segmentation val split; per-instance ids with the
    255 border as ignore."""

    def __init__(self, root, split: str = "val"):
        self.root = Path(root)
        split_file = self.root / "ImageSets" / "Segmentation" / f"{split}.txt"
        self.ids = [l.strip() for l in split_file.read_text().splitlines() if l.strip()]

    def __len__(self):
        return len(self.ids)

    def get_sample(self, index: int) -> DSample:
        iid = self.ids[index]
        image = _imread(self.root / "JPEGImages" / f"{iid}.jpg")
        raw = _maskread(self.root / "SegmentationObject" / f"{iid}.png")
        masks = {}
        for obj_id in np.unique(raw):
            if obj_id in (0, 255):
                continue
            m = np.zeros(raw.shape, np.int32)
            m[raw == obj_id] = 1
            m[raw == 255] = -1
            masks[int(obj_id)] = m
        return DSample(image=image, masks=masks)


class SBDEvaluationDataset(EvalDataset):
    """SBD per-instance evaluation split (inst/ .mat files)."""

    def __init__(self, root, split: str = "val"):
        self.root = Path(root)
        split_file = self.root / f"{split}.txt"
        self.ids = [l.strip() for l in split_file.read_text().splitlines() if l.strip()]

    def __len__(self):
        return len(self.ids)

    def get_sample(self, index: int) -> DSample:
        from scipy.io import loadmat
        iid = self.ids[index]
        image = _imread(self.root / "img" / f"{iid}.jpg")
        inst = loadmat(str(self.root / "inst" / f"{iid}.mat"))["GTinst"][0][0][0]
        masks = {}
        for obj_id in np.unique(inst):
            if obj_id == 0:
                continue
            masks[int(obj_id)] = (inst == obj_id).astype(np.int32)
        return DSample(image=image, masks=masks)


class BraTSDataset(ImageMaskDataset):
    """BraTS20 2-D slice export (`inference/utils.py:64-65`,
    `config.yml:9`). The reference's loader was never published; layout is
    our spec: `images/*.png` + `masks/*.png` slice pairs, mask nonzero =
    tumor."""

    def __init__(self, root):
        super().__init__(root, "images", "masks", ignore_value=None)


class ssTEMDataset(ImageMaskDataset):
    """ssTEM drosophila VNC stack (`inference/utils.py:66-67`; the
    reference points at `groundtruth-drosophila-vnc/stack1`, `config.yml:10`,
    whose published structure is `raw/` EM slices + per-structure label
    dirs). We evaluate on the mitochondria labels, per the SimpleClick
    medical protocol this path descends from."""

    def __init__(self, root):
        super().__init__(root, "raw", "mitochondria", ignore_value=None)


class OAIZIBDataset(EvalDataset):
    """OAI-ZIB knee-MRI slices (`inference/utils.py:68-69`, `config.yml:11`).
    Layout (our spec): `images/*.png` + `masks/*.png`; mask labels 1..4
    (femoral/tibial bone + cartilage) each become an instance."""

    def __init__(self, root):
        self.root = Path(root)
        self.images = sorted((self.root / "images").glob("*.*"))
        assert self.images, f"no images under {self.root / 'images'}"

    def __len__(self):
        return len(self.images)

    def get_sample(self, index: int) -> DSample:
        ipath = self.images[index]
        image = _imread(ipath)
        cands = list((self.root / "masks").glob(ipath.stem + ".*"))
        assert cands, f"no mask for {ipath}"
        raw = _maskread(cands[0])
        if raw.ndim == 3:
            raw = raw[..., 0]
        masks = {}
        for obj_id in np.unique(raw):
            if obj_id == 0:
                continue
            masks[int(obj_id)] = (raw == obj_id).astype(np.int32)
        return DSample(image=image, masks=masks)


class HARDDataset(ImageMaskDataset):
    """'HARD' cases set (`inference/utils.py:70-71`; its path is commented
    out of the reference config, `config.yml:13`). Generic `images/` +
    `masks/` layout."""

    def __init__(self, root):
        super().__init__(root, "images", "masks", ignore_value=None)


class ADE20kDataset(EvalDataset):
    """ADE20k SceneParsing instances (`inference/utils.py:72-73`).
    ADEChallengeData2016 layout: `images/<split>/*.jpg` +
    `annotations_instance/<split>/*.png` where the annotation PNG encodes
    class in channel R and instance id in channel G. Instance ids are
    per-class in this encoding, so objects are keyed by the (R, G) =
    (class, instance) pair — keying by G alone would merge same-numbered
    instances of different classes into one evaluation mask."""

    def __init__(self, root, split: str = "val"):
        self.root = Path(root)
        subdir = {"val": "validation", "train": "training"}.get(split, split)
        self.subdir = subdir
        self.images = sorted((self.root / "images" / subdir).glob("*.jpg"))
        assert self.images, f"no images under {self.root / 'images' / subdir}"

    def __len__(self):
        return len(self.images)

    def get_sample(self, index: int) -> DSample:
        ipath = self.images[index]
        image = _imread(ipath)
        ann = _maskread(self.root / "annotations_instance" / self.subdir
                        / (ipath.stem + ".png"))
        if ann.ndim == 3:
            # pack (class, instance) into one int key: class*1000 + instance
            cls = ann[..., 0].astype(np.int32)
            inst = ann[..., 1].astype(np.int32)
            keyed = np.where(inst > 0, cls * 1000 + inst, 0)
        else:
            keyed = ann.astype(np.int32)
        masks = {}
        for obj_id in np.unique(keyed):
            if obj_id == 0:
                continue
            masks[int(obj_id)] = (keyed == obj_id).astype(np.int32)
        return DSample(image=image, masks=masks)


class SyntheticDataset(EvalDataset):
    """Deterministic in-memory dataset for tests and smoke benchmarks:
    random images with ellipse/rectangle objects."""

    def __init__(self, n_samples: int = 4, hw=(96, 128), seed: int = 0):
        self.n = n_samples
        self.hw = hw
        self.seed = seed

    def __len__(self):
        return self.n

    def get_sample(self, index: int) -> DSample:
        r = np.random.default_rng(self.seed + index)
        h, w = self.hw
        image = r.integers(0, 255, (h, w, 3), dtype=np.uint8)
        yy, xx = np.mgrid[:h, :w]
        cy, cx = r.integers(h // 4, 3 * h // 4), r.integers(w // 4, 3 * w // 4)
        ry, rx = r.integers(h // 8, h // 4), r.integers(w // 8, w // 4)
        mask = (((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1).astype(np.int32)
        image[mask == 1] = (image[mask == 1] * 0.3 + 150).astype(np.uint8)
        return DSample(image=image, masks={0: mask})


DATASET_REGISTRY: Dict[str, Callable] = {
    "GrabCut": GrabCutDataset,
    "Berkeley": BerkeleyDataset,
    "DAVIS": DavisDataset,
    "COCO_MVal": DavisDataset,
    "PascalVOC": PascalVocDataset,
    "SBD": SBDEvaluationDataset,
    "SBD_Train": SBDEvaluationDataset,
    "BraTS": BraTSDataset,
    "ssTEM": ssTEMDataset,
    "OAIZIB": OAIZIBDataset,
    "HARD": HARDDataset,
    "ADE20K": ADE20kDataset,
    "Synthetic": SyntheticDataset,
}


def get_dataset(name: str, path=None, **kwargs) -> EvalDataset:
    """inference/utils.py:48-76 equivalent (same dataset-name dispatch,
    incl. SBD_Train = SBD train split, ADE20K val split)."""
    cls = DATASET_REGISTRY[name]
    if name == "Synthetic":
        return cls(**kwargs)
    if name == "SBD_Train":
        return cls(path, split="train", **kwargs)
    return cls(path, **kwargs)
