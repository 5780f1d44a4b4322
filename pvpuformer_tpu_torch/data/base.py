"""Training datasets: base class + synthetic dataset for tests (a copy of
pvpuformer_tpu/data/base.py: the same records from the same seeds).

The reference's `isegm/data` layer was never published (SURVEY.md); the API
is reconstructed from its call sites:
  * `trainer.py:95-96`: `get_samples_number()`;
  * `trainer.py:320-321`: batches expose {'images', 'points', 'instances'};
  * `vpu_base448_cocolvis.py:100-125`: ctor args (augmentator,
    min_object_area, keep_background_prob, points_sampler, epoch_len, ...).

A sample flows: raw (image, per-object masks) -> augmentation -> object
filter (min_object_area) -> MultiPointSampler (target mask + initial clicks)
-> scribble synthesis -> fixed-shape training record:
    image          (H, W, 3) float32 in [0, 1]
    instances      (H, W, 1) float32 {0, 1}
    points         (2N, 3)   float32 (y, x, order), -1 padded
    scribbles      (S, 2)    float32 (x, y) curve samples
    scribble_rects (4,)      float32
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from .points_sampler import MultiPointSampler
from .scribbles import cal_scribble_single
from .transforms import Compose


@dataclasses.dataclass
class TrainSample:
    image: np.ndarray                # (H, W, 3) uint8
    masks: List[np.ndarray]          # per-object (H, W) {0,1}


class ISTrainDataset:
    """Iterable-by-index dataset of fixed-shape training records."""

    def __init__(self, points_sampler: MultiPointSampler,
                 augmentator: Optional[Compose] = None,
                 min_object_area: int = 0,
                 keep_background_prob: float = 0.05,
                 epoch_len: int = -1,
                 num_scribble_samples: int = 1000,
                 seed: int = 0):
        self.points_sampler = points_sampler
        self.augmentator = augmentator
        self.min_object_area = min_object_area
        self.keep_background_prob = keep_background_prob
        self.epoch_len = epoch_len
        self.num_scribble_samples = num_scribble_samples
        self.seed = seed

    # -- subclass interface ---------------------------------------------------

    def get_samples_number(self) -> int:
        raise NotImplementedError

    def get_raw_sample(self, index: int) -> TrainSample:
        raise NotImplementedError

    # -- record assembly ------------------------------------------------------

    def __len__(self) -> int:
        return self.epoch_len if self.epoch_len > 0 \
            else self.get_samples_number()

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, index))
        n_raw = self.get_samples_number()
        raw_idx = index % n_raw if self.epoch_len <= 0 \
            else int(rng.integers(0, n_raw))
        sample = self.get_raw_sample(raw_idx)

        image = sample.image
        # stack first, single cast after (copy=False: every dataset impl
        # already emits int32 masks — per-mask astype was a pure memcpy)
        masks = np.stack(sample.masks).astype(np.int32, copy=False)
        if self.augmentator is not None:
            for _ in range(8):          # retry until a valid object survives
                aug_img, aug_masks = self.augmentator(rng, image, masks)
                if self._valid(aug_masks):
                    break
            image, masks = aug_img, aug_masks

        keep = [m for m in masks if m.sum() >= max(self.min_object_area, 1)]
        if not keep:
            keep = [m for m in masks]

        points, target = self.points_sampler.sample(rng, keep)
        scr, rect = cal_scribble_single(
            rng, target, num_samples=self.num_scribble_samples)

        img_f32 = image.astype(np.float32)
        img_f32 *= np.float32(1.0 / 255.0)          # in place: one temp, not two
        return {
            "image": img_f32,
            "instances": target[..., None].astype(np.float32),
            "points": points,
            "scribbles": scr,
            "scribble_rects": rect,
        }

    def _valid(self, masks: np.ndarray) -> bool:
        ok = any(m.sum() >= max(self.min_object_area, 1) for m in masks)
        if ok:
            return True
        # keep_background_prob: accept an objectless crop occasionally
        return np.random.default_rng().uniform() < self.keep_background_prob


class SyntheticTrainDataset(ISTrainDataset):
    """Deterministic in-memory dataset (ellipses/rectangles) for tests and
    pipeline smoke runs."""

    def __init__(self, n_samples: int = 32, hw=(96, 96), n_objects: int = 2,
                 **kw):
        kw.setdefault("points_sampler", MultiPointSampler(6, prob_gamma=0.8))
        super().__init__(**kw)
        self.n = n_samples
        self.hw = hw
        self.n_objects = n_objects

    def get_samples_number(self) -> int:
        return self.n

    def get_raw_sample(self, index: int) -> TrainSample:
        r = np.random.default_rng(1000 + index)
        h, w = self.hw
        image = r.integers(0, 255, (h, w, 3), dtype=np.uint8)
        yy, xx = np.mgrid[:h, :w]
        masks = []
        for _ in range(self.n_objects):
            cy = r.integers(h // 4, 3 * h // 4)
            cx = r.integers(w // 4, 3 * w // 4)
            ry = r.integers(h // 8, h // 4)
            rx = r.integers(w // 8, w // 4)
            m = (((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1)
            masks.append(m.astype(np.int32))
            image[m] = (image[m] * 0.4 + 120).astype(np.uint8)
        return TrainSample(image=image, masks=masks)
