"""MultiPointSampler — initial click synthesis for training batches
(a copy of pvpuformer_tpu/data/points_sampler.py: the same numpy draws in the
same order, so points and targets are identical).

The reference imports `isegm.data.points_sampler.MultiPointSampler`, which was
never published (SURVEY.md §2); its ctor signature is fixed by the shipped
config (`vpu_base448_cocolvis.py:96-98`: max_num_points=24, prob_gamma=0.80,
merge_objects_prob=0.15, max_num_merged_objects=2) and its output contract by
the trainer (`trainer.py:320`: batch['points'] is (B, 2N, 3) of
(y, x, order), positives in the first N slots, padding = -1).

Behavior follows the RITM-lineage conventions the class name implies
(documented spec, validated by training convergence — SURVEY §7):
  * the number of positive clicks k is drawn with P(k) ∝ gamma^k,
    k in [1, max_points]; negatives likewise in [0, max_points];
  * with prob `merge_objects_prob` up to `max_num_merged_objects` objects are
    merged into one target mask;
  * the first positive click is sampled from the eroded object interior
    (stable seed click), later positives uniformly from the object;
  * negatives are sampled from a mix of: the whole background, other
    objects, and a border band around the target (expand_ratio).
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np


def _generate_probs(max_num_points: int, gamma: float) -> np.ndarray:
    probs = gamma ** np.arange(max_num_points, dtype=np.float64)
    return probs / probs.sum()


def _erode(mask: np.ndarray, iters: int) -> np.ndarray:
    m = mask.copy()
    for _ in range(iters):
        p = np.pad(m, 1)
        m = (p[:-2, 1:-1] & p[2:, 1:-1] & p[1:-1, :-2] & p[1:-1, 2:]
             & p[1:-1, 1:-1])
    return m


def _dilate(mask: np.ndarray, iters: int) -> np.ndarray:
    m = mask.copy()
    for _ in range(iters):
        p = np.pad(m, 1)
        m = (p[:-2, 1:-1] | p[2:, 1:-1] | p[1:-1, :-2] | p[1:-1, 2:]
             | p[1:-1, 1:-1])
    return m


def _sample_from(rng: np.random.Generator, mask: np.ndarray,
                 k: int) -> List[Tuple[int, int]]:
    ys, xs = np.nonzero(mask)
    if len(ys) == 0 or k <= 0:
        return []
    idx = rng.integers(0, len(ys), size=k)
    return [(int(ys[i]), int(xs[i])) for i in idx]


class MultiPointSampler:
    def __init__(self, max_num_points: int, prob_gamma: float = 0.7,
                 expand_ratio: float = 0.1,
                 positive_erode_prob: float = 0.9,
                 positive_erode_iters: int = 3,
                 negative_bg_prob: float = 0.1,
                 negative_other_prob: float = 0.4,
                 negative_border_prob: float = 0.5,
                 merge_objects_prob: float = 0.0,
                 max_num_merged_objects: int = 2):
        self.max_num_points = max_num_points
        self._pos_probs = _generate_probs(max_num_points, prob_gamma)
        self._neg_probs = _generate_probs(max_num_points + 1, prob_gamma)
        self.expand_ratio = expand_ratio
        self.positive_erode_prob = positive_erode_prob
        self.positive_erode_iters = positive_erode_iters
        self.neg_strategy_probs = np.array(
            [negative_bg_prob, negative_other_prob, negative_border_prob])
        self.neg_strategy_probs /= self.neg_strategy_probs.sum()
        self.merge_objects_prob = merge_objects_prob
        self.max_num_merged_objects = max_num_merged_objects

    # -- object selection ---------------------------------------------------

    def select_object(self, rng: np.random.Generator,
                      masks: Sequence[np.ndarray]
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """masks: per-object binary masks. Returns (target, others_union)."""
        n = len(masks)
        assert n > 0
        take = 1
        if n > 1 and rng.uniform() < self.merge_objects_prob:
            take = int(rng.integers(2, min(self.max_num_merged_objects, n) + 1))
        order = rng.permutation(n)
        target = np.zeros_like(masks[0], bool)
        others = np.zeros_like(masks[0], bool)
        for j, oi in enumerate(order):
            if j < take:
                target |= masks[oi].astype(bool)
            else:
                others |= masks[oi].astype(bool)
        return target, others

    # -- click sampling -------------------------------------------------------

    def _positive_points(self, rng, target: np.ndarray) -> List[Tuple[int, int]]:
        k = 1 + int(rng.choice(self.max_num_points, p=self._pos_probs))
        k = min(k, self.max_num_points)
        inner = target
        if rng.uniform() < self.positive_erode_prob:
            eroded = _erode(target, self.positive_erode_iters)
            if eroded.any():
                inner = eroded
        pts = _sample_from(rng, inner, 1)            # seed from interior
        pts += _sample_from(rng, target, k - 1)
        return pts[:k]

    def _negative_points(self, rng, target: np.ndarray,
                         others: np.ndarray) -> List[Tuple[int, int]]:
        k = int(rng.choice(self.max_num_points + 1, p=self._neg_probs))
        if k == 0:
            return []
        h, w = target.shape
        band_iters = max(1, int(self.expand_ratio *
                                math.sqrt(max(target.sum(), 1))))
        border = _dilate(target, band_iters) & ~target
        bg = ~target & ~others
        pools = [bg, others & ~target, border]
        pts: List[Tuple[int, int]] = []
        for _ in range(k):
            strat = rng.choice(3, p=self.neg_strategy_probs)
            pool = pools[strat]
            if not pool.any():
                pool = bg
            if not pool.any():
                break
            pts += _sample_from(rng, pool, 1)
        return pts

    def sample(self, rng: np.random.Generator, masks: Sequence[np.ndarray]
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (points (2N, 3) float32, target mask (H, W) float32)."""
        target, others = self.select_object(rng, masks)
        if not target.any():                         # degenerate sample
            n = self.max_num_points
            return np.full((2 * n, 3), -1.0, np.float32), \
                target.astype(np.float32)

        pos = self._positive_points(rng, target)
        neg = self._negative_points(rng, target, others)

        n = self.max_num_points
        points = np.full((2 * n, 3), -1.0, np.float32)
        for i, (y, x) in enumerate(pos[:n]):
            points[i] = (y, x, i)
        for i, (y, x) in enumerate(neg[:n]):
            points[n + i] = (y, x, len(pos) + i)
        return points, target.astype(np.float32)
