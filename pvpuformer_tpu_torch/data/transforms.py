"""Training augmentations — numpy re-implementations of the albumentations
pipeline used by the shipped config (`models/iSegNet/vpu_base448_cocolvis.py:
82-94`): UniformRandomResize, HorizontalFlip, PadIfNeeded(border 0),
RandomCrop, RandomBrightnessContrast, RGBShift. A copy of
pvpuformer_tpu/data/transforms.py: the same draws in the same order.

Every transform maps (image uint8 (H,W,3), masks (K,H,W) int32) -> same,
geometric ops applied to both (nearest for masks), photometric to the image.

The resizes need neither cv2 nor PIL (the card's machine is not known to
have them); they reproduce what the JAX package gets from cv2.resize:
  * masks, INTER_NEAREST: source index floor(dst * (1 / (dst_len /
    src_len))) in f64, clamped to the last pixel;
  * images, INTER_LINEAR on uint8: half-pixel-centred sample positions
    in f32, per-axis weights rounded to 11 fractional bits
    (INTER_RESIZE_COEF_BITS), a horizontal pass to int32 sums, then cv2's
    vectorised vertical pass: ((S0 >> 4) * b0 >> 16) + ((S1 >> 4) * b1 >> 16),
    rounded by (+ 2) >> 2. Columns clamp at the borders with their weight
    moved onto the edge pixel; rows clamp their indices only. Bit-exact
    against cv2 5.0 (tests/test_torch_data.py).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

_COEF_BITS = 11                      # cv2 INTER_RESIZE_COEF_BITS
_ONE = 1 << _COEF_BITS


def _positions(src: int, dst: int):
    """cv2's per-axis sample position of each output index: (floor index,
    f32 fraction) of (i + 0.5) * scale - 0.5, scale = 1 / (dst / src)."""
    scale = 1.0 / (np.float64(dst) / src)
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f)
    return s.astype(np.int64), f - s


def _weights(frac: np.ndarray):
    """(1 - frac, frac) as cv2's fixed-point shorts (round half to even)."""
    w0 = np.rint((np.float32(1) - frac) * np.float32(_ONE))
    return w0.astype(np.int32), np.rint(frac * np.float32(_ONE)).astype(np.int32)


def _resize_image(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """cv2.resize(img, (w, h), INTER_LINEAR) of a uint8 (H, W, C) image."""
    src_h, src_w, c = img.shape
    sx, fx = _positions(src_w, w)
    edge = (sx < 0) | (sx >= src_w - 1)
    fx[edge] = 0                     # the border column takes all the weight
    sx = np.clip(sx, 0, src_w - 1)
    a0, a1 = _weights(fx)
    sy, fy = _positions(src_h, h)
    b0, b1 = _weights(fy)
    y0, y1 = np.clip(sy, 0, src_h - 1), np.clip(sy + 1, 0, src_h - 1)

    im = img.astype(np.int32)
    rows = im[:, sx]
    rows *= a0[None, :, None]
    nxt = im[:, np.minimum(sx + 1, src_w - 1)]
    nxt *= a1[None, :, None]
    rows += nxt
    rows >>= 4
    rows = rows.reshape(src_h, w * c)
    out = rows[y0]
    out *= b0[:, None]
    out >>= 16
    nxt = rows[y1]
    nxt *= b1[:, None]
    nxt >>= 16
    out += nxt
    out += 2
    out >>= 2
    return np.clip(out, 0, 255).astype(np.uint8).reshape(h, w, c)


def _nearest_index(src: int, dst: int) -> np.ndarray:
    scale = 1.0 / (np.float64(dst) / src)
    return np.minimum(np.floor(np.arange(dst) * scale).astype(np.int64),
                      src - 1)


def _resize_mask(mask: np.ndarray, h: int, w: int) -> np.ndarray:
    """cv2.resize(mask, (w, h), INTER_NEAREST), dtypes as the JAX package
    passes them to cv2 (uint8, int32 and float32 kept, others as int32)."""
    if mask.dtype not in (np.uint8, np.int32, np.float32):
        mask = mask.astype(np.int32)
    return mask[_nearest_index(mask.shape[0], h)[:, None],
                _nearest_index(mask.shape[1], w)[None, :]]


class Transform:
    def __call__(self, rng: np.random.Generator, image: np.ndarray,
                 masks: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError


class Compose(Transform):
    def __init__(self, transforms: Sequence[Transform], p: float = 1.0):
        self.transforms = list(transforms)
        self.p = p

    def __call__(self, rng, image, masks):
        if rng.uniform() > self.p:
            return image, masks
        for t in self.transforms:
            image, masks = t(rng, image, masks)
        return image, masks


class UniformRandomResize(Transform):
    """Scale sampled uniformly from scale_range (RITM-lineage transform)."""

    def __init__(self, scale_range=(0.9, 1.1), p: float = 1.0):
        self.scale_range = scale_range
        self.p = p

    def __call__(self, rng, image, masks):
        if rng.uniform() > self.p:
            return image, masks
        scale = rng.uniform(*self.scale_range)
        h = max(1, int(round(image.shape[0] * scale)))
        w = max(1, int(round(image.shape[1] * scale)))
        image = _resize_image(image, h, w)
        masks = np.stack([_resize_mask(m, h, w) for m in masks])
        return image, masks


class HorizontalFlip(Transform):
    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, rng, image, masks):
        if rng.uniform() > self.p:
            return image, masks
        return image[:, ::-1].copy(), masks[:, :, ::-1].copy()


class PadIfNeeded(Transform):
    """Centered zero padding to at least (min_height, min_width)
    (albumentations border_mode=0/value 0)."""

    def __init__(self, min_height: int, min_width: int, p: float = 1.0):
        self.mh = min_height
        self.mw = min_width

    def __call__(self, rng, image, masks):
        h, w = image.shape[:2]
        ph = max(0, self.mh - h)
        pw = max(0, self.mw - w)
        if ph == 0 and pw == 0:
            return image, masks
        top, left = ph // 2, pw // 2
        bot, right = ph - top, pw - left
        image = np.pad(image, ((top, bot), (left, right), (0, 0)))
        masks = np.pad(masks, ((0, 0), (top, bot), (left, right)))
        return image, masks


class RandomCrop(Transform):
    def __init__(self, height: int, width: int):
        self.h = height
        self.w = width

    def __call__(self, rng, image, masks):
        h, w = image.shape[:2]
        assert h >= self.h and w >= self.w, (h, w, self.h, self.w)
        y = int(rng.integers(0, h - self.h + 1))
        x = int(rng.integers(0, w - self.w + 1))
        return (image[y:y + self.h, x:x + self.w],
                masks[:, y:y + self.h, x:x + self.w])


class RandomBrightnessContrast(Transform):
    """albumentations formula (brightness_by_max=True):
    out = clip(img * (1 + contrast) + brightness * 255)."""

    def __init__(self, brightness_limit=(-0.25, 0.25),
                 contrast_limit=(-0.15, 0.4), p: float = 0.75):
        self.bl = brightness_limit
        self.cl = contrast_limit
        self.p = p

    def __call__(self, rng, image, masks):
        if rng.uniform() > self.p:
            return image, masks
        alpha = 1.0 + rng.uniform(*self.cl)
        beta = rng.uniform(*self.bl)
        out = image.astype(np.float32) * alpha + beta * 255.0
        return np.clip(out, 0, 255).astype(np.uint8), masks


class RGBShift(Transform):
    def __init__(self, r_shift_limit=10, g_shift_limit=10, b_shift_limit=10,
                 p: float = 0.75):
        self.limits = (r_shift_limit, g_shift_limit, b_shift_limit)
        self.p = p

    def __call__(self, rng, image, masks):
        if rng.uniform() > self.p:
            return image, masks
        shifts = np.array([rng.integers(-l, l + 1) for l in self.limits],
                          np.float32)
        out = image.astype(np.float32) + shifts[None, None, :]
        return np.clip(out, 0, 255).astype(np.uint8), masks


def train_augmentator(crop_size: Tuple[int, int]) -> Compose:
    """The shipped training pipeline (vpu_base448_cocolvis.py:82-90)."""
    return Compose([
        UniformRandomResize(scale_range=(0.75, 1.40)),
        HorizontalFlip(),
        PadIfNeeded(min_height=crop_size[0], min_width=crop_size[1]),
        RandomCrop(*crop_size),
        RandomBrightnessContrast(brightness_limit=(-0.25, 0.25),
                                 contrast_limit=(-0.15, 0.4), p=0.75),
        RGBShift(r_shift_limit=10, g_shift_limit=10, b_shift_limit=10, p=0.75),
    ])


def val_augmentator(crop_size: Tuple[int, int]) -> Compose:
    """vpu_base448_cocolvis.py:92-95."""
    return Compose([
        PadIfNeeded(min_height=crop_size[0], min_width=crop_size[1]),
        RandomCrop(*crop_size),
    ])
