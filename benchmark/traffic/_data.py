"""Images and object masks made from the seed, and the fixed order in
which a mix's sizes arrive.

An object is the union of one to three ellipses whose area is a share of
the image drawn from the mix's `object_area`; images are blocky noise, a
few per size (`IMAGES`), which the objects share.
Every seed makes the same sizes in the same order (`schedule`); the seed
changes only the pixels and the shapes.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

IMAGES = 4                       # images of each size


def rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & (2 ** 63 - 1), *stream])


def object_mask(g: np.random.Generator, h: int, w: int,
                area: Sequence[float]) -> np.ndarray:
    """(h, w) float32 {0, 1}: one to three ellipses about one centre."""
    target = g.uniform(*area) * h * w
    yy = np.arange(h, dtype=np.float32)[:, None]
    xx = np.arange(w, dtype=np.float32)[None, :]
    cy, cx = g.uniform(0.25, 0.75) * h, g.uniform(0.25, 0.75) * w
    m = np.zeros((h, w), bool)
    for k in range(int(g.integers(1, 4))):
        aspect = g.uniform(0.5, 2.0)
        a = np.sqrt(target / (np.pi * aspect)) * g.uniform(0.7, 1.0)
        oy, ox = (g.normal(0.0, 0.3, 2) * a) if k else (0.0, 0.0)
        m |= (((yy - cy - oy) / (a * aspect)) ** 2
              + ((xx - cx - ox) / a) ** 2) <= 1.0
    return m.astype(np.float32)


def image(g: np.random.Generator, h: int, w: int) -> np.ndarray:
    """(h, w, 3) uint8: a colour with noise in blocks of 4 x 4 pixels."""
    noise = g.integers(0, 256, (-(-h // 4), -(-w // 4), 3), dtype=np.uint8)
    return np.ascontiguousarray(noise.repeat(4, 0).repeat(4, 1)[:h, :w])


def schedule(counts: Sequence[int]) -> List[int]:
    """A fixed interleaving of len(counts) kinds, kind i `counts[i]` times:
    smooth weighted round robin, so that every prefix holds the kinds in
    about their shares."""
    total = sum(counts)
    cur = [0.0] * len(counts)
    out = []
    for _ in range(total):
        for i, c in enumerate(counts):
            cur[i] += c
        k = max(range(len(counts)), key=lambda i: cur[i])
        cur[k] -= total
        out.append(k)
    return out


def canvas(h: int, w: int, bucket: int = 64) -> Tuple[int, int]:
    return (-(-h // bucket) * bucket, -(-w // bucket) * bucket)
