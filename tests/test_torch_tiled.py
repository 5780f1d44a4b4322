"""Tiled inference (pvpuformer_tpu_torch/inference/tiled.py) against the
JAX package's `tiled_forward`, f32 on the CPU, through the registry: a
PlainVit and a SegFormer over canvases larger than the crop (2 x 3 and
3 x 2 overlapping tiles, one batched forward each), the same weights
(tests/test_torch_zoo.py:jax_weights). Tile origins and the blend window
exact; blended logits within 2e-5 of JAX's relative to the largest (the
forwards' tolerance; measured at most 9.9e-7)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvpuformer_tpu.inference import tiled as jtiled
from pvpuformer_tpu_torch.inference import tiled
from test_torch_plainvit import tiny_plainvit
from test_torch_zoo import (ZOO_CONFIGS, family_id, jax_weights, port_family,
                            rel_err)
from test_torch_zoo import two_torch_threads  # noqa: F401 (autouse)

TOL = 2e-5


@pytest.mark.parametrize("size,crop,overlap", [
    (64, 64, 0.2), (96, 64, 0.2), (150, 64, 0.2), (150, 64, 0.5),
    (896, 448, 0.2), (1344, 448, 0.2), (1000, 448, 0.1), (449, 448, 0.3)])
def test_tile_origins_match_jax(size, crop, overlap):
    assert tiled._tile_origins(size, crop, overlap) == \
        jtiled._tile_origins(size, crop, overlap)


@pytest.mark.parametrize("hw", [(64, 64), (448, 448), (33, 70)])
def test_blend_window_matches_jax(hw):
    np.testing.assert_array_equal(tiled._blend_window(*hw),
                                  jtiled._blend_window(*hw))


def _canvas(hw, seed=0):
    r = np.random.default_rng(seed)
    img = r.uniform(size=(1, *hw, 4)).astype(np.float32)
    pts = np.full((1, 12, 3), -1.0, np.float32)
    pts[0, 0] = (20, 30, 0)                   # in the first tiles only
    pts[0, 1] = (70.5, 120.25, 2)             # in the later ones
    pts[0, 6] = (50, 80, 1)                   # in several
    pts[0, 7] = (hw[0] - 1, hw[1] - 1, 3)     # the far corner
    return img, pts


@pytest.mark.parametrize("jcfg,hw", [
    (tiny_plainvit(), (96, 150)),
    (next(c for c in ZOO_CONFIGS
          if type(c).__name__ == "SegformerISConfig"), (150, 96))],
    ids=lambda v: family_id(v) if not isinstance(v, tuple) else
    f"{v[0]}x{v[1]}")
def test_tiled_forward_matches_jax(jcfg, hw):
    params = jax_weights(jcfg)
    model, cfg = port_family(params, jcfg)
    img, pts = _canvas(hw)
    fn = jax.jit(jtiled.tiled_forward, static_argnums=(1, 4, 5))
    with jax.default_matmul_precision("highest"):
        want = np.asarray(fn(params, jcfg, jnp.asarray(img), jnp.asarray(pts),
                             (64, 64), 0.2))
    got = tiled.tiled_forward(model, cfg, torch.from_numpy(img),
                              torch.from_numpy(pts), (64, 64), 0.2)
    assert got.shape == want.shape == (1, *hw, 1)
    assert got.dtype == torch.float32
    assert rel_err(got.numpy(), want) <= TOL


def test_tiled_forward_refuses_an_image_below_the_crop():
    jcfg = tiny_plainvit()
    model, cfg = port_family(jax_weights(jcfg), jcfg)
    img, pts = _canvas((48, 80))
    with pytest.raises(ValueError, match="smaller than the crop"):
        tiled.tiled_forward(model, cfg, torch.from_numpy(img),
                            torch.from_numpy(pts), (64, 64))
