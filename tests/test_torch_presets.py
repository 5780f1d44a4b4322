"""The ViT-L and ViT-H presets of the port against the JAX package's: the
configs field by field, and the whole VPU forward at the presets' widths,
heads and patches, cut to depth 4 at a 224 crop (f32, the CPU), within
tests/test_torch_model.py's TOL (1e-4).

Depth 4 puts every block on the global grid (blocks_per_group = 1), so the
window split of patch 14 is held separately: ViT-H's 448 geometry (a 32x32
grid in 2x2 windows of 16x16 tokens) through `_patchify`, and the ViT-H
backbone at depth 8 with `window_pixels=112` (blocks 1, 3, 5 and 7 on 2x2
windows of 8x8 tokens at the 224 crop)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvpuformer_tpu.models import vit as jvit, vpu as jvpu
from pvpuformer_tpu.utils.serialization import config_to_dict, flatten_tree
from pvpuformer_tpu_torch.models import vit, vpu
from pvpuformer_tpu_torch.utils.serialization import (config_from_dict,
                                                      params_from_numpy)
from test_torch_eval import two_torch_threads  # noqa: F401
from test_torch_model import TOL, port_model

PRESETS = {"large": "vpu_large_config", "huge": "vpu_huge_config"}


def _cut(jcfg, depth, crop=(224, 224), window_pixels=112):
    bb = dataclasses.replace(jcfg.backbone, depth=depth, img_size=crop,
                             window_pixels=window_pixels)
    return jcfg.replace(backbone=bb,
                        neck=dataclasses.replace(jcfg.neck, img_size=crop))


@pytest.mark.parametrize("size", sorted(PRESETS))
def test_preset_config_matches_jax(size):
    for kw in (dict(), dict(crop=(224, 224), upsample="x2",
                            dtype=torch.bfloat16)):
        jkw = dict(kw, dtype=jnp.bfloat16) if "dtype" in kw else kw
        ours = getattr(vpu, PRESETS[size])(**kw)
        theirs = getattr(jvpu, PRESETS[size])(**jkw)
        assert config_from_dict(config_to_dict(theirs)) == ours


def test_vit_h_448_window_geometry():
    cfg = vpu.vpu_huge_config().backbone
    assert cfg.grid_size == (32, 32) and vit._window_counts(cfg) == (2, 2)
    jcfg = jvpu.vpu_huge_config().backbone
    x = np.arange(2 * 1024 * 3, dtype=np.float32).reshape(2, 1024, 3)
    w = vit._patchify(torch.from_numpy(x), cfg)
    assert w.shape == (8, 256, 3)
    np.testing.assert_array_equal(w.numpy(), np.asarray(jvit._patchify(
        jnp.asarray(x), jcfg)))
    np.testing.assert_array_equal(vit._unpatchify(w, cfg).numpy(), x)


def _inputs(crop):
    r = np.random.default_rng(0)
    img = r.uniform(size=(2,) + crop + (4,)).astype(np.float32)
    pts = np.full((2, 48, 3), -1.0, np.float32)
    pts[0, 0] = [100, 60, 0]
    pts[0, 24] = [30, 200, 1]
    pts[1, 0] = [12, 150, 0]
    pts[1, 1] = [180, 33, 2]
    return img, pts


@pytest.mark.parametrize("size", sorted(PRESETS))
def test_preset_forward_matches_jax(size):
    jcfg = _cut(getattr(jvpu, PRESETS[size])(), depth=4)
    params = jvpu.init_vpu(jax.random.key(0), jcfg)
    model, cfg = port_model(params, jcfg)
    assert cfg.backbone.embed_dim // cfg.backbone.num_heads == \
        {"large": 64, "huge": 80}[size]
    img, pts = _inputs((224, 224))
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda p, i, q: jvpu.vpu_forward(p, jcfg, i, q))(
            params, jnp.asarray(img), jnp.asarray(pts))
    with torch.no_grad():
        got = vpu.vpu_forward(model, cfg, torch.from_numpy(img),
                              torch.from_numpy(pts))
    for k in ("instances", "instances_aux"):
        assert got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **TOL)


def test_vit_h_windowed_backbone_matches_jax():
    jcfg = _cut(jvpu.vpu_huge_config(), depth=8).backbone
    cfg = config_from_dict(config_to_dict(jcfg))
    assert cfg.blocks_per_group == 2 and vit._window_counts(cfg) == (2, 2)
    params = jvit.init_vit(jax.random.key(1), jcfg)
    model = vit.ViT(cfg)
    model.load_state_dict(params_from_numpy(flatten_tree(params)))
    r = np.random.default_rng(2)
    img = r.normal(size=(2, 224, 224, 3)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda p, x: jvit.vit_backbone_forward(p, jcfg, x))(
            params, jnp.asarray(img))
    with torch.no_grad():
        got = vit.vit_backbone_forward(model, cfg, torch.from_numpy(img))
    assert got.shape == (2, 256, 1280)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
