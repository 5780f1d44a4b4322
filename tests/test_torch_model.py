"""Model layers of the port vs the JAX package at the tiny test config, f32,
on the same converted weights: ViT backbone (window and global blocks),
two-way DMA transformer, neck, head and the whole VPU forward.

Tolerance 1e-4 (absolute and relative): both sides run the same f32 math in
a different summation order, and the error grows through 4 ViT blocks, the
neck and the head (measured max ~1e-6 on the VPU logits)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvpuformer_tpu.models import fpn as jfpn, seg_head as jhead
from pvpuformer_tpu.models import two_way as jtw, vit as jvit, vpu as jvpu
from pvpuformer_tpu.utils.serialization import config_to_dict, flatten_tree
from pvpuformer_tpu_torch.models import fpn, seg_head, two_way, vit, vpu
from pvpuformer_tpu_torch.utils.serialization import (config_from_dict,
                                                      params_from_numpy)
from test_models import tiny_cfg

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    """Two intra-op threads for torch in a module that uses this fixture
    (imported by name): the suite runs in several processes at once, and
    torch's default of one thread per core in each of them oversubscribes
    the CPU (tests/test_torch_eval.py's fixture)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def port_model(jax_params, jax_cfg):
    """JAX params + config -> (port VPUModel with the same weights, config)."""
    cfg = config_from_dict(config_to_dict(jax_cfg))
    model = vpu.VPUModel(cfg)
    model.load_state_dict(params_from_numpy(flatten_tree(jax_params)))
    return model, cfg


@pytest.fixture(scope="module", params=[32, 224], ids=["window", "global"])
def models(request):
    """window_pixels=32 splits the 4x4 token grid into 2x2 windows (blocks
    1-3 windowed, block 4 global); 224 keeps every block global."""
    jcfg = tiny_cfg(window_pixels=request.param)
    params = jvpu.init_vpu(jax.random.key(0), jcfg)
    model, cfg = port_model(params, jcfg)
    return params, jcfg, model, cfg


def _np(t):
    return t.detach().numpy()


def _inputs(seed=0):
    r = np.random.default_rng(seed)
    img = r.uniform(size=(2, 64, 64, 4)).astype(np.float32)
    pts = np.full((2, 12, 3), -1.0, np.float32)
    pts[0, 0] = [20, 30, 0]
    pts[0, 6] = [40, 10, 1]
    pts[1, 0] = [5, 60, 0]
    pts[1, 1] = [33, 33, 2]
    pts[1, 6] = [50, 50, 1]
    return img, pts


def test_patchify_roundtrip_matches_jax():
    jcfg = tiny_cfg(window_pixels=32).backbone
    cfg = config_from_dict(config_to_dict(jcfg))
    x = np.arange(2 * 16 * 8, dtype=np.float32).reshape(2, 16, 8)
    w = vit._patchify(torch.from_numpy(x), cfg)
    np.testing.assert_array_equal(_np(w), np.asarray(jvit._patchify(
        jnp.asarray(x), jcfg)))
    np.testing.assert_array_equal(_np(vit._unpatchify(w, cfg)), x)


def test_vit_backbone_matches_jax(models):
    params, jcfg, model, cfg = models
    img = np.random.default_rng(1).normal(size=(2, 64, 64, 3)).astype(np.float32)
    add = np.random.default_rng(2).normal(size=(2, 16, 64)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = jvit.vit_backbone_forward(params["backbone"], jcfg.backbone,
                                         jnp.asarray(img), jnp.asarray(add))
    got = vit.vit_backbone_forward(model.backbone, cfg.backbone,
                                   torch.from_numpy(img), torch.from_numpy(add))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_vit_backbone_flash_entry_matches_jax(models):
    import dataclasses
    params, jcfg, model, cfg = models
    img = np.random.default_rng(1).normal(size=(1, 64, 64, 3)).astype(np.float32)
    jb = dataclasses.replace(jcfg.backbone, attn_impl="flash")
    with jax.default_matmul_precision("highest"):
        want = jvit.vit_backbone_forward(params["backbone"], jb,
                                         jnp.asarray(img))
    got = vit.vit_backbone_forward(
        model.backbone, dataclasses.replace(cfg.backbone, attn_impl="flash"),
        torch.from_numpy(img))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_two_way_and_neck_match_jax(models):
    params, jcfg, model, cfg = models
    r = np.random.default_rng(3)
    x = r.normal(size=(2, 16, 64)).astype(np.float32)
    q = r.normal(size=(2, 12, 64 * 2 + 3)).astype(np.float32)
    qe = r.normal(size=(2, 12, 64)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        jtw_out = jtw.two_way_forward(params["neck"]["att"], jcfg.neck.two_way,
                                      jnp.asarray(qe), jnp.asarray(x), (4, 4))
        jfeats, jq = jfpn.neck_forward(params["neck"], jcfg.neck,
                                       jnp.asarray(x), jnp.asarray(q), (4, 4))
    tw_out = two_way.two_way_forward(model.neck.att, cfg.neck.two_way,
                                     torch.from_numpy(qe), torch.from_numpy(x))
    assert len(tw_out) == len(jtw_out) == 3
    for (tq, tk), (wq, wk) in zip(tw_out, jtw_out):
        np.testing.assert_allclose(_np(tq), np.asarray(wq), **TOL)
        np.testing.assert_allclose(_np(tk), np.asarray(wk), **TOL)
    feats, q_out = fpn.neck_forward(model.neck, cfg.neck, torch.from_numpy(x),
                                    torch.from_numpy(q), (4, 4))
    np.testing.assert_allclose(_np(q_out), np.asarray(jq), **TOL)
    for got, want in zip(feats, jfeats):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_head_matches_jax(models):
    params, jcfg, model, cfg = models
    r = np.random.default_rng(4)
    feats = [r.normal(size=(2, 16 // s, 16 // s, c)).astype(np.float32)
             for s, c in zip((1, 2, 4, 8), (16, 32, 48, 64))]
    q = r.normal(size=(2, 12, 64)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        jseg, jpcl = jhead.head_forward(params["head"], jcfg.head,
                                        [jnp.asarray(f) for f in feats],
                                        jnp.asarray(q))
    seg, pcl = seg_head.head_forward(model.head, cfg.head,
                                     [torch.from_numpy(f) for f in feats],
                                     torch.from_numpy(q))
    np.testing.assert_allclose(_np(seg), np.asarray(jseg), **TOL)
    np.testing.assert_allclose(_np(pcl), np.asarray(jpcl), **TOL)


def test_vpu_forward_matches_jax(models):
    params, jcfg, model, cfg = models
    img, pts = _inputs()
    with jax.default_matmul_precision("highest"):
        want = jvpu.vpu_forward(params, jcfg, jnp.asarray(img),
                                jnp.asarray(pts))
    got = model(torch.from_numpy(img), torch.from_numpy(pts))
    for key in ("instances", "instances_aux"):
        assert tuple(got[key].shape) == want[key].shape
        np.testing.assert_allclose(_np(got[key]), np.asarray(want[key]), **TOL)


def test_vpu_forward_bf16_close_to_f32(models):
    """bf16 compute path: finite, and within bf16 noise of the f32 result."""
    _, _, model, cfg = models
    img, pts = _inputs(5)
    f32 = model(torch.from_numpy(img), torch.from_numpy(pts))["instances"]
    bmodel = vpu.VPUModel(cfg.replace(dtype=torch.bfloat16))
    bmodel.load_state_dict(model.state_dict())
    bmodel.to(torch.bfloat16)
    b16 = bmodel(torch.from_numpy(img), torch.from_numpy(pts))["instances"]
    assert b16.dtype == torch.bfloat16 and torch.isfinite(b16.float()).all()
    np.testing.assert_allclose(_np(b16.float()), _np(f32), atol=0.1, rtol=0.1)
