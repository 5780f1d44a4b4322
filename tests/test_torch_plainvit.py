"""The port's PlainVit / SimpleClick model (pvpuformer_tpu_torch/models/
plainvit.py) against the JAX package's, f32 on the CPU, on the same weights
(the JAX `init_plainvit` tree with numpy-drawn leaves,
tests/test_torch_zoo.py:jax_weights).

Tolerances: the forward within 2e-5 of the jitted JAX forward relative to
the largest logit (measured at most 1.1e-6); `click_scan` sessions with
identical click slots, ROI and counts, per-click IoU within 1e-5 and
probabilities within 1e-5 (measured: IoU 0); the batched mode's curves and
clicks equal to sequential sessions' (f32 with flip, the batched =
sequential rule of tests/test_torch_batched.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvpuformer_tpu.inference import predictor as jpred
from pvpuformer_tpu.models.fpn import NeckConfig as JNeck
from pvpuformer_tpu.models.plainvit import (PlainVitConfig as JPlainVit,
                                           plainvit_forward as
                                           jax_plainvit_forward)
from pvpuformer_tpu.models.seg_head import HeadConfig as JHead
from pvpuformer_tpu.models.vit import ViTConfig as JViT
from pvpuformer_tpu.utils.serialization import config_to_dict, flatten_tree
from pvpuformer_tpu_torch.inference import predictor as tpred
from pvpuformer_tpu_torch.inference.batched import BatchedEvaluator
from pvpuformer_tpu_torch.inference.datasets import get_dataset
from pvpuformer_tpu_torch.inference.evaluation import evaluate_dataset
from pvpuformer_tpu_torch.models import registry
from pvpuformer_tpu_torch.models.plainvit import (PlainVitConfig,
                                                 PlainVitModel, init_plainvit,
                                                 plainvit_forward)
from pvpuformer_tpu_torch.utils.serialization import (config_from_dict,
                                                      torch_name)
from test_torch_zoo import (_session_sample, forward_inputs, jax_weights,
                            port_family, rel_err)
from test_torch_zoo import two_torch_threads  # noqa: F401 (autouse)

FWD_TOL = 2e-5


def tiny_plainvit(window_pixels: int = 32) -> JPlainVit:
    """Depth 4 (JAX's ViT takes depths in multiples of 4) at 64 x 64: with
    window_pixels 32 blocks 1-3 run on 2 x 2 windows of the 4 x 4 token
    grid and block 4 is global; with 224 every block is global."""
    return JPlainVit(
        backbone=JViT(img_size=(64, 64), patch_size=(16, 16), embed_dim=64,
                      depth=4, num_heads=2, window_pixels=window_pixels),
        neck=JNeck(in_dim=64, out_dims=(16, 32, 48, 64), img_size=(64, 64),
                   hide_dim=64),
        head=JHead(in_channels=(16, 32, 48, 64), channels=32, d_model=64,
                   ed_loss=False),
        num_max_points=6)


@pytest.fixture(scope="module", params=[32, 224], ids=["window", "global"])
def weights(request):
    jcfg = tiny_plainvit(request.param)
    params = jax_weights(jcfg)
    model, cfg = port_family(params, jcfg)
    return params, jcfg, model, cfg


def test_tree_matches_jax_init():
    """The port's module has the JAX tree: every leaf name and shape of
    `init_plainvit` (no prompt FFN, no two-way transformer, no P2CL),
    nothing more; the default config is ViT-B@448."""
    jcfg = tiny_plainvit()
    want = {torch_name(k): tuple(v.shape)
            for k, v in flatten_tree(jax_weights(jcfg)).items()}
    model = init_plainvit(config_from_dict(config_to_dict(jcfg)),
                          torch.Generator().manual_seed(0), "cpu")
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == want
    assert not any(k.startswith(("neck.ffn", "neck.att", "head.ffn"))
                   for k in got)
    full = PlainVitConfig()
    assert full.backbone.img_size == (448, 448)
    assert (full.backbone.embed_dim, full.backbone.depth) == (768, 12)


def test_forward_matches_jax(weights):
    params, jcfg, model, cfg = weights
    img, pts = forward_inputs()
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda p, i, q: jax_plainvit_forward(p, jcfg, i, q))(
            params, jnp.asarray(img), jnp.asarray(pts))
    with torch.no_grad():
        got = plainvit_forward(model, cfg, torch.from_numpy(img),
                               torch.from_numpy(pts))
    assert got["instances_aux"] is None and want["instances_aux"] is None
    w = np.asarray(want["instances"])
    assert got["instances"].shape == w.shape == (2, 64, 64, 1)
    assert rel_err(got["instances"].numpy(), w) <= FWD_TOL


def test_forward_ignores_prompt_keywords_and_takes_coord_bias(weights):
    """JAX's keyword set (boxes, scribbles, prompt_type, ppue_points) is
    accepted and ignored; `coord_bias` moves the disks (DistMap-BRS)."""
    _, _, model, cfg = weights
    img, pts = forward_inputs()
    x, q = torch.from_numpy(img), torch.from_numpy(pts)
    with torch.no_grad():
        base = plainvit_forward(model, cfg, x, q)["instances"]
        same = registry.forward_for(cfg)(
            model, cfg, x, q, boxes=torch.zeros(2, 5), scribbles=None,
            prompt_type=1, ppue_points=q)["instances"]
        bias = torch.full((2, 64, 64, 2), 0.5)
        moved = plainvit_forward(model, cfg, x, q, coord_bias=bias)
    assert torch.equal(base, same)
    assert not torch.equal(base, moved["instances"])


@pytest.mark.parametrize("flip", [True, False], ids=["flip", "noflip"])
def test_click_scan_matches_jax(weights, flip):
    params, jcfg, model, _ = weights
    jpc = jpred.PredictorConfig(model=jcfg, target_size=(64, 64),
                                min_crop_size=32, with_flip=flip)
    cfg = config_from_dict(config_to_dict(jpc))
    assert isinstance(cfg.model, PlainVitConfig)
    image, gt = _session_sample()
    with jax.default_matmul_precision("highest"):
        jst, jious = jpred.click_scan(params, jpc, jpred.init_session(
            image, gt, 6, (64, 128)), 5)
    tst, tious = tpred.click_scan(model, cfg, tpred.init_session(
        image, gt, 6, (64, 128), device="cpu"), 5)
    np.testing.assert_array_equal(tst.points.numpy(), np.asarray(jst.points))
    np.testing.assert_allclose(tious.numpy(), np.asarray(jious), atol=1e-5)
    np.testing.assert_array_equal(tst.roi.numpy(), np.asarray(jst.roi))
    assert int(tst.click_count) == int(jst.click_count) == 5
    np.testing.assert_allclose(tst.prev_probs.numpy(),
                               np.asarray(jst.prev_probs), atol=1e-5)


def test_batched_mode_runs_plainvit_as_sequential(weights):
    """PlainVit has a ViT backbone, so the batched mode takes it: B = 2
    over Synthetic, every curve equal to the sequential session's."""
    _, _, model, cfg = weights
    pcfg = tpred.PredictorConfig(model=cfg, target_size=(64, 64),
                                 min_crop_size=32)
    ds = get_dataset("Synthetic", n_samples=3, hw=(64, 64))
    seq, _ = evaluate_dataset(ds, tpred.Predictor(model, pcfg, device="cpu"),
                              max_iou_thr=0.95, max_clicks=3)
    bat, _, _ = BatchedEvaluator(model, pcfg, batch_size=2,
                                 device="cpu").evaluate(ds, max_clicks=3,
                                                        max_iou_thr=0.95)
    assert len(seq) == len(bat) > 0
    for a, b in zip(seq, bat):
        np.testing.assert_array_equal(a, b)


def test_plainvit_random_split_is_refused():
    """random_split was refused until the token shuffle was ported. In JAX
    the flag is read and otherwise inert (the shuffle runs only where a
    caller passes a shuffle key), so the port builds the model and its
    forward without `shuffle_noise` is the plain one
    (tests/test_torch_caption.py holds the shuffle forward itself)."""
    cfg = config_from_dict(config_to_dict(tiny_plainvit()))
    plain = init_plainvit(cfg, torch.Generator().manual_seed(0), "cpu")
    flagged = PlainVitModel(cfg.replace(random_split=True))
    flagged.load_state_dict(plain.state_dict())
    img, pts = (torch.from_numpy(a) for a in forward_inputs())
    assert flagged.cfg.random_split
    assert torch.equal(flagged(img, pts)["instances"],
                       plain(img, pts)["instances"])
