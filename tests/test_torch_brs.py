"""The port's BRS predictors (pvpuformer_tpu_torch/inference/brs.py) vs the
JAX package's, tiny config, f32, the same converted weights.

Tolerances: `brs_mask_loss` and `click_maps` exact; each objective's value
and gradient with respect to the optimized vector at fixed points within
1e-5 (absolute, and relative to the gradient's largest entry), fed the
same trunk outputs and click maps (both sides run the same f32 math in
another summation order); whole sessions of 3 clicks at max_iters=3 (the
evaluation tests' weights, whose logit bias is lowered so that the
prediction moves): the same clicks, IoU within 1e-3 and probabilities
within 1e-4 (measured on the CPU: IoU at most 1.07e-4 apart, one
pixel of f-BRS-B's mask at the threshold, probabilities 3e-7: the L-BFGS
steps of the two sides differ in the last bits of their gradients)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvpuformer_tpu.inference import brs as jbrs
from pvpuformer_tpu.inference.predictor import PredictorConfig as JConfig
from pvpuformer_tpu.models.vpu import init_vpu as jax_init_vpu
from pvpuformer_tpu.utils.serialization import config_to_dict
from pvpuformer_tpu_torch.inference import brs
from pvpuformer_tpu_torch.inference.predictor import Predictor
from pvpuformer_tpu_torch.utils.serialization import config_from_dict
from test_models import tiny_cfg
from test_torch_eval import eval_weights
from test_torch_eval import two_torch_threads  # noqa: F401 (autouse)
from test_torch_model import port_model

TOL = 1e-5
SESSION_IOU_TOL = 1e-3
MODES = ["f-BRS-A", "f-BRS-B", "f-BRS-C", "RGB-BRS", "DistMap-BRS"]


@pytest.fixture(scope="module")
def weights():
    jcfg = tiny_cfg(window_pixels=32)
    params = jax_init_vpu(jax.random.key(0), jcfg)
    model, mcfg = port_model(params, jcfg)
    jpc = JConfig(model=jcfg, target_size=(64, 64), min_crop_size=32)
    return params, jpc, model, config_from_dict(config_to_dict(jpc))


def _np(t):
    return t.detach().cpu().numpy()


def test_brs_mask_loss_exact():
    r = np.random.default_rng(0)
    res = r.uniform(size=(1, 64, 64)).astype(np.float32)
    pos = (r.uniform(size=(1, 64, 64)) < 0.05).astype(np.float32)
    neg = (r.uniform(size=(1, 64, 64)) < 0.05).astype(np.float32)
    want = jbrs.brs_mask_loss(jnp.asarray(res), jnp.asarray(pos),
                              jnp.asarray(neg))
    got = brs.brs_mask_loss(torch.from_numpy(res), torch.from_numpy(pos),
                            torch.from_numpy(neg))
    for a, b in zip(got, want):
        assert _np(a) == np.asarray(b)
    # the JAX test's hand-computed case
    got = brs.brs_mask_loss(torch.tensor([[0.9, 0.2], [0.6, 0.1]]),
                            torch.tensor([[1.0, 0.0], [0.0, 0.0]]),
                            torch.tensor([[0.0, 1.0], [0.0, 0.0]]))
    np.testing.assert_allclose(float(got[0]), (0.1 ** 2) / (1 + 1e-5)
                               + (0.2 ** 2) / (1 + 1e-5), rtol=1e-5)


def test_click_maps_exact():
    r = np.random.default_rng(1)
    pts = np.full((2, 12, 3), -1.0, np.float32)
    pts[:, :4, :2] = r.uniform(-2, 66, size=(2, 4, 2))
    pts[:, :4, 2] = [0, 1, 2, 3]
    pts[:, 6:9, :2] = r.uniform(0, 63, size=(2, 3, 2)).round()
    pts[:, 6:9, 2] = [4, 5, 6]
    pts[0, 0] = (0, 63, 0)                    # a stamp on the border
    want = jbrs.click_maps(jnp.asarray(pts), 64, 64)
    got = brs.click_maps(torch.from_numpy(pts), 64, 64)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_np(a), np.asarray(b))


def _round_inputs(seed=0):
    """A flip pair of crops (prev-mask channel included) and its clicks."""
    r = np.random.default_rng(seed)
    crop = r.uniform(size=(1, 64, 64, 4)).astype(np.float32)
    crop = np.concatenate([crop, crop[:, :, ::-1]], 0)
    pts = np.full((1, 12, 3), -1.0, np.float32)
    pts[0, 0] = (20, 30, 0)
    pts[0, 1] = (40.5, 12.25, 2)
    pts[0, 6] = (50, 50, 1)
    flip = pts.copy()
    flip[..., 1] = np.where(pts[..., 2] >= 0, 63 - pts[..., 1], -1.0)
    return crop, np.concatenate([pts, flip], 0)


def _assert_close(loss, grad, jloss, jgrad):
    np.testing.assert_allclose(float(loss), float(jloss), rtol=TOL, atol=TOL)
    jg = np.asarray(jgrad)
    np.testing.assert_allclose(_np(grad), jg, rtol=TOL,
                               atol=TOL * max(np.abs(jg).max(), 1e-3))


@pytest.mark.parametrize("insertion", ["tokens", "neck", "head"])
def test_feature_objectives_match_jax(weights, insertion):
    params, jpc, model, cfg = weights
    crop, pts = _round_inputs()
    with jax.default_matmul_precision("highest"):
        jtok, jpv = jbrs._backbone_tokens(params, jpc.model, jnp.asarray(crop),
                                          jnp.asarray(pts))
        tok, pv = brs._backbone_tokens(model, cfg.model,
                                       torch.from_numpy(crop),
                                       torch.from_numpy(pts))
        np.testing.assert_allclose(_np(tok), np.asarray(jtok), atol=1e-4,
                                   rtol=1e-4)
        pos, neg = jbrs.click_maps(jnp.asarray(pts), 64, 64)
        tpos, tneg = (torch.tensor(np.asarray(m)) for m in (pos, neg))
        kw = dict(reg_weight=1e-3, reg_bias_weight=10.0, with_flip=True,
                  th=64, tw=64)
        ttok, tpv = torch.tensor(np.asarray(jtok)), \
            torch.tensor(np.asarray(jpv))
        if insertion == "tokens":
            jres, res = (jtok, jpv), (ttok, tpv)
            jgrad, fn = jbrs._scale_bias_grad, brs._scale_bias_objective
            size = 2 * 64
        elif insertion == "neck":
            jres = jbrs._neck_feats(params, jpc.model, jtok, jpv)
            res = (tuple(torch.tensor(np.asarray(m)) for m in jres[0]),
                   torch.tensor(np.asarray(jres[1])))
            jgrad, fn = jbrs._neck_grad, brs._neck_objective
            size = 2 * (16 + 32 + 48 + 64)
        else:
            jres = (jbrs._head_fused(params, jpc.model, jtok, jpv),)
            res = (torch.tensor(np.asarray(jres[0])),)
            jgrad, fn = jbrs._head_grad, brs._head_objective
            size = 2 * 32
        r = np.random.default_rng(2)
        for opt in (np.zeros(size, np.float32),
                    (r.normal(size=size) * 0.1).astype(np.float32)):
            (jloss, (jlog, jfp, jfn)), jg = jgrad(
                params, jpc.model, *jres, jnp.asarray(opt), pos, neg, **kw)
            (loss, (log, fp, fn_)), g = brs.value_and_grad(
                fn, model, cfg.model, *res, torch.from_numpy(opt), tpos,
                tneg, *kw.values(), argnum=2 + len(res))
            _assert_close(loss, g, jloss, jg)
            np.testing.assert_allclose(_np(log), np.asarray(jlog), atol=1e-5)
            np.testing.assert_allclose([float(fp), float(fn_)],
                                       [float(jfp), float(jfn)], atol=1e-6)


@pytest.mark.parametrize("target", ["rgb", "dmaps"])
def test_input_objectives_match_jax(weights, target):
    params, jpc, model, cfg = weights
    crop, pts = _round_inputs(3)
    nch = 3 if target == "rgb" else 2
    r = np.random.default_rng(4)
    kw = dict(reg_weight=1e-3, with_flip=True, th=64, tw=64, target=target)
    with jax.default_matmul_precision("highest"):
        pos, neg = jbrs.click_maps(jnp.asarray(pts), 64, 64)
        for delta in (np.zeros(64 * 64 * nch, np.float32),
                      (r.normal(size=64 * 64 * nch) * 0.05).astype(
                          np.float32)):
            (jloss, (jlog, _, _)), jg = jbrs._input_grad(
                params, jpc.model, jnp.asarray(crop), jnp.asarray(pts),
                jnp.asarray(delta), pos, neg, **kw)
            (loss, (log, _, _)), g = brs.value_and_grad(
                brs._input_objective, model, cfg.model,
                torch.from_numpy(crop), torch.from_numpy(pts),
                torch.from_numpy(delta), torch.tensor(np.asarray(pos)),
                torch.tensor(np.asarray(neg)), *kw.values(), argnum=4)
            _assert_close(loss, g, jloss, jg)
            np.testing.assert_allclose(_np(log), np.asarray(jlog), atol=1e-4)


def _sample():
    r = np.random.default_rng(0)
    image = (r.uniform(size=(64, 64, 3)) * 255).astype(np.uint8)
    gt = np.zeros((64, 64), np.float32)
    gt[16:48, 20:52] = 1.0
    return image, gt


@pytest.fixture(scope="module")
def session_weights():
    params, jcfg, model = eval_weights()
    jpc = JConfig(model=jcfg, target_size=(64, 64), min_crop_size=32)
    return params, jpc, model, config_from_dict(config_to_dict(jpc))


@pytest.mark.parametrize("mode", MODES)
def test_brs_session_matches_jax(session_weights, mode):
    params, jpc, model, cfg = session_weights
    image, gt = _sample()
    jpred = jbrs.get_predictor(params, jpc, mode, max_iters=3)
    pred = brs.get_predictor(model, cfg, mode, max_iters=3, device="cpu")
    with jax.default_matmul_precision("highest"):
        jpred.set_input(image, gt)
        jious = [jpred.next_click() for _ in range(3)]
    pred.set_input(image, gt)
    ious = [pred.next_click() for _ in range(3)]
    np.testing.assert_array_equal(pred.clicks, np.asarray(jpred.clicks))
    np.testing.assert_allclose(ious, jious, atol=SESSION_IOU_TOL)
    np.testing.assert_allclose(pred.probs, np.asarray(jpred.probs),
                               atol=1e-4)
    if mode.startswith("f-BRS"):
        assert pred.opt_data.shape == jpred.opt_data.shape
    pred.undo_click()
    assert int(pred.state.click_count) == 2


def test_brs_user_click_matches_jax(weights):
    """The GUI path through f-BRS-C: user clicks are rounded to the nearest
    pixel (the fused predictor truncates them)."""
    params, jpc, model, cfg = weights
    image, _ = _sample()
    gt = np.zeros((64, 64), np.float32)
    jpred = jbrs.get_predictor(params, jpc, "f-BRS-C", max_iters=2)
    pred = brs.get_predictor(model, cfg, "f-BRS-C", max_iters=2,
                             device="cpu")
    clicks = [(20.6, 30.4, True), (44.5, 40.5, False), (10.2, 50.7, True)]
    with jax.default_matmul_precision("highest"):
        jpred.set_input(image, gt)
        for y, x, p in clicks:
            jpred.user_click(y, x, p)
    pred.set_input(image, gt)
    for y, x, p in clicks:
        assert pred.user_click(y, x, p) == 0.0
    np.testing.assert_array_equal(pred.clicks, np.asarray(jpred.clicks))
    assert tuple(pred.clicks[0, :2]) == (21.0, 30.0)
    np.testing.assert_allclose(pred.probs, np.asarray(jpred.probs), atol=1e-3)


def test_factory(weights):
    _, _, model, cfg = weights
    assert isinstance(brs.get_predictor(model, cfg, device="cpu"), Predictor)
    kinds = {"f-BRS-A": "tokens", "f-BRS-B": "neck", "f-BRS-C": "head"}
    for mode, ins in kinds.items():
        p = brs.get_predictor(model, cfg, mode, device="cpu")
        assert type(p) is brs.FeatureBRSPredictor and p.insertion == ins
    for mode, target in (("RGB-BRS", "rgb"), ("DistMap-BRS", "dmaps")):
        p = brs.get_predictor(model, cfg, mode, device="cpu")
        assert isinstance(p, brs.InputBRSPredictor)
        assert p.optimize_target == target
    with pytest.raises(ValueError, match="NoBRS only"):
        brs.get_predictor(model, cfg, "f-BRS-A", int8=True, device="cpu")
    with pytest.raises(ValueError, match="unknown BRS mode"):
        brs.get_predictor(model, cfg, "X-BRS", device="cpu")
    # a family without an f-BRS insertion map (here a stand-in class that
    # only shares HRNet's name) is refused as JAX refuses it; the zoo's own
    # insertion maps are held in tests/test_torch_zoo_brs.py
    zoo = type("HRNetISConfig", (), {})()
    with pytest.raises(ValueError, match="no insertion map for HRNetISConfig"):
        brs.get_predictor(model, cfg.__class__(model=zoo), "f-BRS-A",
                          device="cpu")


def test_brs_runs_on_the_card_by_default(weights, monkeypatch):
    _, _, model, cfg = weights
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        brs.get_predictor(model, cfg, "RGB-BRS")
