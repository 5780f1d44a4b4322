"""BRS on the model families (pvpuformer_tpu_torch/inference/brs.py)
against the JAX package's, f32 on the CPU, the same weights
(tests/test_torch_zoo.py:jax_weights; HRNet's classifier bias lowered so
its masks follow the clicks, `hrnet_session_weights`).

`ZooFeatureBRSPredictor` at HRNet's A and C and DeepLab's after_c4,
after_aspp and after_deeplab insertions: the trunk's feature map within
1e-4 relative to its largest entry, the objective's value and its gradient
with respect to the scale / bias within 1e-5 (absolute, and relative to the
gradient's largest entry), at zero and at a random point, fed the same
trunk outputs and click maps (the tolerances of tests/test_torch_brs.py).
`InputBRSPredictor` (RGB and DistMap targets) on PlainVit and HRNet through
the registry's forward: the same. Sessions of 3 clicks at max_iters 3
(f-BRS-A on HRNet and DeepLab, f-BRS-C on HRNet, RGB-BRS on PlainVit,
DistMap-BRS on HRNet): identical clicks, IoU within 1e-3 and probabilities
within 1e-4 (tests/test_torch_brs.py's session tolerances: the L-BFGS steps
of the two sides differ in the last bits of their gradients)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvpuformer_tpu.inference import brs as jbrs
from pvpuformer_tpu.inference.predictor import PredictorConfig as JConfig
from pvpuformer_tpu.models.zoo.deeplab import DeeplabISConfig
from pvpuformer_tpu.models.zoo.hrnet import HRNetISConfig
from pvpuformer_tpu.utils.serialization import config_to_dict
from pvpuformer_tpu_torch.inference import brs
from pvpuformer_tpu_torch.utils.serialization import config_from_dict
from test_torch_plainvit import tiny_plainvit
from test_torch_zoo import (hrnet_session_weights, jax_weights, port_family,
                            rel_err)
from test_torch_zoo import two_torch_threads  # noqa: F401 (autouse)

TOL = 1e-5
SESSION_IOU_TOL = 1e-3
HRNET = HRNetISConfig(width=8, small=True, ocr_width=16, num_max_points=6)
DEEPLAB = DeeplabISConfig(ch=32, num_max_points=6)


def _weights(jcfg):
    params = hrnet_session_weights(jcfg) if isinstance(jcfg, HRNetISConfig) \
        else jax_weights(jcfg, seed=1)
    model, _ = port_family(params, jcfg)
    jpc = JConfig(model=jcfg, target_size=(64, 64), min_crop_size=32)
    return params, jpc, model, config_from_dict(config_to_dict(jpc))


@pytest.fixture(scope="module")
def hrnet():
    return _weights(HRNET)


@pytest.fixture(scope="module")
def deeplab():
    return _weights(DEEPLAB)


@pytest.fixture(scope="module")
def plainvit():
    return _weights(tiny_plainvit())


def _np(t):
    return t.detach().cpu().numpy()


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


@pytest.mark.parametrize("family,insertion", [
    ("hrnet", "A"), ("hrnet", "C"), ("deeplab", "after_c4"),
    ("deeplab", "after_aspp"), ("deeplab", "after_deeplab")])
def test_zoo_feature_objectives_match_jax(request, family, insertion):
    params, jpc, model, cfg = request.getfixturevalue(family)
    crop, pts = _round_inputs()
    kw = dict(reg_weight=1e-3, reg_bias_weight=10.0, with_flip=True,
              th=64, tw=64)
    with jax.default_matmul_precision("highest"):
        jfeat, jrest = jbrs._zoo_trunk(params, jpc.model, jnp.asarray(crop),
                                       jnp.asarray(pts), insertion=insertion)
        feat, rest = brs._zoo_trunk(model, cfg.model, torch.from_numpy(crop),
                                    torch.from_numpy(pts), insertion)
        assert rel_err(_np(feat), np.asarray(jfeat)) <= 1e-4
        assert len(rest) == len(jrest)
        for a, b in zip(rest, jrest):
            assert rel_err(_np(a), np.asarray(b)) <= 1e-4
        pos, neg = jbrs.click_maps(jnp.asarray(pts), 64, 64)
        tpos, tneg = (torch.tensor(np.asarray(m)) for m in (pos, neg))
        tfeat = torch.tensor(np.asarray(jfeat))
        trest = tuple(torch.tensor(np.asarray(x)) for x in jrest)
        grad = jbrs._make_feature_grad(jbrs._ZOO_TAILS[insertion])
        tail = brs._ZOO_TAILS[insertion]
        size = 2 * jfeat.shape[-1]
        r = np.random.default_rng(2)
        for opt in (np.zeros(size, np.float32),
                    (r.normal(size=size) * 0.1).astype(np.float32)):
            (jloss, (jlog, jfp, jfn)), jg = grad(
                params, jpc.model, jfeat, jrest, jnp.asarray(opt), pos, neg,
                *kw.values())
            (loss, (log, fp, fn_)), g = brs.value_and_grad(
                brs._zoo_objective, tail, model, tfeat, trest,
                torch.from_numpy(opt), tpos, tneg, *kw.values(), argnum=4)
            _assert_close(loss, g, jloss, jg)
            np.testing.assert_allclose(_np(log), np.asarray(jlog), atol=1e-5)
            np.testing.assert_allclose([float(fp), float(fn_)],
                                       [float(jfp), float(jfn)], atol=1e-6)


@pytest.mark.parametrize("family,target", [
    ("plainvit", "rgb"), ("plainvit", "dmaps"), ("hrnet", "rgb"),
    ("hrnet", "dmaps")])
def test_input_objectives_match_jax(request, family, target):
    params, jpc, model, cfg = request.getfixturevalue(family)
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


@pytest.mark.parametrize("family,mode", [
    ("hrnet", "f-BRS-A"), ("hrnet", "f-BRS-C"), ("deeplab", "f-BRS-A"),
    ("plainvit", "RGB-BRS"), ("hrnet", "DistMap-BRS")])
def test_brs_session_matches_jax(request, family, mode):
    params, jpc, model, cfg = request.getfixturevalue(family)
    image, gt = _sample()
    jpred = jbrs.get_predictor(params, jpc, mode, max_iters=3)
    pred = brs.get_predictor(model, cfg, mode, max_iters=3, device="cpu")
    assert type(pred).__name__ == type(jpred).__name__
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
        assert pred.insertion == jpred.insertion
        assert pred.opt_data.shape == jpred.opt_data.shape
    assert pred.evaluations > 0
    pred.undo_click()
    assert int(pred.state.click_count) == 2


def test_factory_insertion_maps(hrnet, deeplab):
    """get_predictor's letter -> insertion maps (JAX brs.py:640-682):
    HRNet A / A / C, DeepLab after_c4 / after_aspp / after_deeplab."""
    want = {"hrnet": ("A", "A", "C"),
            "deeplab": ("after_c4", "after_aspp", "after_deeplab")}
    for (_, _, model, cfg), name in ((hrnet, "hrnet"), (deeplab, "deeplab")):
        for mode, ins in zip(("f-BRS-A", "f-BRS-B", "f-BRS-C"), want[name]):
            p = brs.get_predictor(model, cfg, mode, device="cpu")
            assert type(p) is brs.ZooFeatureBRSPredictor
            assert p.insertion == ins
    with pytest.raises(ValueError, match="insertion 'tokens'"):
        brs.ZooFeatureBRSPredictor(hrnet[2], hrnet[3], insertion="tokens",
                                   device="cpu")
