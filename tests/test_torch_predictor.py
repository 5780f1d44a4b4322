"""The slice end to end: the port's interactive click session vs JAX
`click_scan` from the same converted weights (tiny config, f32).

Click sequences must be identical and per-click IoU within 1e-5; the golden
click trajectory of tests/golden_click_loop.json is reproduced through the
port with the golden test's own weights and inputs."""
import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvpuformer_tpu.inference import predictor as jpred
from pvpuformer_tpu.models.vpu import init_vpu as jax_init_vpu
from pvpuformer_tpu.utils.serialization import config_to_dict
from pvpuformer_tpu_torch.inference import predictor as tpred
from pvpuformer_tpu_torch.utils.serialization import config_from_dict
from test_models import tiny_cfg
from test_torch_model import port_model


@pytest.fixture(scope="module")
def weights():
    jcfg = tiny_cfg(window_pixels=32)
    params = jax_init_vpu(jax.random.key(0), jcfg)
    return params, jcfg, port_model(params, jcfg)[0]


def _sample(seed, hw, box):
    r = np.random.default_rng(seed)
    image = (r.uniform(size=hw + (3,)) * 255).astype(np.uint8)
    gt = np.zeros(hw, np.float32)
    gt[box[0]:box[1], box[2]:box[3]] = 1.0
    gt[box[0]:box[0] + 2, box[2]:box[3]] = -1.0           # an ignore band
    return image, gt


SAMPLES = [(_sample(7, (60, 90), (14, 50, 18, 46)), (64, 128)),
           (_sample(3, (64, 64), (5, 40, 30, 60)), (64, 64))]
VARIANTS = {
    "default": {},
    "cascade_clicks_limit_noflip": dict(cascade_step=2, cascade_clicks=2,
                                        net_clicks_limit=2, with_flip=False),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_click_scan_matches_jax(weights, variant):
    params, jcfg, model = weights
    kw = dict(target_size=(64, 64), min_crop_size=32, **VARIANTS[variant])
    jcfg_p = jpred.PredictorConfig(model=jcfg, **kw)
    cfg = config_from_dict(config_to_dict(jcfg_p))
    assert isinstance(cfg, tpred.PredictorConfig)
    samples = SAMPLES if variant == "default" else SAMPLES[:1]
    for (image, gt), canvas in samples:
        with jax.default_matmul_precision("highest"):
            jst, jious = jpred.click_scan(params, jcfg_p, jpred.init_session(
                image, gt, jcfg.num_max_points, canvas), 5)
        tst, tious = tpred.click_scan(model, cfg, tpred.init_session(
            image, gt, jcfg.num_max_points, canvas), 5)
        np.testing.assert_array_equal(tst.points.numpy(),
                                      np.asarray(jst.points))
        np.testing.assert_allclose(tious.numpy(), np.asarray(jious), atol=1e-5)
        np.testing.assert_array_equal(tst.roi.numpy(), np.asarray(jst.roi))
        assert int(tst.click_count) == int(jst.click_count) == 5
        np.testing.assert_allclose(tst.prev_probs.numpy(),
                                   np.asarray(jst.prev_probs), atol=1e-5)


def test_golden_click_trajectory_through_the_port():
    """tests/test_predictor.py::test_golden_click_trajectory's own setup
    (JAX init_vpu(key(0)) weights, converted) driven through the port."""
    golden = json.load(open(Path(__file__).parent / "golden_click_loop.json"))
    jcfg = tiny_cfg()
    model, mcfg = port_model(jax_init_vpu(jax.random.key(0), jcfg), jcfg)
    pred = tpred.Predictor(model, tpred.PredictorConfig(
        model=mcfg, target_size=(64, 64), min_crop_size=32))
    r = np.random.default_rng(7)
    image = (r.uniform(size=(64, 64, 3)) * 255).astype(np.uint8)
    gt = np.zeros((64, 64), np.float32)
    gt[14:50, 18:46] = 1.0
    pred.set_input(image, gt)
    ious = [pred.next_click() for _ in range(5)]
    np.testing.assert_allclose(ious, golden["ious"], atol=1e-4)
    np.testing.assert_allclose(pred.clicks, np.asarray(golden["clicks"]),
                               atol=1e-4)


def test_update_roi_zooms_like_jax(weights):
    """A confident blob + clicks inside and outside the old ROI: the ROI
    decision (bbox expand, half-to-even rounding, stamping of valid clicks,
    IoU-gated recompute) equals JAX's."""
    _, jcfg, _ = weights
    jcfg_p = jpred.PredictorConfig(model=jcfg, target_size=(64, 64),
                                   min_crop_size=10)
    cfg = config_from_dict(config_to_dict(jcfg_p))
    image, gt = _sample(1, (50, 70), (10, 30, 20, 45))
    for pts_rows, old_roi, has_roi in (
            ([[12, 22, 0], [44, 60, 1]], [0, 49, 0, 69], True),
            ([[12, 22, 0]], [10, 20, 10, 20], True),
            ([[3, 3, 0]], [0, 0, 0, 0], False)):
        jst = jpred.init_session(image, gt, 6, (64, 128))
        probs = np.zeros((1, 64, 128, 1), np.float32)
        probs[0, 15:33, 25:41, 0] = 0.9
        points = np.full((1, 12, 3), -1.0, np.float32)
        points[0, :len(pts_rows)] = pts_rows
        jst = jst._replace(prev_probs=jnp.asarray(probs),
                           roi=jnp.asarray(old_roi, jnp.int32),
                           has_roi=jnp.asarray(has_roi),
                           click_count=jnp.asarray(len(pts_rows), jnp.int32))
        want, _ = jpred._update_roi(jcfg_p, jst, jnp.asarray(points))
        tst = tpred.init_session(image, gt, 6, (64, 128))._replace(
            prev_probs=torch.from_numpy(probs),
            roi=torch.tensor(old_roi, dtype=torch.int32),
            has_roi=torch.tensor(has_roi),
            click_count=torch.tensor(len(pts_rows), dtype=torch.int32))
        got, _ = tpred._update_roi(cfg, tst, torch.from_numpy(points))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_predictor_session_surface(weights):
    _, jcfg, model = weights
    mcfg = config_from_dict(config_to_dict(jcfg))
    pred = tpred.Predictor(model, tpred.PredictorConfig(
        model=mcfg, target_size=(64, 64), canvas_bucket=32, min_crop_size=32))
    image, gt = SAMPLES[0][0]
    pred.set_input(image, gt)
    assert tuple(pred.state.image.shape) == (1, 64, 96, 3)
    ious = pred.run_clicks(3)
    assert ious.shape == (3,) and np.all((ious >= 0) & (ious <= 1))
    iou = pred.next_click()
    assert 0.0 <= iou <= 1.0 and int(pred.state.click_count) == 4
    pred.undo_click()
    assert int(pred.state.click_count) == 3
    assert pred.probs.shape == (60, 90) and pred.clicks.shape == (12, 3)
    with pytest.raises(NotImplementedError, match="prompt_mode"):
        tpred.Predictor(model, dataclasses.replace(pred.cfg, prompt_mode=1))
