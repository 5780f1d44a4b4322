"""The port's user-click path, session controller and demo helpers vs the
JAX package's, tiny config, f32, the same converted weights:
`user_click_step` / `Predictor.user_click`, `InteractiveController` in
tests/test_controller.py's scenarios, `demo.ViewTransform` and
`demo_widgets.validate_bounded`.

Tolerances: every state field but the probabilities exact (points, slots,
counters, not_clicked, ROI); probabilities and IoU within 1e-5 (the same
f32 math in another summation order); result masks and panels exact."""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvpuformer_tpu.inference import predictor as jpred
from pvpuformer_tpu.inference.controller import (InteractiveController as
                                                 JController)
from pvpuformer_tpu.inference.predictor import PredictorConfig as JConfig
from pvpuformer_tpu.utils.serialization import config_to_dict
from pvpuformer_tpu_torch import demo, demo_widgets
from pvpuformer_tpu_torch.inference import predictor as tpred
from pvpuformer_tpu_torch.inference.brs import FeatureBRSPredictor
from pvpuformer_tpu_torch.inference.controller import InteractiveController
from pvpuformer_tpu_torch.utils.serialization import config_from_dict
from test_torch_eval import eval_weights
from test_torch_eval import two_torch_threads  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import demo as jdemo                                    # noqa: E402
import demo_widgets as jdemo_widgets                    # noqa: E402


@pytest.fixture(scope="module")
def weights():
    params, jcfg, model = eval_weights()
    jpc = JConfig(model=jcfg, target_size=(64, 64), min_crop_size=32)
    return params, jpc, model, config_from_dict(config_to_dict(jpc))


def _image(seed=0, hw=(64, 64)):
    r = np.random.default_rng(seed)
    return (r.uniform(size=hw + (3,)) * 255).astype(np.uint8)


# (y, x, positive): non-integer and border coordinates; 8 positive clicks
# overflow the 6 positive slots (the last slot is overwritten), then a
# negative click
CLICKS = [(20.7, 30.2, True), (40.5, 12.99, False), (0.0, 63.0, True),
          (33.3, 33.3, True), (10.5, 50.5, True), (55.9, 5.1, True),
          (5.0, 5.0, True), (62.2, 44.4, True), (30.0, 31.0, True),
          (47.0, 20.0, False)]


def _user_clicks_both(weights, clicks, ties=False):
    """`clicks` through JAX's user_click_step and the port's from one
    seeded session; every state field equal after each round (prev_probs
    and the IoU within 1e-5). With `ties`, a pixel whose probability lies
    within 1e-5 of the threshold may fall on either side of it: the
    masks must then agree everywhere else, and the port's IoU must be
    that of its own mask. Returns the port's last state."""
    params, jpc, model, cfg = weights
    image = _image(1, (60, 90))
    gt = np.zeros((60, 90), np.float32)
    gt[14:50, 18:46] = 1.0
    jst = jpred.init_session(image, gt, 6, (64, 128))
    st = tpred.init_session(image, gt, 6, (64, 128), device="cpu")
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    for y, x, pos in clicks:
        with jax.default_matmul_precision("highest"):
            jst, jiou = jpred.user_click_step(
                jparams, jpc, jst, jnp.asarray(y), jnp.asarray(x),
                jnp.asarray(pos))
        with torch.no_grad():
            st, iou = tpred.user_click_step(
                model, cfg, st, torch.tensor(y), torch.tensor(x),
                torch.tensor(pos))
        for name in st._fields:
            got = getattr(st, name).numpy()
            want = np.asarray(getattr(jst, name))
            if name == "prev_probs":
                np.testing.assert_allclose(got, want, atol=1e-5)
            else:
                np.testing.assert_array_equal(got, want, err_msg=name)
        if ties:
            thr, g = cfg.prob_thresh, st.gt.numpy()
            mine = st.prev_probs[0, ..., 0].numpy() > thr
            jp = np.asarray(jst.prev_probs)[0, ..., 0]
            differ = mine != (jp > thr)
            assert (np.abs(jp[differ] - thr) <= 1e-5).all()
            inter = (mine & (g == 1)).sum()
            union = ((mine | (g == 1)) & (g != -1)).sum()
            np.testing.assert_allclose(float(iou), inter / max(union, 1),
                                       atol=1e-6)
        else:
            np.testing.assert_allclose(float(iou), float(jiou), atol=1e-5)
    return st


def test_user_click_step_matches_jax(weights):
    st = _user_clicks_both(weights, CLICKS)
    assert int(st.num_pos) == 8 and int(st.num_neg) == 2
    assert tuple(st.points[0, 5]) == (30.0, 31.0, 8.0)     # the last slot
    assert tuple(st.points[0, 0]) == (20.0, 30.0, 0.0)     # truncated


def test_user_click_step_off_canvas_matches_jax(weights):
    """A person may click off the (64, 128) canvas: a negative coord counts
    from the end and one past the edge clears nothing, as JAX's
    `.at[cy, cx].set` does; -0.5 truncates to 0. The slots keep the coords
    as given. The last round leaves one pixel 6e-7 either side of the
    threshold on the two sides (0.48999986 here, 0.49000043 in JAX), a tie
    that the IoU check allows for."""
    st = _user_clicks_both(weights, [(-3.0, 5.0, True), (70.0, 200.0, False),
                                     (-0.5, 10.0, True), (30.0, -129.0, True)],
                           ties=True)
    assert tuple(st.points[0, 0]) == (-3.0, 5.0, 0.0)
    assert tuple(st.points[0, 6]) == (70.0, 200.0, 1.0)
    assert not bool(st.not_clicked[61, 5])
    assert int((~st.not_clicked).sum()) == 2


def test_predictor_user_click_no_grad_and_undo(weights):
    """A server thread has grad mode on: the user click turns it off, so
    the undo stack holds no autograd graph."""
    _, _, model, cfg = weights
    pred = tpred.Predictor(model, cfg, device="cpu")
    pred.set_input(_image(), np.zeros((64, 64), np.float32))
    with torch.enable_grad():
        model.backbone.patch_embed.w.requires_grad_(True)
        try:
            assert pred.user_click(20.5, 30.5, True) == 0.0
            pred.user_click(40, 40, False)
        finally:
            model.backbone.patch_embed.w.requires_grad_(False)
    assert pred.state.prev_probs.grad_fn is None
    assert all(s.prev_probs.grad_fn is None for s in pred._undo)
    pred.undo_click()
    assert int(pred.state.click_count) == 1


def _controllers(weights, **kw):
    params, jpc, model, cfg = weights
    jc = JController(params, jpc, **kw)
    c = InteractiveController(model, cfg, device="cpu", **kw)
    for ctl in (jc, c):
        ctl.set_image(_image())
    return jc, c


def _same(jc, c, probs_tol=1e-5):
    assert len(c.clicks_list) == len(jc.clicks_list)
    assert [(k.is_positive, k.coords) for k in c.clicks_list] == \
        [(k.is_positive, k.coords) for k in jc.clicks_list]
    assert c.object_count == jc.object_count
    np.testing.assert_allclose(c.current_object_prob,
                               jc.current_object_prob, atol=probs_tol)
    np.testing.assert_array_equal(c.result_mask, jc.result_mask)
    assert c.result_mask.dtype == np.uint16


def _run(ctl, script):
    with jax.default_matmul_precision("highest"):
        for op, *args in script:
            getattr(ctl, op)(*args)


SCENARIOS = {
    "click_undo_finish": [("add_click", 30, 20, True),
                          ("add_click", 50, 40, False), ("undo_click",),
                          ("finish_object",), ("add_click", 10, 10, True),
                          ("add_click", 12.5, 40.7, False)],
    "init_mask": [("set_mask", "square"), ("add_click", 16, 16, True)],
    "net_clicks_limit": [("add_click", 20, 20, True),
                         ("set_net_clicks_limit", None),
                         ("set_net_clicks_limit", 1),
                         ("add_click", 20, 20, True),
                         ("add_click", 40, 40, False)],
    "brs_switch": [("add_click", 30, 20, True), ("finish_object",),
                   ("add_click", 10, 12, True), ("set_brs_mode", "f-BRS-C"),
                   ("add_click", 40, 44, True), ("undo_click",),
                   ("add_click", 44, 40, True), ("set_brs_mode", "NoBRS"),
                   ("add_click", 40, 44, False)],
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_controller_matches_jax(weights, name):
    jc, c = _controllers(weights)
    square = np.zeros((64, 64), np.float32)
    square[8:24, 8:24] = 1.0
    script = [(op, square) if args == ["square"] else (op, *args)
              for op, *args in SCENARIOS[name]]
    for step in range(len(script)):
        op = script[step][0]
        if op == "set_brs_mode":
            for ctl in (jc, c):
                _run(ctl, [script[step]])
                ctl.predictor.max_iters = 2
            continue
        pred0 = c.predictor
        _run(jc, [script[step]])
        _run(c, [script[step]])
        if op == "set_net_clicks_limit":
            assert (c.predictor is pred0) == (script[step][1] is None)
        _same(jc, c)
    if name == "brs_switch":
        assert c.object_count == 1 and len(c.clicks_list) == 1
    if name == "init_mask":
        assert len(c.clicks_list) == 1
    panel = c.get_visualization()
    assert panel.shape == (64, 64, 3) and panel.dtype == np.uint8
    np.testing.assert_array_equal(panel, jc.get_visualization())


def test_controller_brs_mode_builds_brs_predictor(weights):
    _, c = _controllers(weights)
    c.set_brs_mode("f-BRS-C")
    assert isinstance(c.predictor, FeatureBRSPredictor)
    c.set_mask(np.zeros((64, 64), np.float32))
    assert c.current_object_prob.max() == 0.0
    with pytest.raises(ValueError):
        c.set_mask(np.zeros((32, 32), np.float32))


def test_controller_int8_shares_one_quantized_copy(weights):
    _, _, model, cfg = weights
    c = InteractiveController(model, cfg, device="cpu", int8=True)
    q = c.int8_model
    assert q is not None and c.predictor.model is q
    c.set_image(_image())
    c.add_click(30, 20, True)
    c.set_brs_mode("f-BRS-C")
    assert c.predictor.model is model           # BRS keeps the float model
    c.set_brs_mode("NoBRS")
    assert c.predictor.model is q
    c2 = InteractiveController(model, cfg, device="cpu", int8=True,
                               int8_model=q)
    assert c2.predictor.model is q


def test_view_transform_matches_jax():
    """demo.ViewTransform (canvas.py:49-324 equivalent) against the
    repository demo's, op by op, and tests/test_controller.py's checks."""
    t = demo.ViewTransform((100, 200), (400, 300))
    jt = jdemo.ViewTransform((100, 200), (400, 300))
    assert abs(t.scale - 2.0) < 1e-9
    assert t.to_image(100, 100) == (50.0, 50.0)
    before = t.to_image(120, 80)
    ops = [("zoom", 2.0, 120, 80), ("pan", -10000, -10000),
           ("zoom", 0.01, 0, 0), ("zoom", 3.0, 300, 10), ("pan", 40, -7)]
    for i, (op, *args) in enumerate(ops):
        getattr(t, op)(*args)
        getattr(jt, op)(*args)
        assert (t.zoom_level, t.ox, t.oy) == (jt.zoom_level, jt.ox, jt.oy)
        if i == 0:
            assert np.allclose(before, t.to_image(120, 80), atol=1e-6)
            assert t.zoom_level == 2.0
        if i == 1:
            assert t.ox == max(0.0, t.iw - t.vw / t.scale)
        if i == 2:
            assert t.zoom_level == t.min_zoom
    for p in [(-5, 10), (0, 0), (399, 299), (120, 80)]:
        assert t.to_image(*p) == jt.to_image(*p)
    assert demo.ViewTransform((100, 100), (200, 300)).to_image(199, 299) \
        is None
    panel = np.random.default_rng(0).integers(0, 255, (100, 200, 3),
                                              dtype=np.uint8)
    np.testing.assert_array_equal(t.render(panel), jt.render(panel))


@pytest.mark.parametrize("args", [
    ("5", int, 1, 96), ("0", int, 1, 96), ("97", int, 1, 96),
    ("abc", int, 1, 96), ("2.5", int, 1, 96), ("0.3", float, 0.0, 1.0),
    ("INF", int, 1, 96, True), ("INF", int, 1, 96), ("-4", int)])
def test_validate_bounded_matches_jax(args):
    assert demo_widgets.validate_bounded(*args) == \
        jdemo_widgets.validate_bounded(*args)
