"""The box and scribble prompt slice of the port vs the JAX package, on the
CPU at small sizes: prompt synthesis, rasterization, the PPuE box and
scribble encoders, the predictor's prompt helpers, the prompt forward, and
whole prompt sessions against JAX `click_scan` and
tests/golden_prompt_loop.json.

torch cannot reproduce `jax.random`, so every random draw of the port is an
argument: these tests hand the port JAX's own draws (`jax_noise` below,
from the keys the JAX functions split), which makes every comparison exact.

Tolerances: integer outputs (labels, boxes, click tensors, slots) exact;
the scribble curve atol 2e-3 as the golden test (a 10-term f32 dot product
summed in another order), its rect exact; PPuE vectors 1e-6 (one exp
rounding); drawn coords exact; the prompt forward 1e-4 as
tests/test_torch_model.py (same f32 math, another summation order); session
IoU 1e-5 and probabilities 1e-5 as tests/test_torch_predictor.py."""
import itertools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvpuformer_tpu.engine import prompt_sim as jps
from pvpuformer_tpu.inference import predictor as jpred
from pvpuformer_tpu.models import vpu as jvpu
from pvpuformer_tpu.ops import ppue as jppue, rasterize as jras
from pvpuformer_tpu.utils.serialization import config_to_dict
from pvpuformer_tpu_torch.engine import prompt_sim as tps
from pvpuformer_tpu_torch.inference import predictor as tpred
from pvpuformer_tpu_torch.ops import ppue as tppue, rasterize as tras
from pvpuformer_tpu_torch.utils.serialization import config_from_dict
from test_models import tiny_cfg
from test_torch_model import port_model, two_torch_threads  # noqa: F401


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


# ---------------------------------------------------------------------------
# JAX's draws, in the layout of the port's noise arguments
# ---------------------------------------------------------------------------

def _split(key, b):
    return list(jax.random.split(key, b))


def noise_click(key, b, h, w):
    """_append_error_click: one Gumbel map per item of split(key, b)."""
    return {"click_gumbel": _t(jnp.stack([jax.random.gumbel(k, (h, w))
                                          for k in _split(key, b)]))}


def noise_scribble(key, b, w, k_ctrl=10):
    """synth_scribbles: per item krow, kcol = split(k); u, g."""
    us, gs = [], []
    for k in _split(key, b):
        krow, kcol = jax.random.split(k)
        us.append(jax.random.uniform(krow, (k_ctrl,)))
        gs.append(jax.random.gumbel(kcol, (k_ctrl, w)))
    return {"scribble_u": _t(jnp.stack(us)), "scribble_g": _t(jnp.stack(gs))}


def noise_box(key, b, h, w):
    """_box_prompt_one: per item ki, k1..k4 = split(k, 5)."""
    gs, offs = [], []
    for k in _split(key, b):
        ki, k1, k2, k3, k4 = jax.random.split(k, 5)
        gs.append(jax.random.gumbel(ki, (h, w)))
        offs.append([int(jax.random.randint(kk, (), lo, hi)) for kk, lo, hi in
                     ((k1, -10, 1), (k2, 0, 11), (k3, -10, 1), (k4, 0, 11))])
    return {"box_gumbel": _t(jnp.stack(gs)),
            "box_offsets": torch.tensor(offs, dtype=torch.int32)}


def noise_points(key, b, w):
    """_scribble_points_one: per item kr, kc = split(k); randint's own
    split of kr gives the two 32-bit draws."""
    bits, gs = [], []
    for k in _split(key, b):
        kr, kc = jax.random.split(k)
        k1, k2 = jax.random.split(kr)
        bits.append([np.asarray(jax.random.bits(kk, (7,), jnp.uint32))
                     for kk in (k1, k2)])
        gs.append(jax.random.gumbel(kc, (7, w)))
    return {"points_bits": _t(np.asarray(bits, np.int64).transpose(1, 0, 2)),
            "points_g": _t(jnp.stack(gs))}


def jax_noise(cfg, click_count):
    """The draws JAX's click_step makes at `click_count` (predictor.py:491)."""
    kb, kc = jax.random.split(jax.random.fold_in(jax.random.key(17),
                                                 click_count))
    b = 2 if cfg.with_flip else 1
    th, tw = cfg.target_size
    det = cfg.deterministic_prompts
    out = {}
    if cfg.as_multi_prompts:
        if not det:
            out.update(noise_click(kc, b, th, tw))
        if cfg.prompt_mode == 2:
            out.update(noise_scribble(kb, b, tw))
    elif not det:
        out.update(noise_box(kb, b, th, tw) if cfg.prompt_mode == 1
                   else noise_points(kb, b, tw))
    return out


@pytest.fixture
def jax_draws(monkeypatch):
    """The port's predictor draws JAX's noise, click by click."""
    counter = itertools.count(1)
    monkeypatch.setattr(tpred, "_prompt_noise",
                        lambda cfg, gen, device: jax_noise(cfg, next(counter)))


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def _ellipses(h=48, w=64):
    """gt / prev masks (2, h, w): the golden test's ellipses, and a second
    item with two gt blobs and a prediction that overshoots."""
    yy, xx = np.mgrid[:h, :w]
    ell = lambda cy, cx, ry, rx: (((yy - cy) / ry) ** 2 +  # noqa: E731
                                  ((xx - cx) / rx) ** 2) <= 1.0
    gt = np.stack([ell(22, 30, 14, 20), ell(12, 14, 8, 9) | ell(34, 48, 9, 12)])
    prev = np.stack([ell(26, 36, 12, 16), ell(20, 24, 16, 22)])
    return gt.astype(np.float32), prev.astype(np.float32) * 0.9


def _points(n=6):
    pts = np.full((2, 2 * n, 3), -1.0, np.float32)
    pts[:, 0] = (22.0, 30.0, 0.0)
    pts[:, n] = (40.0, 52.0, 1.0)
    pts[1, 1] = (10.0, 12.0, 2.0)
    return pts


KEY = jax.random.key(3)
# the JAX side, jitted: one compile instead of hundreds of eager op dispatches
_j_ppue_box = jax.jit(jppue.ppue_box, static_argnames=("cfg", "num_max_points"))
_j_ppue_scribble = jax.jit(jppue.ppue_scribble,
                           static_argnames=("cfg", "num_max_points"))
_j_synth_scribbles = jax.jit(jps.synth_scribbles,
                             static_argnames=("num_samples",))
_j_append = jax.jit(jpred._append_error_click,
                    static_argnames=("det", "pred_thresh"))
_j_rewrite_box = jax.jit(jpred._rewrite_points_box, static_argnames=("det",))
_j_rewrite_scribble = jax.jit(jpred._rewrite_points_scribble,
                              static_argnames=("det",))
_j_synth_boxes = jax.jit(jps.synth_boxes,
                         static_argnames=("as_allmask", "jitter"))
_j_box_one = jax.jit(jpred._box_prompt_one, static_argnames=("det",))
_j_draw_box = jax.jit(jras.draw_box_into_coords, static_argnums=2)
_j_draw_scribble = jax.jit(jras.draw_scribble_into_coords)
_j_forward = jax.jit(jvpu.vpu_forward, static_argnames=("cfg", "prompt_type"))


@pytest.mark.parametrize("variant", ["error_ndyn", "allmask_jitter"])
def test_synth_boxes_matches_jax(variant):
    gt, prev = _ellipses()
    gtb = gt > 0.5
    fn, fp = gtb & (prev < 0.49), ~gtb & (prev > 0.49)
    pts = _points()
    if variant == "error_ndyn":
        want = _j_synth_boxes(jnp.asarray(gt), jnp.asarray(fn),
                              jnp.asarray(fp), jnp.asarray(pts), KEY,
                              jitter=False, n_dyn=jnp.int32(2))
        got = tps.synth_boxes(_t(gt), _t(fn), _t(fp), _t(pts), jitter=False,
                              n_dyn=torch.tensor(2, dtype=torch.int32))
    else:
        want = _j_synth_boxes(jnp.asarray(gt), jnp.asarray(fn),
                              jnp.asarray(fp), jnp.asarray(pts), KEY,
                              as_allmask=True)
        offs = []
        for k in _split(KEY, 2):
            k1, k2, k3, k4 = jax.random.split(k, 4)
            offs.append([int(jax.random.randint(kk, (), lo, hi)) for kk, lo, hi
                         in ((k1, -10, 1), (k2, 0, 11), (k3, -10, 1),
                             (k4, 0, 11))])
        got = tps.synth_boxes(_t(gt), _t(fn), _t(fp), _t(pts),
                              torch.tensor(offs, dtype=torch.int32),
                              as_allmask=True)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_synth_scribbles_matches_jax():
    gt, _ = _ellipses()
    scr, rects = _j_synth_scribbles(jnp.asarray(gt), KEY, num_samples=1000)
    n = noise_scribble(KEY, 2, gt.shape[-1])
    got_scr, got_rects = tps.synth_scribbles(_t(gt), n["scribble_u"],
                                             n["scribble_g"], num_samples=1000)
    np.testing.assert_array_equal(got_rects.numpy(), np.asarray(rects))
    np.testing.assert_allclose(got_scr.numpy(), np.asarray(scr), atol=2e-3)


def _prompt_inputs():
    r = np.random.default_rng(0)
    pts = _points()
    boxes = np.array([[40, 30, 30, 20, 7], [20, 20, 9, 30, 0]], np.float32)
    scr = np.stack([np.sort(r.uniform(0, 64, 300)), r.uniform(0, 48, 300)],
                   -1)[None].repeat(2, 0).astype(np.float32)
    rects = np.array([[30, 22, 40, 28], [20, 20, 9, 31]], np.float32)
    coords = (r.uniform(size=(2, 48, 64, 2)) > 0.9).astype(np.float32)
    return pts, boxes, scr, rects, coords


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ppue_box_and_scribble_match_jax(dtype):
    pts, boxes, scr, rects, _ = _prompt_inputs()
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jcfg, tcfg = jppue.PPuEConfig(48, 64), tppue.PPuEConfig(48, 64)
    want = _j_ppue_box(jnp.asarray(pts, jdt), jnp.asarray(boxes, jdt), jcfg,
                       num_max_points=8)
    got = tppue.ppue_box(_t(pts, tdt), _t(boxes, tdt), tcfg, num_max_points=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    want = _j_ppue_scribble(jnp.asarray(pts, jdt), jnp.asarray(scr, jdt),
                            jnp.asarray(rects, jdt), jcfg, num_max_points=8)
    got = tppue.ppue_scribble(_t(pts, tdt), _t(scr, tdt), _t(rects, tdt), tcfg,
                              num_max_points=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_draw_into_coords_matches_jax(dtype):
    pts, boxes, scr, _, coords = _prompt_inputs()
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = _j_draw_box(jnp.asarray(coords, jdt), jnp.asarray(boxes), 6)
    got = tras.draw_box_into_coords(_t(coords, tdt), _t(boxes), 6)
    assert got.dtype == tdt                   # a bf16 forward stays bf16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    want = _j_draw_scribble(jnp.asarray(coords, jdt), jnp.asarray(scr))
    got = tras.draw_scribble_into_coords(_t(coords, tdt), _t(scr))
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def test_randint_from_bits_matches_jax():
    key = jax.random.key(11)
    for maxval in (1, 2, 3, 7, 64, 1000, 70000):
        k1, k2 = jax.random.split(key)
        bits = _t(np.stack([np.asarray(jax.random.bits(k, (50,), jnp.uint32))
                            for k in (k1, k2)]).astype(np.int64))
        want = jax.random.randint(key, (50,), 0, maxval)
        got = tpred._randint_from_bits(bits, 0, torch.tensor(maxval))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        key = jax.random.fold_in(key, maxval)


@pytest.mark.parametrize("det", [True, False], ids=["det", "random"])
def test_append_error_click_matches_jax(det):
    gt, prev = _ellipses()
    pts = _points()
    for n_dyn in (2, 1):
        want = _j_append(jnp.asarray(prev), jnp.asarray(gt), jnp.asarray(pts),
                         jnp.int32(n_dyn), KEY, det=det, pred_thresh=0.49)
        g = None if det else noise_click(KEY, 2, 48, 64)["click_gumbel"]
        got = tpred._append_error_click(_t(prev), _t(gt), _t(pts),
                                        torch.tensor(n_dyn), g, 0.49)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("det", [True, False], ids=["det", "random"])
def test_box_prompt_and_rewrite_match_jax(det):
    gt, _ = _ellipses()
    gtb = gt > 0.5
    pts = _points()
    noise = noise_box(KEY, 2, 48, 64)
    bp, ok = tpred._box_prompt_one(_t(gtb), noise, det)
    for i, k in enumerate(_split(KEY, 2)):
        want, wok = _j_box_one(jnp.asarray(gtb[i]), k, det=det)
        np.testing.assert_array_equal(bp[i].numpy(), np.asarray(want))
        assert bool(ok[i]) == bool(wok)
    for first in (True, False):
        want = _j_rewrite_box(jnp.asarray(pts), jnp.asarray(gtb), KEY,
                              jnp.int32(2), jnp.asarray(first), det=det)
        got = tpred._rewrite_points_box(_t(pts), _t(gtb), noise,
                                        torch.tensor(2, dtype=torch.int32),
                                        torch.tensor(first), det)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("det", [True, False], ids=["det", "random"])
def test_rewrite_points_scribble_matches_jax(det):
    gt, _ = _ellipses()
    gtb = gt > 0.5
    pts = _points()
    noise = noise_points(KEY, 2, 64)
    for first, n_dyn in ((True, 2), (False, 2), (False, 5)):
        want = _j_rewrite_scribble(
            jnp.asarray(pts), jnp.asarray(gtb), KEY, jnp.int32(n_dyn),
            jnp.asarray(first), det=det)
        got = tpred._rewrite_points_scribble(
            _t(pts), _t(gtb), noise, torch.tensor(n_dyn, dtype=torch.int32),
            torch.tensor(first), det)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the prompt forward and whole sessions (tiny config, converted weights)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    jcfg = tiny_cfg()
    params = jvpu.init_vpu(jax.random.key(0), jcfg)
    return params, jcfg, port_model(params, jcfg)[0]


@pytest.mark.parametrize("prompt_type", [1, 2])
def test_vpu_forward_prompt_types_match_jax(weights, prompt_type):
    params, jcfg, model = weights
    r = np.random.default_rng(1)
    img = r.uniform(size=(2, 64, 64, 4)).astype(np.float32)
    pts = _points()
    extra = pts.copy()
    extra[:, 1] = (30.0, 40.0, 3.0)
    boxes = np.array([[30, 30, 24, 20, 1], [20, 40, 30, 16, 7]], np.float32)
    scr = np.stack([np.linspace(10, 50, 1000), np.linspace(12, 40, 1000)],
                   -1)[None, None].repeat(2, 0).astype(np.float32)
    rects = np.array([[[30, 26, 40, 28]]] * 2, np.float32)
    kw = dict(boxes=boxes, scribbles=None) if prompt_type == 1 else \
        dict(boxes=None, scribbles=(scr, rects))
    with jax.default_matmul_precision("highest"):
        want = _j_forward(
            params, jcfg, jnp.asarray(img), jnp.asarray(pts),
            boxes=None if kw["boxes"] is None else jnp.asarray(boxes),
            scribbles=None if kw["scribbles"] is None else
            (jnp.asarray(scr), jnp.asarray(rects)),
            prompt_type=prompt_type, ppue_points=jnp.asarray(extra))
    got = model(_t(img), _t(pts),
                boxes=None if kw["boxes"] is None else _t(boxes),
                scribbles=None if kw["scribbles"] is None else
                (_t(scr), _t(rects)),
                prompt_type=prompt_type, ppue_points=_t(extra))
    for key in ("instances", "instances_aux"):
        np.testing.assert_allclose(got[key].detach().numpy(),
                                   np.asarray(want[key]), atol=1e-4, rtol=1e-4)


VARIANTS = [(1, True), (1, False), (2, True), (2, False)]


def _sample():
    r = np.random.default_rng(7)
    image = (r.uniform(size=(60, 90, 3)) * 255).astype(np.uint8)
    gt = np.zeros((60, 90), np.float32)
    gt[14:50, 18:46] = 1.0
    gt[14:16, 18:46] = -1.0                                  # an ignore band
    return image, gt


@pytest.mark.parametrize("mode,multi", VARIANTS,
                         ids=[f"mode{m}_{'multi' if x else 'points'}"
                              for m, x in VARIANTS])
def test_prompt_session_matches_jax_click_scan(weights, jax_draws, mode, multi):
    """Random prompts (deterministic_prompts=False), JAX's draws injected."""
    params, jcfg, model = weights
    kw = dict(target_size=(64, 64), min_crop_size=32, prompt_mode=mode,
              as_multi_prompts=multi)
    jcfg_p = jpred.PredictorConfig(model=jcfg, **kw)
    cfg = config_from_dict(config_to_dict(jcfg_p))
    image, gt = _sample()
    with jax.default_matmul_precision("highest"):
        jst, jious = jpred.click_scan(params, jcfg_p, jpred.init_session(
            image, gt, jcfg.num_max_points, (64, 128)), 4)
    tst, tious = tpred.click_scan(model, cfg, tpred.init_session(
        image, gt, jcfg.num_max_points, (64, 128), device="cpu"), 4)
    np.testing.assert_array_equal(tst.points.numpy(), np.asarray(jst.points))
    np.testing.assert_allclose(tious.numpy(), np.asarray(jious), atol=1e-5)
    np.testing.assert_allclose(tst.prev_probs.numpy(),
                               np.asarray(jst.prev_probs), atol=1e-5)


def test_golden_prompt_sessions_through_the_port(weights, monkeypatch):
    """tests/golden_prompt_loop.json's four sessions (deterministic prompts;
    the multi-prompt scribble still draws, from JAX's keys) and its fixed
    synthesis pins, through the port."""
    golden = json.load(open(Path(__file__).parent / "golden_prompt_loop.json"))
    _, jcfg, model = weights
    mcfg = config_from_dict(config_to_dict(jcfg))
    r = np.random.default_rng(7)
    image = (r.uniform(size=(64, 64, 3)) * 255).astype(np.uint8)
    gt = np.zeros((64, 64), np.float32)
    gt[14:50, 18:46] = 1.0
    for name, mode, multi in (("mode1_multi", 1, True),
                              ("mode1_points", 1, False),
                              ("mode2_multi", 2, True),
                              ("mode2_points", 2, False)):
        counter = itertools.count(1)
        monkeypatch.setattr(tpred, "_prompt_noise", lambda cfg, gen, device:
                            jax_noise(cfg, next(counter)))
        pred = tpred.Predictor(model, tpred.PredictorConfig(
            model=mcfg, target_size=(64, 64), min_crop_size=32,
            prompt_mode=mode, as_multi_prompts=multi,
            deterministic_prompts=True), device="cpu")
        pred.set_input(image, gt)
        ious, means = [], []
        for _ in range(4):
            ious.append(pred.next_click())
            means.append(float(pred.probs.mean()))
        want = golden["sessions"][name]
        np.testing.assert_allclose(ious, want["ious"], atol=1e-4, err_msg=name)
        np.testing.assert_allclose(means, want["prob_means"], atol=1e-4,
                                   err_msg=name)
        np.testing.assert_allclose(pred.clicks, np.asarray(want["clicks"]),
                                   atol=1e-4, err_msg=name)

    # the synthesis pins (scripts/regen_goldens.py:_synth_golden), item 0
    syn = golden["synth"]
    g, p = _ellipses()
    gt1, prev1 = g[:1], p[:1]
    gtb = gt1 > 0.5
    pts = _points()[:1]
    n2 = torch.tensor(2, dtype=torch.int32)
    checks = {
        "boxes": tps.synth_boxes(_t(gt1), _t(gtb & (prev1 < 0.49)),
                                 _t(~gtb & (prev1 > 0.49)), _t(pts),
                                 jitter=False, n_dyn=n2),
        "error_click_points": tpred._append_error_click(
            _t(prev1), _t(gt1), _t(pts), n2, None, 0.49),
        "rewrite_box_first": tpred._rewrite_points_box(
            _t(pts), _t(gtb), {}, n2, torch.tensor(True), True),
        "rewrite_box_later": tpred._rewrite_points_box(
            _t(pts), _t(gtb), {}, n2, torch.tensor(False), True),
        "rewrite_scribble_first": tpred._rewrite_points_scribble(
            _t(pts), _t(gtb), {}, n2, torch.tensor(True), True),
        "rewrite_scribble_later": tpred._rewrite_points_scribble(
            _t(pts), _t(gtb), {}, n2, torch.tensor(False), True),
    }
    n = noise_scribble(KEY, 1, 64)
    scr, rects = tps.synth_scribbles(_t(gt1), n["scribble_u"], n["scribble_g"])
    checks["scribble_rects"], checks["scribble_curve"] = rects, scr
    for key, got in checks.items():
        atol = 2e-3 if key == "scribble_curve" else 1e-4
        np.testing.assert_allclose(got.numpy().astype(np.float64),
                                   np.asarray(syn[key], np.float64),
                                   atol=atol, err_msg=key)
