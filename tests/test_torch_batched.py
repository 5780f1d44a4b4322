"""Batched sessions of the port: a real leading session axis B through
`batched_click_step`, against the port's own single sessions and against
JAX `BatchedEvaluator` (tiny config, f32, the CPU).

Curves within 2e-5 of JAX's (tests/test_batched.py's tolerance) with
identical click sequences; the port's batched sessions equal its sequential
ones exactly, object by object, over two canvas buckets and a padded chunk;
the per-session ops equal a loop of their single-session forms exactly.
Probability maps of a batch are held to 1e-6 of a lone session's (about 8
f32 ulps at 1): a CPU matmul's sums may be ordered by its row count, and a
batch of B sessions is a model batch of 2B (B without flip) where one
session is 2; clicks, IoUs, ROIs and counters are held exactly."""
import dataclasses
import itertools

import jax
import numpy as np
import pytest
import torch

from pvpuformer_tpu.inference import batched as jbatched
from pvpuformer_tpu.inference.datasets import SyntheticDataset as JSynthetic
from pvpuformer_tpu.inference import predictor as jpred
from pvpuformer_tpu.inference.predictor import PredictorConfig as JConfig
from pvpuformer_tpu.utils.serialization import config_to_dict
from pvpuformer_tpu_torch.inference import batched, graphs, predictor as tpred
from pvpuformer_tpu_torch.inference.datasets import SyntheticDataset
from pvpuformer_tpu_torch.inference.evaluation import evaluate_dataset
from pvpuformer_tpu_torch.ops import edt, resize
from pvpuformer_tpu_torch.utils.serialization import config_from_dict
from test_torch_eval import (Concat, Recording, eval_weights,  # noqa: F401
                             two_torch_threads)
from test_torch_prompts import jax_noise

CLICKS = 4


def _datasets(cls):
    """Two canvas buckets (64x64 and 64x128 at bucket 64), three and two
    objects: at B = 2 the first bucket's last chunk is padded."""
    return Concat([cls(n_samples=3, hw=(64, 64)),
                   cls(n_samples=2, hw=(40, 90), seed=5)])


@pytest.fixture(scope="module")
def setup():
    params, jcfg, model = eval_weights()
    jpc = JConfig(model=jcfg, target_size=(64, 64), min_crop_size=32)
    return params, jpc, model, config_from_dict(config_to_dict(jpc))


def _recorded_scan(monkeypatch, module, name):
    """Wrap module.name (a batched click scan) to keep each call's final
    click slots."""
    log, scan = [], getattr(module, name)

    def wrapped(*a, **kw):
        states, ious = scan(*a, **kw)
        # JAX's vmapped states keep each session's leading 1
        log.append(np.asarray(states.points).reshape(len(ious), -1, 3))
        return states, ious
    monkeypatch.setattr(module, name, wrapped)
    return log


def _batched_run(monkeypatch, module, evaluator):
    # the port's evaluator runs its chunks through graphs.click_rounds
    log = (_recorded_scan(monkeypatch, module, "batched_click_scan")
           if module is jbatched else
           _recorded_scan(monkeypatch, graphs, "click_rounds"))
    curves, _, stats = evaluator.evaluate(_datasets(
        JSynthetic if module is jbatched else SyntheticDataset),
        max_clicks=CLICKS, max_iou_thr=0.95)
    monkeypatch.undo()
    # the evaluator's order: bucket by bucket, chunk by chunk
    clicks = [c for chunk in log for c in chunk]
    return curves, clicks, stats


def test_batched_matches_sequential_and_jax(setup, monkeypatch):
    params, jpc, model, cfg = setup
    with jax.default_matmul_precision("highest"):
        jcurves, jclicks, _ = _batched_run(
            monkeypatch, jbatched, jbatched.BatchedEvaluator(params, jpc, 2))
    curves, clicks, stats = _batched_run(
        monkeypatch, batched,
        batched.BatchedEvaluator(model, cfg, 2, device="cpu"))
    seq = Recording(model, cfg, device="cpu")
    seq_curves, _ = evaluate_dataset(_datasets(SyntheticDataset), seq,
                                     max_iou_thr=0.95, max_clicks=CLICKS)
    assert len(curves) == len(jcurves) == len(seq_curves) == 5
    # 3 + 2 objects at B = 2: chunks of 2, 1 (+ 1 padding) and 2
    assert len(clicks) == len(jclicks) == 6
    for a, b in zip(clicks, jclicks):
        np.testing.assert_array_equal(a, b)
    for a, b, c in zip(curves, jcurves, seq_curves):
        np.testing.assert_allclose(a, b, atol=2e-5)
        np.testing.assert_array_equal(a, c)
    # sequential clicks in dataset order; the evaluator's bucket order is
    # the same here (bucket 64x64 first), padding dropped
    np.testing.assert_array_equal(np.stack(seq.log),
                                  np.stack(clicks[:3] + clicks[4:]))
    assert stats["objects_per_sec"] > 0 and stats["clicks_per_sec"] > 0


VARIANTS = {
    "default": {},
    "cascade_adaptive_limit_noflip": dict(
        cascade_step=3, cascade_adaptive=True, cascade_clicks=2,
        net_clicks_limit=2, with_flip=False),
}


def _assert_state_equal(got, want):
    for name, g, w in zip(tpred.SessionState._fields, got, want):
        assert g.shape == w.shape, name
        if name == "prev_probs":
            torch.testing.assert_close(g, w, atol=1e-6, rtol=0)
        else:
            assert torch.equal(g, w), name


def _states(cfg, samples, canvas=(64, 128)):
    return [tpred.init_session(s.image, s.gt_mask(0),
                               cfg.model.num_max_points, canvas, device="cpu")
            for s in samples]


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_batched_step_equals_click_step_per_session(setup, variant):
    """Every field of every session after 4 batched rounds equals its own
    click_step run, including the cascade's per-session activity."""
    _, _, model, cfg = setup
    cfg = dataclasses.replace(cfg, **VARIANTS[variant])
    ds = _datasets(SyntheticDataset)
    singles = _states(cfg, [ds.get_sample(i) for i in range(len(ds))])
    states = tpred.stack_states(singles)
    with torch.no_grad():
        states, ious = batched.batched_click_scan(model, cfg, states, CLICKS)
        for i, st in enumerate(singles):
            st, want = tpred.click_scan(model, cfg, st, CLICKS)
            np.testing.assert_array_equal(ious[i].numpy(), want.numpy())
            _assert_state_equal(tpred.session(states, i), st)


def test_reordering_sessions_permutes_results(setup):
    _, _, model, cfg = setup
    ds = _datasets(SyntheticDataset)
    singles = _states(cfg, [ds.get_sample(i) for i in range(len(ds))])
    perm = [3, 0, 4, 2, 1]
    with torch.no_grad():
        a, ia = batched.batched_click_scan(model, cfg,
                                           tpred.stack_states(singles), 3)
        b, ib = batched.batched_click_scan(
            model, cfg, tpred.stack_states([singles[i] for i in perm]), 3)
    assert torch.equal(ia[perm], ib)
    for i, j in enumerate(perm):
        _assert_state_equal(tpred.session(b, i), tpred.session(a, j))


def test_stack_states_round_trip(setup):
    _, _, _, cfg = setup
    ds = SyntheticDataset(n_samples=3, hw=(64, 64))
    singles = _states(cfg, [ds.get_sample(i) for i in range(3)], (64, 64))
    states = tpred.stack_states(singles)
    assert states.image.shape == (3, 64, 64, 3)
    assert states.gt.shape == (3, 64, 64) and states.roi.shape == (3, 4)
    assert states.click_count.shape == (3,)
    for i, st in enumerate(singles):
        for got, ref in zip(tpred.session(states, i), st):
            assert got.shape == ref.shape and torch.equal(got, ref)


PROMPT_VARIANTS = {
    "mode1_multi": dict(prompt_mode=1, as_multi_prompts=True),
    "mode1_points": dict(prompt_mode=1, as_multi_prompts=False),
    "mode2_multi": dict(prompt_mode=2, as_multi_prompts=True),
    "mode2_points": dict(prompt_mode=2, as_multi_prompts=False),
    "mode1_points_det": dict(prompt_mode=1, as_multi_prompts=False,
                             deterministic_prompts=True),
}
PROMPT_SAMPLES = (0, 1, 3)     # two 64 x 64 objects and one 40 x 90


@pytest.mark.parametrize("variant", sorted(PROMPT_VARIANTS))
def test_batched_prompt_sessions_equal_click_scan(setup, variant):
    """Box / scribble sessions in a batch of 3: every field after 4 rounds
    equals each session's own click_scan, each session drawing its own
    sequential session's prompt noise (random prompts, and deterministic
    ones on one variant)."""
    _, _, model, cfg = setup
    cfg = dataclasses.replace(cfg, **PROMPT_VARIANTS[variant])
    ds = _datasets(SyntheticDataset)
    singles = _states(cfg, [ds.get_sample(i) for i in PROMPT_SAMPLES])
    with torch.no_grad():
        states, ious = batched.batched_click_scan(
            model, cfg, tpred.stack_states(singles), CLICKS)
        for i, st in enumerate(singles):
            st, want = tpred.click_scan(model, cfg, st, CLICKS)
            np.testing.assert_array_equal(ious[i].numpy(), want.numpy())
            _assert_state_equal(tpred.session(states, i), st)


@pytest.mark.parametrize("variant", ["mode1_multi", "mode1_points",
                                     "mode2_points"])
def test_batched_prompt_sessions_at_different_clicks(setup, variant):
    """Deterministic prompts (no draws), sessions at clicks 0, 1 and 2 in
    one batch, and one at click 0 with an empty gt (no box, so it keeps its
    clicks): the first-click rewrite, the slot capacity and whether a box
    replaces the clicks are each session's own, so every session goes on
    as its own click_scan."""
    _, _, model, cfg = setup
    cfg = dataclasses.replace(cfg, deterministic_prompts=True,
                              **PROMPT_VARIANTS[variant])
    ds = _datasets(SyntheticDataset)
    empty = ds.get_sample(0)
    with torch.no_grad():
        singles = [tpred.click_scan(model, cfg, st, k)[0] if k else st
                   for k, st in enumerate(_states(cfg, [
                       ds.get_sample(i) for i in PROMPT_SAMPLES]))]
        singles.append(tpred.init_session(
            empty.image, np.zeros_like(empty.gt_mask(0)),
            cfg.model.num_max_points, (64, 128), device="cpu"))
        states, ious = batched.batched_click_scan(
            model, cfg, tpred.stack_states(singles), CLICKS)
        for i, st in enumerate(singles):
            st, want = tpred.click_scan(model, cfg, st, CLICKS)
            np.testing.assert_array_equal(ious[i].numpy(), want.numpy())
            _assert_state_equal(tpred.session(states, i), st)


@pytest.mark.parametrize("first", [True, False])
def test_box_rewrite_decides_per_session(first):
    """The box rewrite over the forward batch of two sessions, [2 originals;
    2 flips]: the session without a box (an empty gt) keeps its clicks, the
    other is rewritten, each as when alone (JAX's `jnp.any(ok)` is over one
    session's flip pair under its vmap)."""
    yy, xx = np.mgrid[:48, :64]
    obj = ((yy - 22) / 14.0) ** 2 + ((xx - 30) / 20.0) ** 2 <= 1.0
    gtb = torch.from_numpy(np.stack([obj, np.zeros_like(obj)] * 2))
    gtb[2] = gtb[2].flip(-1)
    pts = torch.full((4, 12, 3), -1.0)
    pts[:, 0] = torch.tensor([22.0, 30.0, 0.0])
    pts[:, 6] = torch.tensor([40.0, 52.0, 1.0])
    n_dyn = torch.tensor([1, 2, 1, 2], dtype=torch.int32)
    got = tpred._rewrite_points_box(pts, gtb, {}, n_dyn,
                                    torch.tensor(first).expand(4), True, 2)
    for i in (0, 1):
        rows = [i, 2 + i]
        want = tpred._rewrite_points_box(pts[rows], gtb[rows], {},
                                         n_dyn[rows], torch.tensor(first),
                                         True)
        assert torch.equal(got[rows], want)
    assert torch.equal(got[[1, 3]], pts[[1, 3]])
    assert not torch.equal(got[[0, 2]], pts[[0, 2]])


@pytest.mark.parametrize("variant", ["mode1_points", "mode2_multi"])
def test_batched_prompt_sessions_match_jax(setup, monkeypatch, variant):
    """One variant per protocol: the port's batch of 3 against JAX's
    `batched_click_scan` (a vmap of its click_scan), JAX's draws injected:
    the same click slots in every session, IoU within 1e-5."""
    params, jpc, model, cfg = setup
    jcfg = dataclasses.replace(jpc, **PROMPT_VARIANTS[variant])
    cfg = config_from_dict(config_to_dict(jcfg))
    n = jcfg.model.num_max_points
    jds, ds = _datasets(JSynthetic), _datasets(SyntheticDataset)
    jstates = jbatched._stack_states([
        jpred.init_session(s.image, s.gt_mask(0), n, (64, 128))
        for s in (jds.get_sample(i) for i in PROMPT_SAMPLES)])
    with jax.default_matmul_precision("highest"):
        jst, jious = jbatched.batched_click_scan(params, jcfg, jstates, CLICKS)
    counter = itertools.count(1)
    monkeypatch.setattr(tpred, "_prompt_noise",
                        lambda cfg, gen, device: jax_noise(cfg, next(counter)))
    with torch.no_grad():
        st, ious = batched.batched_click_scan(
            model, cfg, tpred.stack_states(
                _states(cfg, [ds.get_sample(i) for i in PROMPT_SAMPLES])),
            CLICKS)
    np.testing.assert_array_equal(
        st.points.numpy(), np.asarray(jst.points).reshape(st.points.shape))
    np.testing.assert_allclose(ious.numpy(), np.asarray(jious), atol=1e-5)


def _blobs(r, b, h, w):
    yy, xx = np.mgrid[:h, :w]
    m = np.zeros((b, h, w), bool)
    for i in range(b):
        for _ in range(3):
            cy, cx = r.integers(0, h), r.integers(0, w)
            rad = r.integers(2, 12)
            m[i] |= (yy - cy) ** 2 + (xx - cx) ** 2 <= rad ** 2
    return m


@pytest.mark.parametrize("seed", range(3))
def test_next_click_per_session_equals_single(seed, monkeypatch):
    """(B, H, W) masks: per-session maxima and first row-major argmax, all
    sessions' EDTs in one min-plus call; empty and tied sessions too."""
    r = np.random.default_rng(seed)
    b, h, w = 5, 37, 52
    fn, fp = _blobs(r, b, h, w), _blobs(r, b, h, w)
    fn[1] = False
    fp[1] = False                             # no error: click at (0, 0)
    fn[2] = False
    fn[2, 10:14, 20:24] = True                # a 4x4 square: tied maxima
    fp[2] = False
    nc = r.random((b, h, w)) > 0.05
    calls = []
    minplus = edt.minplus_rows
    monkeypatch.setattr(edt, "minplus_rows",
                        lambda *a, **kw: calls.append(1) or minplus(*a, **kw))
    for rows in ("scan", "dense"):
        calls.clear()
        got = edt.next_click_from_error(*map(torch.from_numpy, (fn, fp, nc)),
                                        rows=rows)
        assert len(calls) == 1
        for i in range(b):
            want = edt.next_click_from_error(
                *map(torch.from_numpy, (fn[i], fp[i], nc[i])), rows=rows)
            assert [t[i].item() for t in got] == [t.item() for t in want]


def _rois(r, b, h, w):
    out = []
    for _ in range(b):
        r0, r1 = sorted(r.integers(0, h, 2))
        c0, c1 = sorted(r.integers(0, w, 2))
        out.append([r0, r1, c0, c1])
    out[0] = [5, 5, 7, 7]                     # a single pixel
    return torch.tensor(out, dtype=torch.int32)


@pytest.mark.parametrize("seed", range(3))
def test_batched_roi_crop_and_paste_back_equal_single(seed):
    r = np.random.default_rng(seed)
    b = 4
    img = torch.from_numpy(r.normal(size=(b, 60, 80, 4)).astype(np.float32))
    probs = torch.from_numpy(r.random((b, 32, 32, 1)).astype(np.float32))
    rois = _rois(r, b, 60, 80)
    crop = resize.roi_crop_resize(img, rois, 48, 40)
    paste = resize.roi_paste_back(probs, rois, 60, 80)
    for i in range(b):
        assert torch.equal(crop[i:i + 1], resize.roi_crop_resize(
            img[i:i + 1], rois[i], 48, 40))
        assert torch.equal(paste[i:i + 1], resize.roi_paste_back(
            probs[i:i + 1], rois[i], 60, 80))
    # one roi (4,) for the whole batch is every item's own
    assert torch.equal(resize.roi_crop_resize(img, rois[1], 48, 40),
                       resize.roi_crop_resize(img, rois[1].expand(b, 4),
                                              48, 40))
