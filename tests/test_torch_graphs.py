"""The captured-round driver (`inference/graphs.py`) on the CPU, with a
stand-in for the card.

A CUDA graph cannot be captured here, so `graphs._Device`, which holds every
CUDA call of the module, is replaced by `CpuDevice`: its capture runs the
round once (the recording pass, which calls the wrappers as a capture does)
and keeps it as a function; a replay runs the function again and writes
its results into the tensors the recording pass returned, as a graph
writes its outputs where the capture put them. A capture executes nothing
on the card and the module replays right after it, so the stand-in's
first replay, whose work the recording pass did, does nothing. What this
holds is the module's own logic: the eager first round of a key, static
buffers, copy-in and copy-out, the state written back for the next replay,
the round's other inputs, launch counts (the eager round's and the
capture's, none per replay), the LRU cache and its key. Every result is
held exactly against the eager functions of `predictor` (the same CPU ops
in the same order). The card's own replays are held against eager rounds
in tests/test_torch_cuda.py and chip_smoke.py."""
import contextlib
import dataclasses
import time

import pytest
import torch

import chip_smoke
from pvpuformer_tpu_torch.inference import batched, graphs
from pvpuformer_tpu_torch.inference import predictor as tpred
from pvpuformer_tpu_torch.inference.datasets import SyntheticDataset
from pvpuformer_tpu_torch.models.vpu import init_vpu
from pvpuformer_tpu_torch.ops import edt, edt_minplus
from test_torch_eval import two_torch_threads  # noqa: F401

CLICKS = 3


def _flat(out):
    state, iou = out
    return list(state) + [iou]


class _Replay:
    def __init__(self, fn, out):
        self.fn, self.outputs = fn, _flat(out)
        self.captured = True

    def replay(self):
        """A graph's replay makes no Python call: the wrappers' counters
        stay as they are. The first replay's work was the capture's."""
        if self.captured:
            self.captured = False
            return
        minplus = edt_minplus.minplus_rows
        n = minplus.launches
        for kept, new in zip(self.outputs, _flat(self.fn())):
            if kept is not new:
                kept.copy_(new)
        minplus.launches = n


class CpuEvent:
    """A stage mark on the CPU: the host clock when it was recorded (each
    replay of the stand-in records its marks again)."""

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def query(self) -> bool:
        return True

    def elapsed_time(self, other) -> float:
        return (other.t - self.t) * 1e3


class CpuDevice:
    """`graphs._Device` on the CPU: no streams, a capture that records the
    round as a function, host-clock stage marks."""
    event = CpuEvent

    def __init__(self, device):
        self.device = device
        self.eagers = self.captures = 0

    @contextlib.contextmanager
    def run(self):
        yield

    def eager(self, fn):
        self.eagers += 1
        return fn()

    def capture(self, fn, fresh):
        self.captures += 1
        out = fn()
        return _Replay(fn, out), out


@pytest.fixture
def cpu_graphs(monkeypatch):
    """graphs on the CPU stand-in, rounds replayed on the CPU, with an
    empty cache; the min-plus wrapper counts its CPU calls as its kernel
    launches would."""
    monkeypatch.setattr(graphs, "_Device", CpuDevice)
    monkeypatch.setattr(graphs, "replayed", lambda device: True)
    monkeypatch.setattr(graphs, "_devices", {})
    monkeypatch.setattr(graphs, "_graphs", type(graphs._graphs)())
    monkeypatch.setattr(graphs, "_seen", type(graphs._seen)())
    monkeypatch.setattr(graphs, "rounds", dict.fromkeys(graphs.rounds, 0))
    orig = edt_minplus.minplus_rows
    orig.launches = 0

    def counted(*a, **kw):
        orig.launches += 1
        return orig(*a, **kw)
    monkeypatch.setattr(edt, "minplus_rows", counted)
    yield
    orig.launches = 0


@pytest.fixture(scope="module")
def setup():
    cfg = tpred.PredictorConfig(model=chip_smoke.tiny_config(),
                                target_size=(64, 64), min_crop_size=32)
    model = init_vpu(cfg.model, torch.Generator().manual_seed(1), "cpu")
    with torch.no_grad():
        # probabilities around the 0.49 threshold: the masks follow clicks
        model.head.conv_seg.b -= 0.1
    ds = SyntheticDataset(n_samples=3, hw=(64, 64))
    return model, cfg, [ds.get_sample(i) for i in range(3)]


def _states(cfg, samples):
    return [tpred.init_session(s.image, s.gt_mask(0),
                               cfg.model.num_max_points, (64, 64), "cpu")
            for s in samples]


def _assert_equal(got, want):
    for name, g, w in zip(tpred.SessionState._fields, got, want):
        assert torch.equal(g, w), name


VARIANTS = {"clicks": {}, "mode1_points": dict(prompt_mode=1,
                                               as_multi_prompts=False),
            "mode2_multi": dict(prompt_mode=2)}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("b", [1, 3])
def test_replayed_rounds_equal_eager(setup, cpu_graphs, variant, b):
    """Two runs of rounds of a batch (the first runs its first round
    eagerly, then captures and replays; the second only replays) equal the
    eager scan continued, every field; the wrappers count the eager round's
    and the capture's calls, none per replay."""
    model, cfg, samples = setup
    cfg = dataclasses.replace(cfg, **VARIANTS[variant])
    start = tpred.stack_states(_states(cfg, samples[:b]))
    gen_e, gen_r = (torch.Generator().manual_seed(tpred.NOISE_SEED)
                    for _ in range(2))
    with torch.no_grad():
        want1, wious1 = batched.batched_click_scan(model, cfg, start, CLICKS,
                                                   gen_e)
        want2, wious2 = batched.batched_click_scan(model, cfg, want1, 2,
                                                   gen_e)
    minplus = edt_minplus.minplus_rows
    minplus.launches = 0
    got1, ious1 = graphs.click_rounds(model, cfg, start, CLICKS, gen_r)
    got2, ious2 = graphs.click_rounds(model, cfg, got1, 2, gen_r)
    dev = graphs._devices[torch.device("cpu")]
    assert (dev.eagers, dev.captures, len(graphs._graphs)) == (1, 1, 1)
    assert graphs.rounds == {"eager": 1, "captured": 1,
                             "replayed": CLICKS + 1}
    n_mp = {0: 1, 1: 1, 2: 2}[cfg.prompt_mode]     # + the extra error click
    assert minplus.launches == n_mp * 2
    _assert_equal(got1, want1)
    _assert_equal(got2, want2)
    assert torch.equal(ious1, wious1) and torch.equal(ious2, wious2)


def test_returned_state_survives_later_replays(setup, cpu_graphs):
    """What a run returns is a copy: replays of other sessions on the same
    graph leave it as it was (an undo stack keeps such states)."""
    model, cfg, samples = setup
    a, b = (tpred._as_batch(st) for st in _states(cfg, samples[:2]))
    got_a, _ = graphs.click_rounds(model, cfg, a, 2)
    kept = [t.clone() for t in got_a]
    graphs.click_rounds(model, cfg, b, 2)
    graphs.click_rounds(model, cfg, got_a, 1)
    _assert_equal(got_a, kept)
    for t, r in zip(got_a, graphs._graphs[next(iter(graphs._graphs))].state):
        assert t.data_ptr() != r.data_ptr()


def test_user_click_rounds_equal_eager(setup, cpu_graphs):
    model, cfg, samples = setup
    state = _states(cfg, samples[:1])[0]
    want = got = state
    for y, x, pos in ((20.5, 30.25, True), (40.0, 10.0, False),
                      (-3.0, 70.0, True), (50.0, 12.0, True)):
        with torch.no_grad():
            want, wiou = tpred.user_click_step(
                model, cfg, want, torch.tensor(y), torch.tensor(x),
                torch.tensor(pos))
        got, iou = graphs.user_click_round(model, cfg, got, y, x, pos)
        _assert_equal(got, want)
        assert torch.equal(iou, wiou)
    dev = graphs._devices[torch.device("cpu")]
    assert (dev.eagers, dev.captures) == (1, 1)


def test_one_click_sessions_capture_on_the_second_meeting(setup,
                                                         cpu_graphs):
    """A key's first round runs eagerly and captures nothing; the key's
    next round, in a later run, is captured; later ones replay."""
    model, cfg, samples = setup
    dev_rounds = []
    for st in _states(cfg, samples):
        with torch.no_grad():
            want, wiou = tpred.click_step(model, cfg, st)
        got, iou = graphs.click_rounds(model, cfg, tpred._as_batch(st), 1)
        _assert_equal(tpred.session(got, 0), want)
        assert torch.equal(iou[0, 0], wiou)
        dev_rounds.append(dict(graphs.rounds))
    assert dev_rounds == [{"eager": 1, "captured": 0, "replayed": 0},
                          {"eager": 1, "captured": 1, "replayed": 1},
                          {"eager": 1, "captured": 1, "replayed": 2}]


def test_cache_key_and_bound(setup, cpu_graphs, monkeypatch):
    """One capture per (model, where its tensors lie, config, canvas,
    batch, kind); at most MAX_GRAPHS kept, the least recently used
    dropped."""
    model, cfg, samples = setup
    monkeypatch.setattr(graphs, "MAX_GRAPHS", 2)
    one = tpred._as_batch(_states(cfg, samples[:1])[0])
    two = tpred.stack_states(_states(cfg, samples[:2]))
    dev_cfg = dataclasses.replace(cfg, prob_thresh=0.4)
    graphs.click_rounds(model, cfg, one, 2)           # eager, capture
    graphs.click_rounds(model, cfg, one, 1)           # a hit
    dev = graphs._devices[torch.device("cpu")]
    assert (dev.eagers, dev.captures) == (1, 1)
    graphs.click_rounds(model, cfg, two, 2)           # another batch size
    graphs.click_rounds(model, cfg, one, 1)           # a hit, now the newest
    graphs.click_rounds(model, dev_cfg, one, 2)       # another config
    assert dev.captures == 3 and len(graphs._graphs) == 2
    graphs.click_rounds(model, cfg, one, 1)           # kept
    graphs.click_rounds(model, cfg, two, 1)           # dropped, met: again
    assert (dev.eagers, dev.captures) == (3, 4)
    other = init_vpu(cfg.model, torch.Generator().manual_seed(1), "cpu")
    graphs.click_rounds(other, cfg, two, 2)           # another model
    assert (dev.eagers, dev.captures) == (4, 5)
    graphs.clear()
    assert len(graphs._graphs) == len(graphs._seen) == 0


def test_key_follows_every_tensor_of_the_model(setup, cpu_graphs):
    """A parameter or buffer given new storage (an in-place cast or move)
    makes a new key: a graph reads the storage it was captured with."""
    model, cfg, samples = setup
    model = init_vpu(cfg.model, torch.Generator().manual_seed(1), "cpu")
    one = tpred._as_batch(_states(cfg, samples[:1])[0])
    graphs.click_rounds(model, cfg, one, 2)
    last = list(model.parameters())[-1]
    before = graphs._key(model, cfg, "click", one)
    last.data = last.data.clone()
    assert graphs._key(model, cfg, "click", one) != before
    graphs.click_rounds(model, cfg, one, 2)
    dev = graphs._devices[torch.device("cpu")]
    assert (dev.eagers, dev.captures) == (2, 2)


def test_drivers_replay_as_they_run_eagerly(setup, cpu_graphs, monkeypatch):
    """`Predictor` (run_clicks, next_click, user_click, undo) and
    `BatchedEvaluator` (box prompts, a padded chunk) through the stand-in
    give what they give eagerly on the CPU."""
    model, cfg, samples = setup
    box = dataclasses.replace(cfg, prompt_mode=1)
    ds = SyntheticDataset(n_samples=3, hw=(64, 64))

    def run():
        pred = tpred.Predictor(model, cfg, device="cpu")
        pred.set_input(samples[0].image, samples[0].gt_mask(0))
        ious = pred.run_clicks(2).tolist() + [
            pred.next_click(), pred.user_click(20.0, 30.0, False),
            pred.user_click(40.0, 10.0, True), pred.next_click()]
        pred.undo_click()
        curves, _, _ = batched.BatchedEvaluator(model, box, 2, device="cpu"
                                                ).evaluate(ds, max_clicks=3)
        return ious, pred.state, curves
    monkeypatch.setattr(graphs, "replayed", lambda device: False)
    want = run()
    assert graphs._devices == {}
    monkeypatch.setattr(graphs, "replayed", lambda device: True)
    got = run()
    dev = graphs._devices[torch.device("cpu")]
    assert dev.captures == 3          # clicks, user clicks, box at B = 2
    assert got[0] == want[0]
    _assert_equal(got[1], want[1])
    assert len(got[2]) == len(want[2]) == 3
    for a, b in zip(got[2], want[2]):
        assert a.tolist() == b.tolist()
