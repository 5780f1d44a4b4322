"""The port's round tracing (`utils/profiling.py`) on the CPU: spans and
their self time, the profiler's `pvpu.*` ranges (and none without a
profiler), the kinds of calls kept apart through `graphs` on the
`test_torch_graphs.CpuDevice` stand-in, a captured round's stage marks,
and the summary's reset. The card's own marks are read by the benchmark
(benchmark/metrics/*_ms_per_round.py)."""
import sys
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pvpuformer_tpu_torch.inference import batched, graphs
from pvpuformer_tpu_torch.inference import predictor as tpred
from pvpuformer_tpu_torch.utils import profiling
from test_torch_eval import two_torch_threads  # noqa: F401
from test_torch_graphs import cpu_graphs, setup  # noqa: F401


@pytest.fixture(autouse=True)
def empty():
    profiling.reset()
    yield
    profiling.reset()


class FakeClock:
    def __init__(self):
        self.t = 0

    def __call__(self) -> int:
        return self.t


def test_span_nesting_and_self_time(monkeypatch):
    clock = FakeClock()
    monkeypatch.setattr(profiling, "_clock", clock)
    ms = 1_000_000
    with profiling.span("outer"):                   # 0 .. 100 ms
        clock.t = 10 * ms
        with profiling.span("inner"):               # 10 .. 30
            clock.t = 30 * ms
        clock.t = 40 * ms
        with profiling.span("inner"):               # 40 .. 90
            clock.t = 50 * ms
            with profiling.span("leaf"):            # 50 .. 60
                clock.t = 60 * ms
            clock.t = 90 * ms
        clock.t = 100 * ms
    spans = profiling.summary()["spans"]["replayed"]
    assert spans["outer"] == {"count": 1, "total_ms": 100, "self_ms": 30}
    assert spans["inner"] == {"count": 2, "total_ms": 70, "self_ms": 60}
    assert spans["leaf"] == {"count": 1, "total_ms": 10, "self_ms": 10}
    # an exception leaves the stack as it found it
    with pytest.raises(ValueError):
        with profiling.span("outer"):
            raise ValueError
    assert profiling.summary()["spans"]["replayed"]["outer"]["count"] == 2
    assert not profiling._call().open


def test_ranges_only_under_a_profiler(monkeypatch):
    opened = []
    real = torch.autograd.profiler.record_function

    def counting(name, *a, **kw):
        opened.append(name)
        return real(name, *a, **kw)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", counting)
    with profiling.span("a"):
        with profiling.span("b"):
            pass
    assert opened == [] and not profiling.tracing()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert profiling.tracing()
        with profiling.span("a"):
            with profiling.span("b"):
                pass
    assert opened == ["pvpu.a", "pvpu.b"]
    names = {e.name for e in prof.events()}
    assert {"pvpu.a", "pvpu.b"} <= names
    spans = profiling.summary()["spans"]
    assert spans["replayed"]["a"]["count"] == spans["profiled"]["a"]["count"]
    assert spans["profiled"]["b"]["count"] == 1


def test_replayed_rounds_are_kept_apart(setup, cpu_graphs):
    """A session's first round runs eagerly and its second is captured and
    replayed: both calls are "eager"; later calls replay and are
    "replayed"; a call under a profiler is "profiled". Each read is one
    host sync a round."""
    model, cfg, samples = setup
    pred = tpred.Predictor(model, cfg, device="cpu")
    pred.set_input(samples[0].image, samples[0].gt_mask(0))
    for _ in range(4):
        pred.next_click()
    with profile(activities=[ProfilerActivity.CPU]):
        pred.next_click()
    s = profiling.summary()
    assert s["rounds"] == {"eager": 2, "replayed": 2, "profiled": 1}
    eager, replayed = s["spans"]["eager"], s["spans"]["replayed"]
    assert eager["predictor.round"]["count"] == 2
    assert eager["graphs.eager"]["count"] == 1
    assert eager["graphs.capture"]["count"] == 1
    assert eager["graphs.replay"]["count"] == 1
    assert replayed["predictor.round"]["count"] == 2
    assert replayed["graphs.replay"]["count"] == 2
    assert "graphs.eager" not in replayed and "graphs.capture" not in replayed
    assert replayed["predictor.read"]["count"] == 2
    assert replayed["predictor.set_input"]["count"] == 1
    assert s["spans"]["profiled"]["graphs.replay"]["count"] == 1
    lines = profiling.report(s)
    assert "spans [replayed]: 2 rounds, 1.00 host reads a round" in lines
    assert graphs.rounds == {"eager": 1, "captured": 1, "replayed": 4}


def test_batched_calls_count_their_rounds(setup, cpu_graphs):
    """`BatchedEvaluator.evaluate`: the first call meets its key (eager),
    the second replays every round; one host read a chunk."""
    model, cfg, samples = setup
    ev = batched.BatchedEvaluator(model, cfg, batch_size=2, device="cpu")

    class Data:
        def __len__(self):
            return 3

        def get_sample(self, i):
            return samples[i]
    for _ in range(2):
        ev.evaluate(Data(), max_clicks=3)
    s = profiling.summary()
    assert s["rounds"] == {"eager": 6, "replayed": 6}
    rep = s["spans"]["replayed"]
    assert rep["batched.evaluate"]["count"] == 1
    assert rep["batched.sessions"]["count"] == 1
    assert rep["batched.chunk"]["count"] == rep["batched.read"]["count"] == 2
    assert rep["batched.curves"]["count"] == 2
    assert rep["graphs.replay"]["count"] == 6
    assert "spans [replayed]: 6 rounds, 0.33 host reads a round" in \
        profiling.report(s)


def test_a_capture_records_the_six_stages_in_order(setup, cpu_graphs):
    """The stand-in's capture records a mark per stage and the end. A
    replay's marks are read at its graph's next replay, under the kind of
    the replay that recorded them (a profiler's or not); an eager round
    under a profiler records and reads its own; none of it waits."""
    model, cfg, samples = setup
    states = tpred.stack_states(
        [tpred.init_session(s.image, s.gt_mask(0), cfg.model.num_max_points,
                            (64, 64), "cpu") for s in samples[:2]])
    with profile(activities=[ProfilerActivity.CPU]):
        states, _ = graphs.click_rounds(model, cfg, states, 1)   # eager
    graphs.click_rounds(model, cfg, states, 1)        # capture, replay 1
    (r,) = graphs._graphs.values()
    assert [n for n, _ in r.marks] == [*profiling.STAGES, profiling.END]
    assert profiling.summary()["stage_rounds"] == {"eager": 1}
    graphs.click_rounds(model, cfg, states, 2)        # reads 1, 2; 3 left
    with profile(activities=[ProfilerActivity.CPU]):
        graphs.click_rounds(model, cfg, states, 1)    # reads 3; 4 left
    assert profiling.summary()["stage_rounds"] == {"eager": 1,
                                                   "replayed": 3}
    graphs.click_rounds(model, cfg, states, 1)        # reads 4, profiled
    s = profiling.summary()
    assert s["stage_rounds"] == {"eager": 1, "replayed": 3, "profiled": 1}
    for kind in ("eager", "replayed", "profiled"):
        assert list(s["stage_ms"][kind]) == list(profiling.STAGES)
        assert all(v >= 0 for v in s["stage_ms"][kind].values())
    assert "device ms a round by stage [replayed, 3 rounds]:" in \
        profiling.report(s)[-2]
    # a person's click: no oracle stage
    pred = tpred.Predictor(model, cfg, device="cpu")
    pred.set_input(samples[0].image, samples[0].gt_mask(0))
    for _ in range(2):
        pred.user_click(20.0, 30.0, True)
    r = next(v for k, v in graphs._graphs.items() if "user" in k)
    assert [n for n, _ in r.marks] == [*profiling.STAGES[1:], profiling.END]


def test_marks_do_nothing_outside_a_recorded_round(setup):
    """On the CPU every round is eager and records no mark, profiler or
    not; the rounds count as eager."""
    model, cfg, samples = setup
    profiling.stage("oracle")
    assert profiling._call().marks is None
    pred = tpred.Predictor(model, cfg, device="cpu")
    pred.set_input(samples[0].image, samples[0].gt_mask(0))
    with profile(activities=[ProfilerActivity.CPU]):
        pred.run_clicks(2)
    pred.next_click()
    s = profiling.summary()
    assert "stage_ms" not in s
    assert s["rounds"] == {"profiled": 2, "eager": 1}
    assert s["spans"]["eager"]["predictor.read"]["count"] == 1


def test_summary_after_reset_is_empty():
    with profiling.span("a"):
        profiling.note_rounds("replayed", 3)
    marks = [("oracle", _Ev(0.0)), ("input", _Ev(1.5)), ("end", _Ev(2.0))]
    assert profiling.read_stages(marks, "replayed")
    # with no wait, a round the card has not passed is left unread
    marks[-1][1].done = False
    assert not profiling.read_stages(marks, "replayed", wait=False)
    s = profiling.summary()
    assert s["rounds"] == {"replayed": 3}
    assert s["stage_ms"] == {"replayed": {"oracle": 1.5, "input": 0.5}}
    assert s["stage_rounds"] == {"replayed": 1}
    profiling.reset()
    assert profiling.summary() == {}
    assert profiling.report() == []


class _Ev:
    def __init__(self, t):
        self.t = t
        self.done = True

    def synchronize(self):
        pass

    def query(self) -> bool:
        return self.done

    def elapsed_time(self, other):
        return other.t - self.t


def test_threads_keep_their_own_calls():
    """Spans from many threads at once: no count is lost and each
    thread's nesting stays its own."""
    n, threads_n = 500, 16
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n):
                with profiling.span("outer"):
                    with profiling.span("inner"):
                        profiling.note_rounds("replayed")
        threads = [threading.Thread(target=work) for _ in range(threads_n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    s = profiling.summary()
    assert s["rounds"] == {"replayed": n * threads_n}
    spans = s["spans"]["replayed"]
    assert spans["outer"]["count"] == spans["inner"]["count"] == n * threads_n
    assert set(s["spans"]) == {"replayed"}
