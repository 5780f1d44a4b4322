"""The readers of the program's own tracing (`*_ms_per_round`,
`host_ms_per_round`) on a made-up summary, and with nothing recorded or a
program without tracing."""
from __future__ import annotations

import pytest

from benchmark import harness
from pvpuformer_tpu_torch.utils import profiling

STAGES = ("oracle", "input", "backbone", "neck", "head", "output")
SUMMARY = {
    "spans": {
        "replayed": {
            "predictor.round": {"count": 10, "total_ms": 90.0,
                                "self_ms": 5.0},
            "predictor.read": {"count": 10, "total_ms": 64.0,
                               "self_ms": 64.0},
            "graphs.replay": {"count": 10, "total_ms": 6.0,
                              "self_ms": 6.0},
            "predictor.set_input": {"count": 1, "total_ms": 3.0,
                                    "self_ms": 3.0}},
        "profiled": {
            "predictor.round": {"count": 40, "total_ms": 900.0,
                                "self_ms": 50.0}}},
    "rounds": {"replayed": 10, "profiled": 40, "eager": 4},
    "stage_ms": {"replayed": dict(zip(STAGES, (20.0, 8.0, 80.0, 60.0,
                                               40.0, 12.0))),
                 "profiled": dict(zip(STAGES, (9.0,) * 6)),
                 "eager": dict(zip(STAGES, (1.0,) * 6))},
    "stage_rounds": {"replayed": 40, "profiled": 2, "eager": 1}}
NOC = {"spans": {"replayed": {
    "batched.evaluate": {"count": 1, "total_ms": 12000.0, "self_ms": 1.0},
    "batched.read": {"count": 8, "total_ms": 3000.0, "self_ms": 3000.0},
    "graphs.replay": {"count": 160, "total_ms": 8000.0, "self_ms": 8000.0}}},
    "rounds": {"replayed": 160}}
NAMES = [f"{s}_ms_per_round" for s in STAGES] + ["host_ms_per_round"]


def _read(name, summary, monkeypatch):
    monkeypatch.setattr(profiling, "summary", lambda: summary)
    return harness.load_reader(name + ".click").read(None)


def test_readers_on_a_made_up_summary(monkeypatch):
    got = {n: _read(n, SUMMARY, monkeypatch) for n in NAMES}
    assert got == {"oracle_ms_per_round": 0.5, "input_ms_per_round": 0.2,
                   "backbone_ms_per_round": 2.0, "neck_ms_per_round": 1.5,
                   "head_ms_per_round": 1.0, "output_ms_per_round": 0.3,
                   "host_ms_per_round": pytest.approx(2.0)}
    assert _read("host_ms_per_round", NOC, monkeypatch) == pytest.approx(
        1000.0 / 160)


@pytest.mark.parametrize("summary", [{}, {"rounds": {"eager": 2}},
                                     {"stage_ms": {"eager": {"oracle": 1.0},
                                                   "profiled": {"oracle": 2.0}},
                                      "stage_rounds": {"eager": 1,
                                                       "profiled": 1}}])
def test_readers_find_nothing_without_replayed_records(monkeypatch, summary):
    for n in NAMES:
        assert _read(n, summary, monkeypatch) is None, n


def test_readers_find_nothing_in_a_program_without_tracing(monkeypatch):
    profiling.reset()
    for n in NAMES:
        assert harness.load_reader(n + ".noc").read(None) is None, n
    monkeypatch.delattr(profiling, "summary")
    for n in NAMES:
        assert harness.load_reader(n + ".noc").read(None) is None, n
