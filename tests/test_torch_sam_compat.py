"""The port's SAM comparison mode and --profile's counters against the JAX
package's: `inference/sam_compat.py` and `python -m
pvpuformer_tpu_torch.evaluate SAM` against `scripts/evaluate.py SAM` with
the stub `segment_anything` of tests/test_cli.py (the real package is not
installed on either machine), the ImportError without it, and
`utils/profiling.py` (LatencyRecorder, memory_stats)."""
import sys

import numpy as np
import pytest
import torch

from pvpuformer_tpu.inference import sam_compat as jsam
from pvpuformer_tpu.utils import profiling as jprof
from pvpuformer_tpu_torch.inference import sam_compat
from pvpuformer_tpu_torch.utils import profiling
from test_cli import SAM_STUB
from test_torch_eval_protocol import miou_lines, noc_cells, run_jax, run_port


@pytest.fixture
def stub_sam(tmp_path, monkeypatch):
    """segment_anything importable from a stub package for one test."""
    pkg = tmp_path / "stub" / "segment_anything"
    pkg.mkdir(parents=True)
    (pkg / "__init__.py").write_text(SAM_STUB)
    monkeypatch.syspath_prepend(str(tmp_path / "stub"))
    monkeypatch.delitem(sys.modules, "segment_anything", raising=False)
    yield
    sys.modules.pop("segment_anything", None)


SAM_ARGV = ["SAM", "--sam-checkpoint", "weights/sam_vit_b_01ec64.pth",
            "--datasets", "Synthetic", "--n-clicks", "3", "--limit", "2",
            "--print-ious", "--save-ious"]


@pytest.mark.parametrize("extra", [[], ["--sam-multimask",
                                        "--sam-feedback-mask",
                                        "--sam-model-type", "vit_l"]],
                         ids=["default", "multimask"])
def test_sam_mode_matches_jax_cli(tmp_path, monkeypatch, capsys, stub_sam,
                                  extra):
    """Both CLIs run the stub SAM in the clicker loop: the same NoC row and
    mIoU@k line, and the same curves."""
    import pickle
    want = run_jax(SAM_ARGV + extra, tmp_path / "jax", monkeypatch, capsys)
    got = run_port(SAM_ARGV + extra, tmp_path / "port", capsys)
    assert noc_cells(got, "SAM") == noc_cells(want, "SAM")
    assert miou_lines(got) == miou_lines(want) and len(miou_lines(got)) == 1
    name = "Synthetic_cvpr_SAM_3.pickle"
    res = [pickle.load(open(tmp_path / side / name, "rb"))["all_ious"]
           for side in ("port", "jax")]
    assert len(res[0]) == len(res[1]) == 2
    for a, b in zip(*res):
        np.testing.assert_array_equal(a, b)


def test_sam_mode_raises_import_error_without_the_package(
        tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "segment_anything", None)
    assert not sam_compat.sam_available()
    for run in (lambda: run_jax(SAM_ARGV, tmp_path / "jax", monkeypatch,
                                capsys),
                lambda: run_port(SAM_ARGV, tmp_path / "port", capsys),
                sam_compat.SamCompatPredictor):
        with pytest.raises(ImportError, match="segment_anything is not "
                                              "installed"):
            run()


def test_sam_predictor_matches_jax(stub_sam):
    """The adapter on a ready SamPredictor: IoUs, probabilities and click
    slots equal JAX's over 4 clicks, for each variant name."""
    import segment_anything as sa
    from pvpuformer_tpu_torch.inference.datasets import SyntheticDataset
    for name in ("sam_vit_h_4b8939.pth", "x_vit_l.pth", "plain.pth"):
        assert sam_compat.model_type_from_name(name) == \
            jsam.model_type_from_name(name)
    sample = SyntheticDataset(2, (80, 112)).get_sample(1)
    gt = sample.gt_mask(0)
    ours = sam_compat.SamCompatPredictor(sa.SamPredictor(None),
                                         multimask=True)
    theirs = jsam.SamCompatPredictor(sa.SamPredictor(None), multimask=True)
    for p in (ours, theirs):
        p.set_input(sample.image, gt)
    assert ours.run_clicks(3).tolist() == theirs.run_clicks(3).tolist()
    assert ours.next_click() == theirs.next_click()
    np.testing.assert_array_equal(ours.probs, theirs.probs)
    np.testing.assert_array_equal(ours.clicks, theirs.clicks)
    assert ours.clicks.shape == (4, 3)


def test_latency_recorder_matches_jax():
    r = np.random.default_rng(0)
    ours, theirs = profiling.LatencyRecorder(), jprof.LatencyRecorder()
    assert ours.summary() == theirs.summary() == {}
    for s in r.exponential(0.01, 57):
        ours.add(float(s))
        theirs.add(float(s))
    with ours.measure():
        pass
    theirs.samples_ms.append(ours.samples_ms[-1])
    assert ours.summary() == theirs.summary()
    assert ours.summary()["count"] == 58
    for bins in (10, 20):
        for a, b in zip(ours.histogram(bins), theirs.histogram(bins)):
            np.testing.assert_array_equal(a, b)


def test_memory_stats_reports_the_cards_only(monkeypatch):
    """A CPU run reports no CUDA device; on a card the allocator's current
    and peak bytes and the device's total, in MiB, keyed "cuda:i"."""
    assert profiling.memory_stats("cpu") == {}
    assert profiling.memory_stats(torch.device("cpu")) == {}
    stats = {0: {"allocated_bytes.all.current": 3 * 2 ** 20,
                 "allocated_bytes.all.peak": 5 * 2 ** 20},
             1: {}}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda i: stats[i])
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda i: (2 ** 30, 80 * 2 ** 30))
    card0 = {"bytes_in_use_mb": 3.0, "peak_bytes_in_use_mb": 5.0,
             "bytes_limit_mb": 80 * 1024.0}
    card1 = {"bytes_in_use_mb": 0.0, "peak_bytes_in_use_mb": 0.0,
             "bytes_limit_mb": 80 * 1024.0}
    assert profiling.memory_stats() == {"cuda:0": card0, "cuda:1": card1}
    assert profiling.memory_stats("cuda:0") == {"cuda:0": card0}
    assert profiling.memory_stats("cuda") == {"cuda:1": card1}
    assert set(card0) == set(next(iter(jprof.memory_stats().values())))
