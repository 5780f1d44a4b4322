"""The port's bench entry, `python -m pvpuformer_tpu_torch.bench`, on the CPU
at the tiny config: its sessions restart from one state and give
`click_scan`'s curve exactly, and its last line is the three-key JSON
object; without a card it measures nothing."""
import json

import numpy as np
import pytest
import torch

import chip_smoke
from pvpuformer_tpu_torch import bench
from pvpuformer_tpu_torch.inference.predictor import (Predictor,
                                                     PredictorConfig,
                                                     click_scan, init_session)
from pvpuformer_tpu_torch.models.vpu import init_vpu
from test_torch_eval import two_torch_threads  # noqa: F401


def test_bench_sessions_equal_click_scan():
    cfg = PredictorConfig(model=chip_smoke.tiny_config(), target_size=(64, 64),
                          min_crop_size=32)
    model = init_vpu(cfg.model, torch.Generator().manual_seed(0), "cpu")
    with torch.no_grad():
        model.head.conv_seg.b -= 0.1        # masks that follow the clicks
    pred = Predictor(model, cfg, device="cpu")
    image, gt = bench.protocol_sample()
    state0 = init_session(image, gt, cfg.model.num_max_points, (448, 448),
                          "cpu")
    kept = [t.clone() for t in state0]
    per_click, curves = bench.measure(pred, state0, sessions=2, clicks=3,
                                      warmup=1, units=1)
    with torch.no_grad():
        _, want = click_scan(model, cfg, state0, 3)
    assert len(per_click) == 1 and per_click[0] > 0
    assert curves.shape == (2, 3)
    for c in curves:
        np.testing.assert_array_equal(c, want.numpy())
    assert len(set(want.tolist())) > 1                  # not a flat curve
    for t, k in zip(state0, kept):
        assert torch.equal(t, k)
    for int8, suffix in ((False, ""), (True, "_int8")):
        line = json.loads(bench.result_line(per_click, int8))
        assert set(line) == {"metric", "value", "unit"}
        assert line["metric"] == f"p50_per_click_latency_ms_vitb448_gpu{suffix}"
        assert line["unit"] == "ms"
        assert line["value"] == float(np.median(per_click))


def test_bench_needs_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        bench.main([])
    assert '"metric"' not in capsys.readouterr().out
