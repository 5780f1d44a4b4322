"""The counting functions against hand-worked values, the per-layer
readers on a made-up trace, the harness's lookups by name (a dummy cell
added as new files in a copy) and the traffic's repeatability."""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest

from benchmark import harness
from benchmark.metrics import _counts as C
from benchmark.tests.tiny import tiny_root
from benchmark.traffic import _data

ROOT = Path(__file__).resolve().parents[2]


def cfg(name):
    return json.loads((ROOT / "benchmark" / "configs"
                       / f"{name}.json").read_text())


def test_bounds_at_the_click_and_training_shapes():
    # attention (24, 784, 64): 4 BH N^2 D = 3.776e9 operations at 989 T
    t, which = C.bound(*C.attention(24, 784, 64))
    assert which == "operations" and round(t * 1e6, 2) == 3.82
    # bytes 4 BH N D x 2 = 9.63 MB at 3.35 TB/s
    assert round(C.attention(24, 784, 64)[1] / C.HBM * 1e6, 2) == 2.88
    # LN+MLP at the batch-32 training rows (25088, 768 -> 3072)
    t, which = C.bound(*C.ln_mlp(25088, 768, 3072))
    assert which == "operations" and round(t * 1e6, 2) == 239.39
    assert round(C.bound(*C.ln_mlp(1568, 768, 3072))[0] * 1e6, 2) == 14.96
    # min-plus (896, 448): 8 R W bytes
    t, which = C.bound(*C.minplus(896, 448))
    assert which == "bytes" and round(t * 1e6, 2) == 0.96


def test_model_flops_by_hand():
    b, h = cfg("vpu_vitb448"), cfg("vpu_vith448")
    s = C.vit_shapes(b["backbone"])
    assert (s["tokens"], s["windows"], s["global_blocks"]) == (784, 4, 2)
    s = C.vit_shapes(h["backbone"])
    assert (s["tokens"], s["windows"], s["global_blocks"]) == (1024, 4, 4)
    # ViT-B blocks alone, one image: 12 x (qkv + proj + MLP) products
    # + 10 windowed and 2 global attentions
    blocks = 12 * 2 * 784 * 768 * (3 * 768 + 768 + 2 * 3072) \
        + 10 * 4 * 48 * 196 ** 2 * 64 + 2 * 4 * 12 * 784 ** 2 * 64
    assert blocks < C.model_flops(b, 1) < 1.35 * blocks
    assert round(C.model_flops(b, 2) / 1e12, 3) == 0.349
    assert round(C.model_flops(h, 16) / 1e12, 2) == 22.94
    # SimpleClick's ViT-H neck (240, 480, 960, 1920) against ViT-B's
    # (128, 256, 512, 1024) under the same 1280-wide tokens (n = 1024,
    # branch widths 640 / 640 / 2560): the four branches' last products
    # and the head's 1x1 convs to 256 channels
    n = 1024
    old = json.loads(json.dumps(h))
    old["neck"]["out_dims"] = [128, 256, 512, 1024]
    delta = 2 * (16 * n * 320 * 112 + 4 * n * 640 * 224 + n * 1280 * 448
                 + n / 4 * 2560 * 896
                 + 256 * (16 * n * 112 + 4 * n * 224 + n * 448 + n / 4 * 896))
    assert C.model_flops(h, 1) - C.model_flops(old, 1) == delta
    assert C.model_flops(h, 16) == 16 * C.model_flops(h, 1)
    calls = C.attention_calls(h, 16)
    assert calls.count((256, 1024, 80)) == 4
    assert calls.count((1024, 256, 80)) == 28


def _trace():
    dev = [("attention_fwd_bf16<64>", 10.0, 20.0),
           ("ln_fc1_gelu_kernel", 20.0, 40.0),
           ("fc2_residual_kernel", 40.0, 50.0),
           ("minplus_envelope_kernel", 60.0, 61.0),
           ("elementwise_kernel", 70.0, 90.0),
           ("Memcpy HtoD", 85.0, 95.0)]
    host = [("bench.round", 0.0, 100.0), ("cudaGraphLaunch", 50.0, 52.0)]
    return harness.Trace(0.0, 100.0, dev, host)


def test_trace_arithmetic():
    tr = _trace()
    assert tr.union() == [(10.0, 50.0), (60.0, 61.0), (70.0, 95.0)]
    assert tr.busy_s == pytest.approx(66e-6)
    assert tr.kernels(("fc1_gelu", "fc2_resid")) == (pytest.approx(30e-6), 2)
    gaps = tr.idle_gaps()
    assert gaps[0] == ["bench.round", pytest.approx(10e-6)]
    assert gaps[1][0] == "bench.round/cudaGraphLaunch"
    assert tr.top_ops(1)[0][0] == "ln_fc1_gelu_kernel"
    assert harness.short_name("void (anonymous namespace)::k<2>(int*)") == \
        "void anon::k<2>"


def test_readers_read_the_trace_and_find_nothing_in_an_empty_one():
    b = cfg("vpu_vitb448")
    tr = _trace()
    ctx = harness.LayerCtx(b, 2, 10, 1.0, tr, [(512, 896, 1)], 100e-6)
    got = {m: harness.load_reader(m).read(ctx) for m in
           ("device_idle.click", "mfu.click", "attn_fwd_roofline.click",
            "ln_mlp_fwd_roofline.click", "minplus_roofline.click",
            "plain_ms_per_round.click")}
    assert got["device_idle.click"] == pytest.approx(34.0)
    assert got["mfu.click"] == pytest.approx(
        100 * C.model_flops(b, 2) * 10 / 989e12)
    # one attention launch of the 12 a round was kept: 1/12 of the bound
    per_round = sum(C.bound(*C.attention(*c))[0]
                    for c in C.attention_calls(b, 2))
    assert got["attn_fwd_roofline.click"] == pytest.approx(
        100 * per_round / 12 / 10e-6)
    assert got["minplus_roofline.click"] == pytest.approx(
        100 * C.bound(*C.minplus(1024, 896))[0] / 1e-6)
    assert got["plain_ms_per_round.click"] == pytest.approx(30e-3)
    empty = harness.Trace(0.0, 100.0, [], [])
    ctx = harness.LayerCtx(b, 2, 0, 0.0, empty, [])
    for m in got:
        assert harness.load_reader(m).read(ctx) is None, m


def test_every_metric_and_cell_resolves_by_name():
    bench = harness.load_benchmark()
    for w in bench["workloads"]:
        cell = harness.find_cell(w["name"])
        harness.load_driver(cell.mix)
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        for m in cell.per_layer:
            harness.load_reader(m["name"])
            assert m["moves"] in {e["name"] for e in cell.end_to_end}
        assert (ROOT / "benchmark" / "limits" / f"{w['name']}.json").is_file()


def test_a_dummy_cell_is_found_from_new_files_alone(tmp_path):
    """tiny_root adds a configuration, two traffic mixes, two cells and
    their limits as new files and entries; nothing that was there is
    edited, and the harness finds them."""
    root = tiny_root(tmp_path)
    for name in ("vpu_vitb448.json", "vpu_vith448.json"):
        assert ((root / "benchmark" / "configs" / name).read_bytes()
                == (ROOT / "benchmark" / "configs" / name).read_bytes())
    for cell in ("tiny_click", "tiny_noc"):
        c = harness.find_cell(cell, root)
        assert c.config["name"] == "tiny"
        assert harness.load_driver(c.mix, root).run
        assert {m["name"].split(".")[1] for m in c.per_layer} == {
            "click" if "click" in cell else "noc"}


def test_traffic_repeats_for_a_seed_and_keeps_its_sizes_across_seeds():
    from benchmark.traffic import click_sessions, noc_batched
    cell = harness.find_cell("vitb448_click")
    a = click_sessions.Mix(cell.mix, 2 ** 31 + 11)
    b = click_sessions.Mix(cell.mix, 2 ** 31 + 11)
    c = click_sessions.Mix(cell.mix, 7)
    assert a.order == c.order
    assert len(a.items) == 99
    for x, y, z in zip(a.items, b.items, c.items):
        assert np.array_equal(x[0], y[0]) and np.array_equal(x[1], y[1])
        assert x[0].shape == z[0].shape and x[2] == z[2]
    assert not np.array_equal(a.items[0][1], c.items[0][1])
    cell = harness.find_cell("vith448_noc_b8")
    d1 = noc_batched.Dataset(cell.mix, 5, 0, [8] * 4)
    d2 = noc_batched.Dataset(cell.mix, 5, 0, [8] * 4)
    assert all(np.array_equal(s.mask, t.mask) and np.array_equal(
        s.image, t.image) for s, t in zip(d1.samples, d2.samples))
    assert [len(c) for c in noc_batched.chunks(d1, 8)] == [8] * 4


def test_schedule_keeps_the_shares_in_every_prefix():
    order = _data.schedule([10, 10, 10, 69])
    assert len(order) == 99 and order.count(3) == 69
    for n in (20, 40, 60):
        assert abs(order[:n].count(3) - 0.697 * n) <= 1.5
