"""The port's evaluation CLI against `scripts/evaluate.py` on the flags that
shape its inputs and outputs: both parsers' options, --exp-path,
--iou-analysis without --save-ious, --model-name (also under
--merge-shards), --parity, --vis-preds and --profile (the tiny config of
tests/test_torch_eval.py, f32, Synthetic, 3 clicks).

Pass condition: equal NoC cells, per-click IoU within 1e-5. The JAX side's
click scan and click step are each jitted once for the module."""
import argparse
import ast
import pickle
import sys

import jax
import numpy as np
import pytest
import torch

from pvpuformer_tpu_torch import evaluate as cli
from test_torch_eval import _jax_cli
from test_torch_eval import two_torch_threads  # noqa: F401 (autouse)
from test_torch_eval_protocol import ckpt  # noqa: F401 (fixture)
from test_torch_eval_protocol import (CLICKS, assert_curves, assert_same,
                                      common, curves, noc_cells, run_jax,
                                      run_port)


def _options(parser):
    """{option string: (dest, default, type, choices, const, nargs)} of
    every optional argument, and the positional's (dest, default)."""
    opts = {s: (a.dest, a.default, a.type, a.choices, a.const, a.nargs)
            for a in parser._actions for s in a.option_strings
            if s not in ("-h", "--help")}
    pos = [(a.dest, a.default) for a in parser._actions
           if not a.option_strings]
    return opts, pos


def test_option_strings_match_jax_cli(monkeypatch):
    """The port's parser takes every option of scripts/evaluate.py, with
    its default, type and choices, but --platform, which --device
    replaces."""
    seen = {}
    parse = argparse.ArgumentParser.parse_args

    def grab(self, args=None, namespace=None):
        seen["parser"] = self
        return parse(self, [], namespace)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    monkeypatch.setattr(sys, "argv", ["evaluate.py"])
    _jax_cli().parse_args()
    want, want_pos = _options(seen["parser"])
    got, got_pos = _options(cli.build_parser())
    assert set(want) - set(got) == {"--platform"}
    assert set(got) - set(want) == {"--device"}
    for s in set(want) & set(got):
        assert got[s] == want[s], s
    assert got_pos == want_pos


def _exp_tree(root, ckpt):
    """Two experiments of one name; the newest holds the checkpoint as
    its newest `0*.npz` and decoys that fail to load beside it."""
    for exp, names in (("tiny_000", ["000.npz", "001.npz"]),
                       ("tiny_001", ["000.npz", "001.npz",
                                     "last_checkpoint.npz"])):
        d = root / "iSegNet" / exp / "checkpoints"
        d.mkdir(parents=True)
        for n in names:
            (d / n).write_bytes(b"not a checkpoint")
    newest = root / "iSegNet" / "tiny_001" / "checkpoints" / "001.npz"
    newest.write_bytes(ckpt.read_bytes())
    return newest


def test_exp_path_iou_analysis_and_model_name_match_jax(tmp_path, ckpt,
                                                        monkeypatch, capsys):
    """--exp-path iSegNet/tiny:0 resolves to the same file on both sides
    (the newest experiment's newest checkpoints/0*.npz); --iou-analysis
    writes the pickle without --save-ious; --model-name heads the table,
    and the merged shard table too."""
    newest = _exp_tree(tmp_path / "exps", ckpt)
    cfg = tmp_path / "config.yml"
    cfg.write_text(f"EXPS_PATH: {tmp_path / 'exps'}\n")
    ns = argparse.Namespace(config_path=str(cfg), exp_path="iSegNet/tiny:0")
    assert cli.resolve_exp_checkpoint(ns) == \
        _jax_cli().resolve_exp_checkpoint(ns) == str(newest)
    argv = ["--exp-path", "iSegNet/tiny:0", "--config-path", str(cfg),
            "--iou-analysis", "--model-name", "tiny-vpu", "--print-ious",
            "--datasets", "Synthetic", "--limit", "2", "--n-clicks",
            str(CLICKS), "--dtype", "float32"]
    want = run_jax(argv, tmp_path / "jax", monkeypatch, capsys)
    got = run_port(argv, tmp_path / "port", capsys)
    assert_same(got, want)
    header = "Eval results for model: tiny-vpu"
    assert header in got.splitlines() and header in want.splitlines()
    name = f"Synthetic_cvpr_NoBRS_{CLICKS}.pickle"
    assert_curves(curves(tmp_path / "port", name),
                  curves(tmp_path / "jax", name), length=CLICKS)
    pattern = str(tmp_path / "port" / "*.pickle")
    cli.main(["--merge-shards", pattern, "--model-name", "tiny-vpu"])
    merged = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["evaluate.py", "--merge-shards",
                                      pattern, "--model-name", "tiny-vpu"])
    _jax_cli().main()
    assert merged == capsys.readouterr().out
    assert header in merged.splitlines()


@pytest.mark.parametrize("limit", ["2", "-1"])
def test_clicks_limit_matches_jax(tmp_path, ckpt, monkeypatch, capsys,
                                  limit):
    """--clicks-limit K feeds the network the first K clicks (-1: all
    --n-clicks)."""
    argv = ["--clicks-limit", limit, "--save-ious", "--print-ious",
            "--iou-analysis"] + common(ckpt)
    want = run_jax(argv, tmp_path / "jax", monkeypatch, capsys)
    got = run_port(argv, tmp_path / "port", capsys)
    assert_same(got, want)
    name = f"Synthetic_cvpr_NoBRS_{CLICKS}.pickle"
    assert_curves(curves(tmp_path / "port", name),
                  curves(tmp_path / "jax", name))


def test_parity_matches_jax(tmp_path, ckpt, monkeypatch, capsys):
    """--parity without --dtype: f32 activations on both sides, full-f32
    products (JAX's "highest" precision; torch's float32 matmul precision
    "highest", no TF32)."""
    argv = ["--parity", "--save-ious", "--print-ious", "--checkpoint",
            str(ckpt), "--datasets", "Synthetic", "--limit", "2",
            "--n-clicks", str(CLICKS)]
    precision = jax.config.jax_default_matmul_precision
    torch_precision = torch.get_float32_matmul_precision()
    try:
        want = run_jax(argv, tmp_path / "jax", monkeypatch, capsys)
        torch.set_float32_matmul_precision("high")
        got = run_port(argv, tmp_path / "port", capsys)
        assert torch.get_float32_matmul_precision() == "highest"
        assert not torch.backends.cuda.matmul.allow_tf32
    finally:
        jax.config.update("jax_default_matmul_precision", precision)
        torch.set_float32_matmul_precision(torch_precision)
    assert_same(got, want)
    name = f"Synthetic_cvpr_NoBRS_{CLICKS}.pickle"
    assert_curves(curves(tmp_path / "port", name),
                  curves(tmp_path / "jax", name))


def _jax_panels(monkeypatch):
    """The arrays JAX's --vis-preds hands PIL to save, by file stem (the
    last save of a file is its stack)."""
    from PIL import Image
    saved = {}

    def save(self, fp, *a, **kw):
        saved[str(fp).rsplit("/", 1)[-1].split(".")[0]] = np.asarray(self)
    monkeypatch.setattr(Image.Image, "save", save)
    return saved


def _port_panels(folder):
    from PIL import Image
    return {p.stem: np.asarray(Image.open(p)) for p in
            sorted(folder.glob("*.png"))}


def test_vis_preds_matches_jax(tmp_path, ckpt, monkeypatch, capsys):
    """--vis-preds: one PNG per sample whose panel stack is the array JAX
    writes as a JPEG (a 2 x 3 panel row per click: 2 x 96 rows, 3 x 128
    columns), to a last unit in under 1e-4 of its bytes; with --batched 2
    the port takes the sequential path and writes the same files."""
    argv = ["--vis-preds", "--save-ious"] + common(ckpt, limit=2)
    with monkeypatch.context() as m:
        want_panels = _jax_panels(m)
        want = run_jax(argv, tmp_path / "jax", m, capsys)
    outs = []
    for extra in ([], ["--batched", "2"]):
        logs = tmp_path / f"port{len(extra)}"
        outs.append(run_port(argv + extra, logs, capsys))
    assert "throughput:" not in outs[1]
    for out in outs:
        assert noc_cells(out) == noc_cells(want)
    name = f"Synthetic_cvpr_NoBRS_{CLICKS}.pickle"
    jcurves = curves(tmp_path / "jax", name)
    assert_curves(curves(tmp_path / "port0", name), jcurves)
    got = _port_panels(tmp_path / "port0" / "vis" / "Synthetic")
    again = _port_panels(tmp_path / "port2" / "vis" / "Synthetic")
    assert sorted(got) == sorted(want_panels) == ["0", "1"]
    for k, c in zip(sorted(got), jcurves):
        a, b = got[k], want_panels[k]
        assert a.dtype == np.uint8 and a.shape == b.shape == (
            len(c) * 2 * 96, 3 * 128, 3)
        assert np.array_equal(a, again[k])
        # the probability map's colours round from probabilities within
        # 1e-5 of JAX's: a last-unit difference in a few pixels
        diff = np.abs(a.astype(int) - b.astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-4


def test_display_box_matches_jax():
    """The box --vis-preds draws for prompt_mode 1, on random masks."""
    jcli = _jax_cli()
    r = np.random.default_rng(0)
    for _ in range(20):
        gt = (r.random((40, 56)) < r.random()).astype(np.int32)
        probs = r.random((40, 56)).astype(np.float32)
        a = cli.display_box(gt, probs, 0.49)
        b = jcli._display_box(gt, probs, 0.49)
        assert (a is None and b is None) or np.array_equal(a, b)
    gt = np.zeros((40, 56), np.int32)
    assert cli.display_box(gt, np.zeros((40, 56)), 0.49) is None


def _latency(out: str):
    """--profile's printout: (summary dict, histogram lines, memory
    line)."""
    lines = out.splitlines()
    i = next(i for i, ln in enumerate(lines)
             if ln.startswith("per-click latency: "))
    summary = ast.literal_eval(lines[i][len("per-click latency: "):])
    hist = [ln for ln in lines if " ms:" in ln]
    memory = [ln for ln in lines if ln.startswith("memory: ")]
    return summary, hist, memory


def test_profile_matches_jax(tmp_path, ckpt, monkeypatch, capsys):
    """--profile times every click on the per-click path: the summary's
    keys, a count equal to the clicks run, a 10-bin histogram, a memory
    line (no CUDA device on the CPU), the round tracing's report, and the
    curves of the run without --profile."""
    argv = ["--profile", "--save-ious"] + common(ckpt, limit=2)
    want = run_jax(argv, tmp_path / "jax", monkeypatch, capsys)
    got = run_port(argv, tmp_path / "port", capsys)
    plain = run_port(argv[1:], tmp_path / "plain", capsys)
    assert "per-click latency:" not in plain
    name = f"Synthetic_cvpr_NoBRS_{CLICKS}.pickle"
    pc = curves(tmp_path / "port", name)
    assert_curves(pc, curves(tmp_path / "jax", name))
    for a, b in zip(pc, curves(tmp_path / "plain", name)):
        # the probability map's colours round from probabilities within
        # 1e-5 of JAX's: a last-unit difference in a few pixels
        diff = np.abs(a.astype(int) - b.astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-4
    assert noc_cells(got) == noc_cells(want) == noc_cells(plain)
    (s, hist, mem), (js, jhist, jmem) = _latency(got), _latency(want)
    assert s.keys() == js.keys() == {"count", "p50_ms", "p90_ms", "p99_ms",
                                     "mean_ms", "max_ms"}
    assert s["count"] == js["count"] == sum(map(len, pc))
    assert len(hist) == len(jhist) == 10
    assert sum(ln.count("#") for ln in hist) == s["count"]
    assert mem == ["memory: {}"] and len(jmem) == 1
    # the round tracing's report: every round eager on the CPU, one host
    # read a round
    assert f"spans [eager]: {s['count']} rounds, 1.00 host reads a round" \
        in got.splitlines()
    assert "spans [" not in plain
    with open(tmp_path / "port" / name, "rb") as f:
        assert pickle.load(f)["n_clicks"] == CLICKS
