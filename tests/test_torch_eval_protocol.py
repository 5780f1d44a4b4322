"""The port's evaluation CLI under the protocol flags of the JAX CLI,
against `scripts/evaluate.py` on one JAX-format checkpoint (the tiny config
of tests/test_torch_eval.py, f32, Synthetic, 3 clicks): the repo
launcher's command (run_evaluate_vpu.sh), the CFR cascade (sequential and
--batched 2), a box session with the cascade, --eval-ritm, --eval-mode
fixedH,W and a ViT crop that is not a multiple of the patch.

Pass condition: equal NoC cells and mIoU@k lines, per-click IoU within
1e-5 (the session tolerance of tests/test_torch_predictor.py). Each JAX
run jits its click scan once per PredictorConfig; the checkpoint is shared
by the module."""
import pickle
import sys

import jax
import numpy as np
import pytest

from pvpuformer_tpu.utils.serialization import save_checkpoint
from pvpuformer_tpu_torch import evaluate as cli
from test_torch_eval import _jax_cli, eval_weights
from test_torch_eval import two_torch_threads  # noqa: F401 (autouse)

CLICKS = 3
LAUNCHER = ["NoBRS", "--cf-n=0", "--acf", "--iou-analysis", "--save-ious",
            "--print-ious"]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    params, jcfg, _ = eval_weights()
    path = tmp_path_factory.mktemp("ckpt") / "tiny.npz"
    save_checkpoint(path, params, jcfg)
    return path


def common(ckpt, limit: int = 3):
    return ["--checkpoint", str(ckpt), "--datasets", "Synthetic", "--limit",
            str(limit), "--n-clicks", str(CLICKS), "--dtype", "float32"]


def run_jax(argv, logs, monkeypatch, capsys) -> str:
    """scripts/evaluate.py in process; its standard output."""
    monkeypatch.setattr(sys, "argv", ["evaluate.py"] + argv + [
        "--logs-path", str(logs)])
    with jax.default_matmul_precision("highest"):
        _jax_cli().main()
    return capsys.readouterr().out


def run_port(argv, logs, capsys) -> str:
    cli.main(argv + ["--device", "cpu", "--logs-path", str(logs)])
    return capsys.readouterr().out


def noc_cells(out: str, mode: str = "NoBRS"):
    """The results row's NoC cells (not its SPC and Time cells)."""
    row = next(line for line in out.splitlines()
               if line.startswith("|") and f" {mode} " in line)
    return row.split("|")[1:-3]


def miou_lines(out: str):
    return [line for line in out.splitlines() if line.startswith("mIoU@k")]


def curves(logs, name):
    with open(logs / name, "rb") as f:
        return pickle.load(f)["all_ious"]


def assert_same(got: str, want: str, mode: str = "NoBRS"):
    assert noc_cells(got, mode) == noc_cells(want, mode)
    assert miou_lines(got) == miou_lines(want)


def assert_curves(got, want, tol: float = 1e-5, length=None):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert a.shape == b.shape
        if length is not None:
            assert a.shape == (length,)
        np.testing.assert_allclose(a, b, atol=tol)


def test_launcher_command_matches_jax(tmp_path, ckpt, monkeypatch, capsys):
    """run_evaluate_vpu.sh's flags: target IoU 1.01, so every session runs
    all its clicks; the pickle is named by --eval-mode's default."""
    argv = LAUNCHER + common(ckpt)
    want = run_jax(argv, tmp_path / "jax", monkeypatch, capsys)
    got = run_port(argv, tmp_path / "port", capsys)
    assert_same(got, want)
    assert len(miou_lines(got)) == 1
    name = f"Synthetic_cvpr_NoBRS_{CLICKS}.pickle"
    assert_curves(curves(tmp_path / "port", name),
                  curves(tmp_path / "jax", name), length=CLICKS)


def test_cascade_sequential_and_batched_match_jax(tmp_path, ckpt,
                                                  monkeypatch, capsys):
    """--cf-n 2 --cf-click 2 --acf: three forwards a click for the first
    two clicks, adaptive; the port's --batched 2 (the last chunk padded)
    gives JAX's sequential curves too."""
    argv = ["--cf-n", "2", "--cf-click", "2", "--acf", "--save-ious",
            "--print-ious", "--iou-analysis"] + common(ckpt)
    want = run_jax(argv, tmp_path / "jax", monkeypatch, capsys)
    name = f"Synthetic_cvpr_NoBRS_{CLICKS}.pickle"
    for extra in ([], ["--batched", "2"]):
        logs = tmp_path / f"port{len(extra)}"
        got = run_port(argv + extra, logs, capsys)
        assert ("throughput:" in got) == bool(extra)
        assert_same(got, want)
        assert_curves(curves(logs, name), curves(tmp_path / "jax", name))


def test_box_session_with_cascade_matches_jax(tmp_path, ckpt, monkeypatch,
                                              capsys):
    """--prompt-mode 1 --cf-n 1: the click's box draws are made once and
    reused by both forwards, as JAX's per-click key is."""
    argv = ["--prompt-mode", "1", "--cf-n", "1", "--save-ious",
            "--print-ious", "--iou-analysis"] + common(ckpt)
    want = run_jax(argv, tmp_path / "jax", monkeypatch, capsys)
    got = run_port(argv, tmp_path / "port", capsys)
    assert_same(got, want)
    name = f"Synthetic_cvpr_NoBRS_{CLICKS}.pickle"
    assert_curves(curves(tmp_path / "port", name),
                  curves(tmp_path / "jax", name))


def test_eval_ritm_matches_jax(tmp_path, ckpt, monkeypatch, capsys):
    """--eval-ritm: zoom-in target 400 x 400 (the tiny ViT's grid 25 x 25,
    no windows), skip_clicks=1."""
    argv = ["--eval-ritm", "--save-ious", "--print-ious",
            "--iou-analysis"] + common(ckpt)
    want = run_jax(argv, tmp_path / "jax", monkeypatch, capsys)
    got = run_port(argv, tmp_path / "port", capsys)
    assert_same(got, want)
    name = f"Synthetic_cvpr_NoBRS_{CLICKS}.pickle"
    assert_curves(curves(tmp_path / "port", name),
                  curves(tmp_path / "jax", name))


def test_fixed_eval_mode_matches_jax(tmp_path, ckpt, monkeypatch, capsys):
    """--eval-mode fixed96,128 fixes the zoom-in target and names the
    pickle."""
    argv = ["--eval-mode", "fixed96,128", "--save-ious",
            "--print-ious"] + common(ckpt)
    want = run_jax(argv, tmp_path / "jax", monkeypatch, capsys)
    got = run_port(argv, tmp_path / "port", capsys)
    assert_same(got, want)
    name = f"Synthetic_fixed96,128_NoBRS_{CLICKS}.pickle"
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == [name]
    assert_curves(curves(tmp_path / "port", name),
                  curves(tmp_path / "jax", name))


@pytest.mark.parametrize("args,name,crop,skip", [
    ([], "DAVIS", (672, 672), -1), ([], "GrabCut", (448, 448), -1),
    (["--eval-ritm"], "DAVIS", (600, 600), 1),
    (["--eval-ritm"], "GrabCut", (400, 400), 1),
    (["--eval-mode", "fixed320"], "DAVIS", (320, 320), -1),
    (["--eval-mode", "fixed448,672", "--eval-ritm"], "DAVIS", (448, 672),
     -1)])
def test_protocol_crop(args, name, crop, skip):
    """The crop and skip_clicks each protocol gives a dataset (a fixed
    crop wins over --eval-ritm, as in scripts/evaluate.py:306-319)."""
    assert cli.protocol_crop(cli.parse_args(args), name, (448, 448)) == \
        (crop, skip)


def _fake_davis(root):
    """Two 80 x 96 DAVIS-layout samples (img/*.jpg, gt/*.png)."""
    from PIL import Image
    r = np.random.default_rng(0)
    (root / "img").mkdir(parents=True)
    (root / "gt").mkdir()
    for i in range(2):
        Image.fromarray(r.integers(0, 255, (80, 96, 3), dtype=np.uint8)).save(
            root / "img" / f"s{i}.jpg")
        gt = np.zeros((80, 96), np.uint8)
        gt[20:60, 30:70] = 255
        Image.fromarray(gt).save(root / "gt" / f"s{i}.png")


def test_vit_crop_600_raises_on_both_sides(tmp_path, ckpt, monkeypatch,
                                           capsys):
    """--eval-ritm on DAVIS zooms to 600 x 600, which a patch of 16 does not
    tile: JAX's patch embedding fails at the first forward, the port
    refuses the crop before it builds the predictor. Neither prints a
    result."""
    _fake_davis(tmp_path / "davis")
    cfg = tmp_path / "config.yml"
    cfg.write_text(f"DAVIS_PATH: {tmp_path / 'davis'}\n")
    argv = ["--checkpoint", str(ckpt), "--datasets", "DAVIS", "--n-clicks",
            "2", "--dtype", "float32", "--eval-ritm", "--config-path",
            str(cfg)]
    with pytest.raises(Exception) as e:
        run_jax(argv, tmp_path / "jax", monkeypatch, capsys)
    assert not isinstance(e.value, SystemExit)
    assert "NoC@" not in capsys.readouterr().out
    with pytest.raises(ValueError, match=r"\(600, 600\) is not a multiple "
                                         r"of the ViT patch \(16, 16\)"):
        run_port(argv, tmp_path / "port", capsys)
    assert "NoC@" not in capsys.readouterr().out
