"""The port's evaluation surface against the JAX package's (tiny config, f32,
the CPU): `evaluate_dataset` on the Synthetic dataset, the NoC / mIoU /
timing metrics and the results table, the host-side clicker, the datasets,
shard-pickle merging and the CLI, `python -m pvpuformer_tpu_torch.evaluate`,
against `scripts/evaluate.py` on one checkpoint.

Click sequences identical and per-click IoU within 1e-5 of JAX's (the
session tolerance of tests/test_torch_predictor.py); metrics computed from
each side's own curves identical. The weights are JAX `init_vpu`'s with the
head's logit bias lowered by 0.31: the random model's probabilities then
straddle the 0.49 threshold (unshifted, every pixel is foreground and every
IoU curve is flat), so the masks, and the IoUs, follow the clicks."""
import importlib.util
import pickle
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from pvpuformer_tpu.inference import clicker as jclicker
from pvpuformer_tpu.inference import datasets as jdatasets
from pvpuformer_tpu.inference import evaluation as jeval
from pvpuformer_tpu.inference.predictor import (Predictor as JPredictor,
                                                PredictorConfig as JConfig)
from pvpuformer_tpu.models.vpu import init_vpu as jax_init_vpu
from pvpuformer_tpu.utils.serialization import (config_to_dict,
                                                save_checkpoint)
from pvpuformer_tpu_torch import evaluate as cli
from pvpuformer_tpu_torch.inference import clicker, datasets, evaluation
from pvpuformer_tpu_torch.inference.predictor import Predictor
from pvpuformer_tpu_torch.ops.edt import next_click_from_error
from pvpuformer_tpu_torch.utils.serialization import config_from_dict
from test_models import tiny_cfg
from test_torch_model import port_model

REPO = Path(__file__).resolve().parents[1]
CLICKS = 3
BIAS_SHIFT = -0.31


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    """Two intra-op threads for torch in this module: the suite runs in
    several processes at once, and torch's default of one thread per core
    in each of them oversubscribes the CPU (the tiny model's small ops then
    spend most of their time waiting on threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def eval_weights():
    """(JAX params, JAX config, port model): tiny_cfg, the logit bias
    lowered by BIAS_SHIFT."""
    jcfg = tiny_cfg()
    params = jax_init_vpu(jax.random.key(0), jcfg)
    seg = params["head"]["conv_seg"]
    seg["b"] = seg["b"] + BIAS_SHIFT
    return params, jcfg, port_model(params, jcfg)[0]


class Concat:
    """Datasets one after the other."""

    def __init__(self, parts):
        self.index = [(p, i) for p in parts for i in range(len(p))]

    def __len__(self):
        return len(self.index)

    def get_sample(self, i):
        part, j = self.index[i]
        return part.get_sample(j)


class Recording(Predictor):
    """The port's Predictor, keeping each session's final click slots."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.log = []

    def run_clicks(self, num_clicks):
        out = super().run_clicks(num_clicks)
        self.log.append(self.clicks)
        return out


class JRecording(JPredictor):
    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.log = []

    def run_clicks(self, num_clicks):
        out = super().run_clicks(num_clicks)
        self.log.append(np.asarray(self.clicks))
        return out


@pytest.fixture(scope="module")
def runs():
    """Both sides' evaluate_dataset on Synthetic(3, (64, 64)), 3 clicks."""
    params, jcfg, model = eval_weights()
    jpc = JConfig(model=jcfg, target_size=(64, 64), min_crop_size=32)
    cfg = config_from_dict(config_to_dict(jpc))
    jpred = JRecording(params, jpc)
    with jax.default_matmul_precision("highest"):
        jcurves, _ = jeval.evaluate_dataset(
            jdatasets.SyntheticDataset(3, (64, 64)), jpred, max_iou_thr=0.95,
            max_clicks=CLICKS)
    pred = Recording(model, cfg, device="cpu")
    curves, elapsed = evaluation.evaluate_dataset(
        datasets.SyntheticDataset(3, (64, 64)), pred, max_iou_thr=0.95,
        max_clicks=CLICKS)
    assert elapsed > 0
    return (jcurves, jpred.log), (curves, pred.log)


def test_evaluate_dataset_matches_jax(runs):
    (jcurves, jclicks), (curves, clicks) = runs
    assert len(curves) == len(jcurves) == 3
    for a, b in zip(clicks, jclicks):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(curves, jcurves):
        assert a.dtype == np.float32 and a.shape == b.shape == (CLICKS,)
        np.testing.assert_allclose(a, b, atol=1e-5)
    # the masks follow the clicks: the curves are not flat
    assert max(np.ptp(c) for c in curves) > 1e-3


def test_metrics_and_table_match_jax(runs):
    (jcurves, _), (curves, _) = runs
    levels = np.quantile(np.concatenate(curves), [0.2, 0.5, 0.8])
    for thrs in ([0.8, 0.85, 0.9, 0.95], list(levels) + [0.5]):
        got = evaluation.compute_noc_metric(curves, thrs, max_clicks=CLICKS)
        want = jeval.compute_noc_metric(jcurves, thrs, max_clicks=CLICKS)
        assert [list(v) for v in got] == [list(v) for v in want]
        elapsed = 12.5                    # the same time on both sides
        spc, spi = evaluation.get_time_metrics(curves, elapsed)
        assert (spc, spi) == jeval.get_time_metrics(jcurves, elapsed)
        for model_name in (None, "tiny"):
            assert evaluation.get_results_table(
                got[0], got[2], "NoBRS", "Synthetic", spc, elapsed, CLICKS,
                model_name) == jeval.get_results_table(
                want[0], want[2], "NoBRS", "Synthetic", spc, elapsed, CLICKS,
                model_name)
    np.testing.assert_allclose(
        evaluation.mean_iou_per_click(curves, max_clicks=5),
        jeval.mean_iou_per_click(jcurves, max_clicks=5), atol=1e-5)
    gt = np.random.default_rng(0).integers(-1, 2, (20, 30))
    pm = np.random.default_rng(1).random((20, 30)) > 0.5
    assert evaluation.get_iou(gt, pm) == jeval.get_iou(gt, pm)


def _masks(seed, h=40, w=56):
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    gt = np.zeros((h, w), np.int32)
    cy, cx, ry, rx = r.integers(8, 32), r.integers(8, 48), \
        r.integers(4, 14), r.integers(4, 20)
    gt[((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1] = 1
    gt[r.random((h, w)) < 0.03] = -1                    # ignore pixels
    pred = np.zeros((h, w), bool)
    py, px = r.integers(0, h - 10), r.integers(0, w - 10)
    pred[py:py + r.integers(3, 20), px:px + r.integers(3, 30)] = True
    return gt, pred


@pytest.mark.parametrize("seed", range(6))
def test_clicker_matches_device_oracle_and_jax(seed):
    """Five clicks of the host Clicker (each excluding the clicked pixels)
    equal JAX's Clicker's and the device oracle's (next_click_from_error)."""
    gt, pred = _masks(seed)
    ours, theirs = clicker.Clicker(gt), jclicker.Clicker(gt)
    clicked = np.zeros(gt.shape, bool)
    for _ in range(5):
        ours.make_next_click(pred)
        theirs.make_next_click(pred)
        c = ours.get_clicks()[-1]
        care = gt != -1
        dev = next_click_from_error(
            torch.from_numpy((gt == 1) & ~pred & care),
            torch.from_numpy((gt != 1) & pred & care),
            torch.from_numpy(~clicked))
        assert (c.is_positive, c.coords) == (bool(dev[0]),
                                             (int(dev[1]), int(dev[2])))
        clicked[c.coords] = True
    assert [(c.is_positive, c.coords, c.indx) for c in ours.get_clicks()] == \
        [(c.is_positive, c.coords, c.indx) for c in theirs.get_clicks()]
    assert (ours.num_pos_clicks, ours.num_neg_clicks, len(ours)) == \
        (theirs.num_pos_clicks, theirs.num_neg_clicks, len(theirs))
    state = ours.get_state()
    ours.set_state(state[:2])
    assert len(ours) == 2 and ours.get_clicks()[1].coords == state[1].coords


@pytest.mark.parametrize("kw", [dict(), dict(n_samples=3, hw=(64, 64)),
                                dict(n_samples=2, hw=(300, 500), seed=9),
                                dict(n_samples=2, hw=(448, 448), seed=3)],
                         ids=["default", "64", "300x500", "448"])
def test_synthetic_dataset_bytes_equal_jax(kw):
    ours = datasets.get_dataset("Synthetic", **kw)
    theirs = jdatasets.get_dataset("Synthetic", **kw)
    assert len(ours) == len(theirs) and ours.name == "SyntheticDataset"
    for i in range(len(ours)):
        a, b = ours.get_sample(i), theirs.get_sample(i)
        assert a.image.tobytes() == b.image.tobytes()
        assert a.objects_ids == b.objects_ids
        for k in a.objects_ids:
            assert a.gt_mask(k).dtype == b.gt_mask(k).dtype
            assert a.gt_mask(k).tobytes() == b.gt_mask(k).tobytes()


def _jax_cli():
    """scripts/evaluate.py as a module (it imports the JAX package)."""
    spec = importlib.util.spec_from_file_location(
        "jax_evaluate_cli", REPO / "scripts" / "evaluate.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_merge_shard_pickles_round_trip(tmp_path, capsys):
    r = np.random.default_rng(0)
    paths = []
    for i, (name, n) in enumerate([("GrabCut", 3), ("GrabCut", 2),
                                   ("Berkeley", 4)]):
        d = {"all_ious": [r.random(r.integers(1, 6)).astype(np.float32)
                          for _ in range(n)], "dataset": name,
             "mode": "NoBRS", "elapsed": 1.5 + i, "n_clicks": 5}
        paths.append(str(tmp_path / f"{name}_s{i}of3.pickle"))
        with open(paths[-1], "wb") as f:
            pickle.dump(d, f)
    got = evaluation.merge_shard_pickles(paths)
    want = jeval.merge_shard_pickles(paths)
    assert got.keys() == want.keys()
    for k in got:
        assert {f: v for f, v in got[k].items() if f != "all_ious"} == \
            {f: v for f, v in want[k].items() if f != "all_ious"}
        assert all(np.array_equal(a, b) for a, b in
                   zip(got[k]["all_ious"], want[k]["all_ious"]))
    assert got[("GrabCut", "NoBRS")]["shards"] == 2
    assert len(got[("GrabCut", "NoBRS")]["all_ious"]) == 5
    pattern = str(tmp_path / "*.pickle")
    cli.main(["--merge-shards", pattern])
    ours = capsys.readouterr().out
    _jax_cli().merge_shards(pattern)
    assert ours == capsys.readouterr().out
    assert "NoC@85%" in ours and "2 shard(s)" in ours


def _table_row(out: str):
    """The results row without its SPC and Time cells (wall clock)."""
    row = next(line for line in out.splitlines()
               if line.startswith("|") and "NoBRS" in line)
    return row.split("|")[1:-3]


def test_cli_matches_jax_cli_on_a_checkpoint(tmp_path, capsys, monkeypatch):
    """Both CLIs on one JAX-format checkpoint, f32: the same NoC row and
    mIoU@k line; the port's --batched 2 prints the same."""
    params, jcfg, _ = eval_weights()
    ckpt = tmp_path / "tiny.npz"
    save_checkpoint(ckpt, params, jcfg)
    common = ["--checkpoint", str(ckpt), "--datasets", "Synthetic",
              "--limit", "3", "--n-clicks", str(CLICKS), "--dtype", "float32",
              "--print-ious", "--save-ious"]
    monkeypatch.setattr(sys, "argv", ["evaluate.py"] + common + [
        "--logs-path", str(tmp_path / "jax")])
    with jax.default_matmul_precision("highest"):
        _jax_cli().main()
    want = capsys.readouterr().out
    outs = []
    for extra in ([], ["--batched", "2"]):
        cli.main(common + extra + ["--device", "cpu", "--logs-path",
                                   str(tmp_path / f"port{len(extra)}")])
        outs.append(capsys.readouterr().out)
    miou = [line for line in want.splitlines() if line.startswith("mIoU@k")]
    assert len(miou) == 1
    for out in outs:
        assert _table_row(out) == _table_row(want)
        assert [line for line in out.splitlines()
                if line.startswith("mIoU@k")] == miou
    with open(tmp_path / "jax" / f"Synthetic_cvpr_NoBRS_{CLICKS}.pickle",
              "rb") as f:
        jres = pickle.load(f)
    for tag in ("port0", "port2"):
        with open(tmp_path / tag / f"Synthetic_cvpr_NoBRS_{CLICKS}.pickle",
                  "rb") as f:
            res = pickle.load(f)
        assert res.keys() == jres.keys()
        for a, b in zip(res["all_ious"], jres["all_ious"]):
            np.testing.assert_allclose(a, b, atol=1e-5)


def test_cli_random_weights_sequential_and_batched(tmp_path, capsys):
    """The shipped ViT-B@448 with seeded random weights on the CPU, one
    session at a time and two per batch: the same table and curves."""
    curves = []
    for extra in ([], ["--batched", "2"]):
        logs = tmp_path / f"b{len(extra)}"
        cli.main(["--device", "cpu", "--random-weights", "--datasets",
                  "Synthetic", "--limit", "2", "--n-clicks", "2",
                  "--dtype", "float32", "--save-ious", "--logs-path",
                  str(logs)] + extra)
        out = capsys.readouterr().out
        assert "NoC@90%" in out and "| Synthetic |" in out
        assert ("throughput:" in out) == bool(extra)
        with open(logs / "Synthetic_cvpr_NoBRS_2.pickle", "rb") as f:
            curves.append(pickle.load(f)["all_ious"])
    assert len(curves[0]) == len(curves[1]) == 2
    for a, b in zip(*curves):
        assert a.shape == (2,) and np.all((a >= 0) & (a <= 1))
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", [1, 2])
def test_cli_batched_prompt_modes_match_sequential(tmp_path, capsys, mode):
    """Box / scribble NoC evaluation on a checkpoint, f32, one session at a
    time and two per batch (the last chunk padded): the same table row,
    mIoU@k line and curves."""
    params, jcfg, _ = eval_weights()
    ckpt = tmp_path / "tiny.npz"
    save_checkpoint(ckpt, params, jcfg)
    outs, curves = [], []
    for extra in ([], ["--batched", "2"]):
        logs = tmp_path / f"b{len(extra)}"
        cli.main(["--checkpoint", str(ckpt), "--datasets", "Synthetic",
                  "--limit", "3", "--n-clicks", str(CLICKS), "--dtype",
                  "float32", "--prompt-mode", str(mode), "--print-ious",
                  "--save-ious", "--device", "cpu", "--logs-path",
                  str(logs)] + extra)
        outs.append(capsys.readouterr().out)
        with open(logs / f"Synthetic_cvpr_NoBRS_{CLICKS}.pickle", "rb") as f:
            curves.append(pickle.load(f)["all_ious"])
    assert ("throughput:" in outs[1]) and ("throughput:" not in outs[0])
    assert _table_row(outs[0]) == _table_row(outs[1])
    assert ([line for line in outs[0].splitlines() if line.startswith("mIoU@k")]
            == [line for line in outs[1].splitlines()
                if line.startswith("mIoU@k")])
    assert len(curves[0]) == len(curves[1]) == 3
    for a, b in zip(*curves):
        np.testing.assert_array_equal(a, b)


def test_cli_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        cli.main(["--random-weights", "--datasets", "Synthetic"])


@pytest.mark.parametrize("argv,message", [
    (["f-BRS-B", "--int8"], "NoBRS only"),
    (["--batched", "2", "f-BRS-B"], "NoBRS only"),
    (["SAM", "--batched", "2"], "NoBRS only"),
    (["--batched", "2", "--eval-mesh", "2", "--vis-preds"],
     "takes no --eval-mesh"),
    (["RITM"], "is not one of")])
def test_cli_refuses_what_is_not_ported(argv, message, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["--random-weights", "--device", "cpu"] + argv)
    assert e.value.code == 2
    assert message in capsys.readouterr().err


def test_pos_embed_resampled_like_jax():
    """At another crop the CLI resamples the position embedding as the JAX
    CLI does (bicubic, align_corners=False)."""
    from pvpuformer_tpu.utils.torch_ingest import interpolate_pos_embed_np
    params, jcfg, model = eval_weights()
    mcfg = model.cfg
    out, ocfg = cli.at_crop(model, mcfg, (96, 128))
    assert ocfg.backbone.grid_size == (6, 8)
    want = interpolate_pos_embed_np(np.asarray(
        params["backbone"]["pos_embed"]), (4, 4), (6, 8))
    np.testing.assert_allclose(out.backbone.pos_embed.detach().numpy(), want,
                               atol=1e-6)
    same, _ = cli.at_crop(model, mcfg, mcfg.backbone.img_size)
    assert same is not model
    for a, b in zip(same.state_dict().values(), model.state_dict().values()):
        assert torch.equal(a, b)
