"""The port's entry scripts `demo_train_eval_synthetic`, `hbm_fit` and
`bench_loader` against the JAX package's `scripts/*.py` (loaded by path).

- The CocoLvis-format writer of `bench_loader` writes JAX's files byte for
  byte (one interpreter: the same cv2 and PIL writers from the same draws).
- The demo's tiny config is the JAX script's; from JAX `init_vpu` weights
  carried across, its random-init NoC@50 / NoC@80 row, the over-limit
  counts and every per-click IoU equal JAX `evaluate_dataset`'s (IoU
  within 1e-5, the session tolerance of tests/test_torch_eval.py), on the
  demo's evaluation set; the same with the head's logit bias lowered, so
  that the clicks move the masks. The demo itself runs one epoch on the
  CPU from those weights.
- `hbm_fit` and `bench_loader` take exactly the JAX tools' flags with
  their defaults (`--device` added; `bench_loader --root` under the
  system's temporary directory), run on the CPU when asked, and raise
  without a card otherwise."""
import argparse
import copy
import importlib.util
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from pvpuformer_tpu.inference.datasets import SyntheticDataset as JSynthetic
from pvpuformer_tpu.inference.evaluation import (
    compute_noc_metric as jax_noc, evaluate_dataset as jax_evaluate)
from pvpuformer_tpu.inference.predictor import (Predictor as JPredictor,
                                                PredictorConfig as JConfig)
from pvpuformer_tpu.models.fpn import NeckConfig
from pvpuformer_tpu.models.seg_head import HeadConfig
from pvpuformer_tpu.models.two_way import TwoWayConfig
from pvpuformer_tpu.models.vit import ViTConfig
from pvpuformer_tpu.models.vpu import VPUConfig, init_vpu as jax_init_vpu
from pvpuformer_tpu_torch import bench_loader, hbm_fit
from pvpuformer_tpu_torch import demo_train_eval_synthetic as demo
from pvpuformer_tpu_torch.models import vpu
from test_torch_eval import two_torch_threads  # noqa: F401 (autouse)
from test_torch_model import port_model

REPO = Path(__file__).resolve().parents[1]
BIAS_SHIFT = -0.31          # tests/test_torch_eval.py's


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_cocolvis_writer_is_byte_equal_to_jax(tmp_path):
    _script("bench_loader").write_cocolvis_like(tmp_path / "jax", 3)
    bench_loader.write_cocolvis_like(tmp_path / "port", 3)
    files = {}
    for side in ("jax", "port"):
        root = tmp_path / side
        files[side] = {str(p.relative_to(root)): p.read_bytes()
                       for p in sorted(root.rglob("*")) if p.is_file()}
    assert len(files["port"]) == 7          # 3 images, 3 layers, the index
    assert files["port"] == files["jax"]


def jax_demo_config():
    """scripts/demo_train_eval_synthetic.py's model config."""
    crop = (64, 64)
    return VPUConfig(
        backbone=ViTConfig(img_size=crop, patch_size=(16, 16), embed_dim=64,
                           depth=4, num_heads=2),
        neck=NeckConfig(in_dim=64, out_dims=(16, 32, 48, 64), img_size=crop,
                        hide_dim=64,
                        two_way=TwoWayConfig(depth=3, embedding_dim=64,
                                             num_heads=4, mlp_dim=64)),
        head=HeadConfig(in_channels=(16, 32, 48, 64), channels=32,
                        d_model=64),
        num_max_points=6)


@pytest.fixture(scope="module")
def demo_weights():
    """(JAX params, the port model with the same weights), the JAX
    script's init: init_vpu(key(0))."""
    jcfg = jax_demo_config()
    params = jax_init_vpu(jax.random.key(0), jcfg)
    model, cfg = port_model(params, jcfg)
    assert cfg == demo.model_config()
    return params, model


def _jax_row(params, samples):
    """JAX's NoC row as the script computes it."""
    pcfg = JConfig(model=jax_demo_config(), target_size=(64, 64),
                   min_crop_size=32)
    with jax.default_matmul_precision("highest"):
        ious, _ = jax_evaluate(JSynthetic(n_samples=samples, hw=(64, 64),
                                          seed=123), JPredictor(params, pcfg),
                               max_iou_thr=0.80, max_clicks=demo.CLICKS)
    noc, _, over = jax_noc(ious, [0.5, 0.8], max_clicks=demo.CLICKS)
    return noc, over, ious


def _same_row(got, want):
    noc, over, ious = got
    jnoc, jover, jious = want
    assert list(noc) == list(jnoc) and list(over) == list(jover)
    assert len(ious) == len(jious)
    for a, b in zip(ious, jious):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def test_demo_random_row_matches_jax(demo_weights, capsys):
    """The demo at one epoch and two evaluation samples from JAX's init:
    its random row is JAX's; the trained rows are finite curves."""
    params, model = demo_weights
    lines = []
    curve, rows = demo.run(epochs=1, eval_samples=2, device="cpu",
                           model=copy.deepcopy(model),
                           log=lines.append)
    _same_row(rows["random"], _jax_row(params, 2))
    assert curve == []              # epochs are logged every 8th
    assert [ln.split(":")[0] for ln in lines] == ["random", "trained",
                                                  "trained+int8"]
    for name in ("trained", "trained+int8"):
        noc, over, ious = rows[name]
        assert len(ious) == 2 and all(np.isfinite(a).all() and
                                      0 <= a.min() and a.max() <= 1
                                      for a in ious)
    assert "NoC@50 " in lines[0] and ">=10@80" in lines[0]


def test_demo_row_with_moving_masks_matches_jax(demo_weights):
    """noc_row against JAX with the head's logit bias lowered, so that the
    random model's masks follow the clicks."""
    params, model = demo_weights
    params = jax.tree_util.tree_map(lambda x: x, params)
    seg = params["head"]["conv_seg"]
    seg["b"] = seg["b"] + BIAS_SHIFT
    shifted = copy.deepcopy(model)
    with torch.no_grad():
        shifted.head.conv_seg.b.add_(BIAS_SHIFT)
    got = demo.noc_row(shifted, False, samples=3, device="cpu")
    want = _jax_row(params, 3)
    _same_row(got, want)
    assert any(len(set(np.round(a, 4))) > 1 for a in got[2])


class _Captured(Exception):
    def __init__(self, parser):
        self.parser = parser


def _jax_parser(name, monkeypatch):
    """The parser the JAX tool builds in its main()."""
    def capture(self, *a, **k):
        raise _Captured(self)

    monkeypatch.setattr(sys, "argv", [f"{name}.py"])
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(_Captured) as got:
        _script(name).main()
    monkeypatch.undo()
    return got.value.parser


def _flags(parser):
    return {tuple(a.option_strings): (a.dest, a.default, a.type, a.nargs,
                                      a.const)
            for a in parser._actions if a.option_strings
            and a.dest != "help"}


@pytest.mark.parametrize("name,module", [("hbm_fit", hbm_fit),
                                         ("bench_loader", bench_loader)])
def test_flags_are_jax_flags(name, module, monkeypatch):
    want = _flags(_jax_parser(name, monkeypatch))
    got = _flags(module.build_parser())
    assert got.pop(("--device",))[:2] == ("device", "cuda")
    if name == "bench_loader":
        import tempfile
        assert want[("--root",)][1] == "/tmp/pvpu_loader_bench"
        assert got[("--root",)][1] == str(Path(tempfile.gettempdir())
                                          / "pvpu_loader_bench")
        got[("--root",)] = want[("--root",)]
    assert got == want


def test_entry_scripts_need_the_card_unless_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: hbm_fit.main([]),
                 lambda: bench_loader.main(["--root", str(tmp_path / "b")]),
                 lambda: demo.main([])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not (tmp_path / "b").exists()


def test_hbm_fit_runs_on_the_cpu(monkeypatch, capsys):
    """hbm_fit's steps at a tiny config on the CPU: every variant runs, no
    device memory is claimed, each line says what --remat means here."""
    monkeypatch.setattr(vpu, "vpu_base_config", lambda crop, dtype:
                        demo.model_config().replace(dtype=dtype))
    res = hbm_fit.main(["--device", "cpu", "--batch", "2", "--crop", "64",
                        "--iters", "1", "2", "--no-remat"])
    out = capsys.readouterr().out.splitlines()
    assert [r["num_iters"] for r in res] == [1, 2]
    assert all(r["fits"] and r["peak"] is None and r["step_ms"] > 0
               for r in res)
    assert [ln.split(":")[0] for ln in out] == ["ni=1 remat=False b2",
                                                "ni=2 remat=False b2"]
    assert all("not measured on the CPU" in ln and hbm_fit.REMAT_NOTE in ln
               for ln in out)
    batch = hbm_fit.synthetic_batch(2, 64, 6, "cpu")
    assert batch["image"].dtype == torch.bfloat16
    assert batch["points"].shape == (2, 12, 3)


def test_bench_loader_runs_on_the_cpu(tmp_path, capsys):
    """The on-disk record path through thread workers (this process runs
    JAX's threads, so it forks no process workers; tests/test_torch_data.py
    holds the Loader's process workers against JAX's)."""
    res = bench_loader.main(["--device", "cpu", "--images", "4", "--batches",
                             "1", "--batch-size", "4", "--workers", "1", "2",
                             "--types", "thread", "--root", str(tmp_path)])
    out = capsys.readouterr().out
    assert (tmp_path / "train" / "hannotation.pickle").is_file()
    assert res[("thread", 1)] > 0 and res[("thread", 2)] > 0
    assert res["demand"] == pytest.approx(
        32 / (bench_loader.RECIPE_STEP_MS / 1e3))
    assert "x the recipe's demand" in out and "ms/record" in out
