"""The port's legacy model families (pvpuformer_tpu_torch/models/zoo)
against the JAX package's, f32 on the CPU, on the same weights and inputs.

Weights: the JAX `init_*` tree of each tiny config (tests/test_zoo.py's,
and Swin-UNet's of test_swin_unet_forward), its structure read with
`jax.eval_shape` (no JAX random op runs: the eager JAX inits take 7-28 s a
family on a CPU), its leaves drawn from a numpy seed at the inits'
scales, with frozen-BN statistics away from the identity (var in
[0.5, 2], mean and bias ~ N(0, 0.1), scale ~ 1 + N(0, 0.1)) so that the
BN folding is exercised. The port reads them as a JAX checkpoint written by
`save_checkpoint` (a pure rename, `params_from_numpy`).

Tolerances: each family's f32 forward within 2e-5 of the jitted JAX
forward relative to the largest logit (max |d| / max(1, max |JAX|);
measured at most 2.6e-6); the HRNet session's clicks identical to JAX
`click_scan`'s and per-click IoU within 1e-5 (measured 0); the evaluation
CLI's table row and IoU curves equal to scripts/evaluate.py's (IoU
within 1e-5)."""
import importlib.util
import pickle
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvpuformer_tpu.inference import predictor as jpred
from pvpuformer_tpu.models import registry as jreg
from pvpuformer_tpu.models.zoo.deeplab import DeeplabISConfig
from pvpuformer_tpu.models.zoo.hrnet import HRNetISConfig
from pvpuformer_tpu.models.zoo.swin_unet import SwinUNetISConfig
from pvpuformer_tpu.utils.serialization import (config_to_dict, flatten_tree,
                                                save_checkpoint)
from pvpuformer_tpu_torch import evaluate as cli
from pvpuformer_tpu_torch.inference import predictor as tpred
from pvpuformer_tpu_torch.models import registry
from pvpuformer_tpu_torch.utils.serialization import (config_from_dict,
                                                      load_checkpoint)
from test_zoo import TINY_CONFIGS

REPO = Path(__file__).resolve().parents[1]
FWD_TOL = 2e-5
ZOO_CONFIGS = TINY_CONFIGS + [
    SwinUNetISConfig(embed_dim=16, depths=(1, 1, 1, 1),
                     num_heads=(1, 2, 4, 8), window=4)]


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    """Two intra-op threads for torch in this module (the suite runs in
    several processes at once; tests/test_torch_eval.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _leaf(r: np.random.Generator, name, shape) -> np.ndarray:
    if name == "var":
        return r.uniform(0.5, 2.0, shape)
    if name in ("mean", "bias"):
        return r.normal(0.0, 0.1, shape)
    if name == "scale":
        return np.full(shape, 0.05) if not shape else \
            1.0 + r.normal(0.0, 0.1, shape)
    if len(shape) >= 2:
        bound = np.sqrt(3.0 / max(1, int(np.prod(shape[:-1]))))
        return r.uniform(-bound, bound, shape)
    return r.normal(0.0, 0.02, shape)


def jax_weights(cfg, seed: int = 0):
    """The JAX `init_*` tree of `cfg` (jax.eval_shape) with numpy-drawn
    leaves (module docstring), as JAX arrays."""
    shapes = jax.eval_shape(lambda k: jreg.init_for(cfg)(k, cfg),
                            jax.random.key(0))
    r = np.random.default_rng(seed)

    def leaf(path, s):
        name = getattr(path[-1], "key", None)
        return jnp.asarray(_leaf(r, name, s.shape).astype(np.float32))
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def port_family(params, jcfg):
    """JAX params + config -> (the port's module with the same weights, its
    config): the flat checkpoint leaves renamed, loaded strictly."""
    cfg = config_from_dict(config_to_dict(jcfg))
    return registry.load(flatten_tree(params), cfg), cfg


def rel_err(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def forward_inputs(b: int = 2, hw=(64, 64), n: int = 6, seed: int = 0):
    r = np.random.default_rng(seed)
    img = r.uniform(size=(b, *hw, 4)).astype(np.float32)
    pts = np.full((b, 2 * n, 3), -1.0, np.float32)
    pts[0, 0] = (30, 30, 0)
    pts[-1, 0] = (40.5, 12.25, 0)
    pts[-1, n] = (10, 50, 1)
    return img, pts


RESNET34 = DeeplabISConfig(backbone="resnet34", ch=32)


def family_id(cfg) -> str:
    name = type(cfg).__name__
    return name + "-resnet34" if cfg == RESNET34 else name


@pytest.mark.parametrize("jcfg", ZOO_CONFIGS + [RESNET34], ids=family_id)
def test_zoo_forward_matches_jax(tmp_path, jcfg):
    """Through a JAX checkpoint: the port's load_checkpoint reads every
    leaf into the family's tree (strictly), and the forward matches."""
    params = jax_weights(jcfg)
    save_checkpoint(tmp_path / "z.npz", params, jcfg)
    flat, cfg, _, _ = load_checkpoint(tmp_path / "z.npz")
    assert type(cfg).__name__ == type(jcfg).__name__
    model = registry.load(flat, cfg)
    img, pts = forward_inputs()
    fwd = jreg.forward_for(jcfg)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda p, i, q: fwd(p, jcfg, i, q))(
            params, jnp.asarray(img), jnp.asarray(pts))
    with torch.no_grad():
        got = registry.forward_for(cfg)(model, cfg, torch.from_numpy(img),
                                        torch.from_numpy(pts))
    for key in ("instances", "instances_aux"):
        if want[key] is None:
            assert got[key] is None
            continue
        w = np.asarray(want[key])
        assert got[key].shape == w.shape == (2, 64, 64, 1)
        assert rel_err(got[key].numpy(), w) <= FWD_TOL, key


def _session_sample():
    r = np.random.default_rng(7)
    image = (r.uniform(size=(60, 90, 3)) * 255).astype(np.uint8)
    gt = np.zeros((60, 90), np.float32)
    gt[14:50, 18:46] = 1.0
    gt[14:16, 18:46] = -1.0                    # an ignore band
    return image, gt


def hrnet_session_weights(jcfg, shift: float = -2.0):
    """HRNet weights whose masks follow the clicks: the classifier's bias
    lowered by 2 (unshifted, the random model's mask hardly moves: IoU
    0.178 at every click, four negative clicks in one spot; shifted, IoU
    0.400 -> 0.397 over one positive and four negative clicks)."""
    params = jax_weights(jcfg, seed=1)
    params["ocr"]["cls"]["b"] = params["ocr"]["cls"]["b"] + shift
    return params


def test_hrnet_click_scan_matches_jax():
    """One zoo session (JAX's own zoo session test is slow-marked): HRNet
    tiny through the fused predictor, 5 clicks, against JAX click_scan."""
    jcfg = HRNetISConfig(width=8, small=True, ocr_width=16, num_max_points=6)
    params = hrnet_session_weights(jcfg)
    model, mcfg = port_family(params, jcfg)
    jpc = jpred.PredictorConfig(model=jcfg, target_size=(64, 64),
                                min_crop_size=32)
    cfg = config_from_dict(config_to_dict(jpc))
    image, gt = _session_sample()
    with jax.default_matmul_precision("highest"):
        jst, jious = jpred.click_scan(params, jpc, jpred.init_session(
            image, gt, 6, (64, 128)), 5)
    tst, tious = tpred.click_scan(model, cfg, tpred.init_session(
        image, gt, 6, (64, 128), device="cpu"), 5)
    np.testing.assert_array_equal(tst.points.numpy(), np.asarray(jst.points))
    np.testing.assert_allclose(tious.numpy(), np.asarray(jious), atol=1e-5)
    np.testing.assert_array_equal(tst.roi.numpy(), np.asarray(jst.roi))
    np.testing.assert_allclose(tst.prev_probs.numpy(),
                               np.asarray(jst.prev_probs), atol=1e-5)


@pytest.mark.parametrize("jcfg", ZOO_CONFIGS, ids=family_id)
def test_every_family_runs_a_predictor_session(jcfg):
    """The predictor dispatches every family through the registry with
    JAX's keyword set (the zoo forwards take and ignore the prompt
    keywords): a 2-click session and a user click, finite, on the CPU."""
    model, mcfg = port_family(jax_weights(jcfg), jcfg.replace(num_max_points=4))
    pred = tpred.Predictor(model, tpred.PredictorConfig(
        model=mcfg, target_size=(64, 64), min_crop_size=32), device="cpu")
    image, gt = _session_sample()
    pred.set_input(image, gt)
    ious = pred.run_clicks(2)
    iou = pred.user_click(30.0, 40.0, False)
    assert np.isfinite(ious).all() and np.isfinite(iou)
    assert int(pred.state.click_count) == 3


def _jax_cli():
    spec = importlib.util.spec_from_file_location(
        "jax_evaluate_cli", REPO / "scripts" / "evaluate.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _table_row(out: str):
    """The results row without its SPC and Time cells (wall clock)."""
    row = next(line for line in out.splitlines()
               if line.startswith("|") and "NoBRS" in line)
    return row.split("|")[1:-3]


def test_cli_evaluates_a_zoo_checkpoint_like_jax(tmp_path, capsys,
                                                 monkeypatch):
    """Both evaluation CLIs on one SegFormer checkpoint (no backbone: no
    position-embedding resampling, a default zoom-in crop of 448 x 448),
    Synthetic, f32: the same NoC row and mIoU@k line, IoU curves within
    1e-5. (Not HRNet or HRFormer: JAX's load_checkpoint drops the empty
    `{}` nodes of their fuse rows and transitions, so JAX's CLI cannot run
    their checkpoints; the port builds the tree from the config and
    loads them, test_zoo_forward_matches_jax.)"""
    jcfg = TINY_CONFIGS[0]
    ckpt = tmp_path / "segformer.npz"
    save_checkpoint(ckpt, jax_weights(jcfg, seed=1), jcfg)
    common = ["--checkpoint", str(ckpt), "--datasets", "Synthetic",
              "--limit", "2", "--n-clicks", "3", "--dtype", "float32",
              "--print-ious", "--save-ious"]
    monkeypatch.setattr(sys, "argv", ["evaluate.py"] + common + [
        "--logs-path", str(tmp_path / "jax")])
    with jax.default_matmul_precision("highest"):
        _jax_cli().main()
    want = capsys.readouterr().out
    cli.main(common + ["--device", "cpu", "--logs-path",
                       str(tmp_path / "port")])
    out = capsys.readouterr().out
    assert _table_row(out) == _table_row(want)
    miou = [line for line in want.splitlines() if line.startswith("mIoU@k")]
    assert len(miou) == 1
    assert [line for line in out.splitlines()
            if line.startswith("mIoU@k")] == miou
    name = "Synthetic_cvpr_NoBRS_3.pickle"
    with open(tmp_path / "jax" / name, "rb") as f:
        jres = pickle.load(f)
    with open(tmp_path / "port" / name, "rb") as f:
        res = pickle.load(f)
    assert len(res["all_ious"]) == len(jres["all_ious"]) > 0
    for a, b in zip(res["all_ious"], jres["all_ious"]):
        np.testing.assert_allclose(a, b, atol=1e-5)


def test_demo_and_serve_take_a_zoo_checkpoint(tmp_path):
    """The demo reads `--target-size` for a model without a ViT backbone
    (JAX demo.py's rule), and the service builds its controllers from a
    zoo checkpoint at JAX's 448."""
    from pvpuformer_tpu_torch import demo, serve
    jcfg = TINY_CONFIGS[0]
    ckpt = tmp_path / "segformer.npz"
    save_checkpoint(ckpt, jax_weights(jcfg), jcfg)
    common = ["--checkpoint", str(ckpt), "--device", "cpu", "--dtype",
              "float32"]
    model, pcfg = demo.build_model(demo.parse_args(common
                                                   + ["--target-size", "64"]))
    assert type(pcfg.model).__name__ == "SegformerISConfig"
    assert pcfg.target_size == (64, 64)
    controller = demo.build_controller(
        demo.parse_args(common + ["--target-size", "64"]), model, pcfg)
    image, _ = _session_sample()
    controller.set_image(image)
    controller.add_click(40, 30, True)
    assert controller.result_mask.shape == image.shape[:2]
    args = serve.parse_args(common + ["--port", "0"])
    assert demo.build_model(args)[1].target_size == (448, 448)
