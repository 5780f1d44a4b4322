"""The port's training entry point against the JAX package's, on the CPU:
config.yml reading without PyYAML, the experiment layout, the recipes'
wiring, the new losses, MAE ingest, and the tiny recipe run end to end by
`pvpuformer_tpu_torch.train.main`, whose checkpoint the JAX evaluation CLI
reads to the same NoC table as the port's."""
import importlib
import logging
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from pvpuformer_tpu import data as jdata
from pvpuformer_tpu.engine import losses as jloss
from pvpuformer_tpu.models.vit import ViTConfig as JViTConfig
from pvpuformer_tpu.utils import exp as jexp, serialization as jser
from pvpuformer_tpu.utils import torch_ingest as jingest
from pvpuformer_tpu_torch import data as tdata, train as ttrain
from pvpuformer_tpu_torch.engine import losses as tloss
from pvpuformer_tpu_torch.evaluate import main as port_evaluate
from pvpuformer_tpu_torch.models.vit import ViT
from pvpuformer_tpu_torch.utils import exp as texp, serialization as tser
from pvpuformer_tpu_torch.utils import torch_ingest as tingest
from test_torch_eval import _jax_cli, _table_row, two_torch_threads  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
RECIPES = REPO / "pvpuformer_tpu_torch" / "recipes" / "iSegNet"
TINY = RECIPES / "vpu_tiny_synthetic.py"


@pytest.fixture(autouse=True)
def restore_loggers():
    """init_experiment adds a log file and a console handler to the
    packages' loggers; close and drop them after each test."""
    loggers = [logging.getLogger(n)
               for n in ("pvpuformer_tpu", "pvpuformer_tpu_torch")]
    before = [(lg, list(lg.handlers), lg.level) for lg in loggers]
    yield
    for lg, handlers, level in before:
        for h in lg.handlers:
            if h not in handlers:
                h.close()
        lg.handlers[:] = handlers
        lg.setLevel(level)


# ------------------------------------------------------------ config files

CONFIG_FIXTURE = """# comment line
EXPS_PATH: ./experiments   # trailing comment
INT: 42
NEG: -7
BIG: 1_000
FLOAT: 3.25
EXP_FLOAT: 1.0e-3
NOT_A_FLOAT: 1e-3
HALF: .5
IS_TRUE: true
IS_OFF: off
IS_YES: Yes
NONE: ~
EMPTY:
SINGLE: 'has # hash and '' quote'
DOUBLE: "a: b"
PLAIN: it's a path/with:colon#hash
URL: http://host/x
NESTED:
  A: 1
  B: two
  C: false   # comment
  D: "3"

  E: 2.5
AFTER: last
"""


@pytest.mark.parametrize("source", ["repo", "fixture"])
def test_config_parser_equals_yaml(source, tmp_path):
    text = (REPO / "config.yml").read_text() if source == "repo" \
        else CONFIG_FIXTURE
    want = yaml.safe_load(text)
    got = texp.parse_config(text)
    assert got == want
    assert [type(v) for v in got.values()] == [type(v) for v in want.values()]
    (tmp_path / "config.yml").write_text(text)
    assert texp.load_config_file(tmp_path / "config.yml") == want


@pytest.mark.parametrize("text,line", [
    ("A: 1\nB: [1, 2]\n", 2), ("A:\n  - 1\n", 2), ("A:\n  b:\n    c: 1\n", 2),
    ("A: &anchor 1\n", 1), ("A: 0x1F\n", 1), ("A: 0755\n", 1),
    ("A: 2024-01-02\n", 1), ("A: 1:30\n", 1), ("\tA: 1\n", 1),
    ("A: b: c\n", 1), ("- a\n", 1), ("A: 'open\n", 1), ("A: |\n", 1),
    ("  A: 1\n", 1), ("A:\n  b: 1\n   c: 2\n", 3), ('A: "x\\ny"\n', 1),
    ("A:1\n", 1), ("---\nA: 1\n", 1), ("A: {b: 1}\n", 1),
    ("B: 1\nTrue: 1\n", 2), ("null: 1\n", 1)])
def test_config_parser_refuses_other_forms(text, line):
    with pytest.raises(texp.ConfigSyntaxError, match=f"cfg:{line}:"):
        texp.parse_config(text, "cfg")


# ------------------------------------------------------ experiment layout

def _tree(root: Path):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*")
                  if p.suffix != ".log")


def test_init_experiment_matches_jax(tmp_path):
    recipe = REPO / "models" / "iSegNet" / "vpu_tiny_synthetic.py"
    for _ in range(2):
        jcfg = jexp.init_experiment(recipe, exps_path=tmp_path / "jax",
                                    exp_suffix="run", repo_root=REPO)
        tcfg = texp.init_experiment(recipe, exps_path=tmp_path / "port",
                                    exp_suffix="run", repo_root=REPO)
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")
    assert tcfg.EXP_PATH.name == jcfg.EXP_PATH.name == "001_run"
    paths = ("EXP_PATH", "CHECKPOINTS_PATH", "VIS_PATH", "LOGS_PATH")
    assert {k: v for k, v in vars(tcfg).items() if k not in paths} == \
        {k: v for k, v in vars(jcfg).items() if k not in paths}
    assert list((tcfg.LOGS_PATH).glob("train_*.log"))
    resumed = texp.init_experiment(recipe, exps_path=tmp_path / "port",
                                   resume_exp="000", repo_root=REPO)
    assert resumed.EXP_PATH.name == "000_run"
    with pytest.raises(FileNotFoundError, match="no experiment"):
        texp.init_experiment(recipe, exps_path=tmp_path / "port",
                             resume_exp="007", repo_root=REPO)


# --------------------------------------------------------- recipe wiring

class _Stub:
    """A Trainer that records its arguments and its `run` call."""

    def __init__(self, *args, **kw):
        self.args, self.kw = args, kw

    def run(self, num_epochs, start_epoch=None, validation=False):
        self.run_kw = (num_epochs, start_epoch, validation)


def _ds_record(ds):
    """A dataset's class and settings, with its sampler and augmentations
    as plain values."""
    out = {"class": type(ds).__name__}
    for k, v in vars(ds).items():
        if k == "augmentator" and v is not None:
            v = [(type(t).__name__, vars(t)) for t in v.transforms]
        elif k == "points_sampler":
            v = {a: (b.tolist() if isinstance(b, np.ndarray) else b)
                 for a, b in vars(v).items()}
        out[k] = v
    return out


def _loader_record(loader):
    return None if loader is None else (
        loader.global_batch, loader.num_workers, loader.shuffle,
        loader.drop_last, _ds_record(loader.dataset))


def _record_recipe(mods, main, monkeypatch, cfg, pkg):
    """Run a recipe's main with CocoLvis read as the synthetic raw source
    and the model init, optimizer and Trainer recorded instead of built."""
    seen = {}

    def coco(path, split, stuff_prob=0.0, **kw):
        seen.setdefault("coco", []).append((path, split, stuff_prob))
        return pkg.SyntheticTrainDataset(**kw)

    def opt(params, *a, **kw):
        seen["opt"] = (a, kw)
        return "tx"

    def trainer(*a, **kw):
        seen["trainer"] = _Stub(*a, **kw)
        return seen["trainer"]

    fakes = {"CocoLvisDataset": coco, "make_optimizer": opt,
             "Trainer": trainer, "with_grad_accumulation": lambda tx, k: tx,
             "init_vpu": lambda *a: torch.nn.Linear(1, 1)}
    for m in mods:
        for attr, value in fakes.items():
            if hasattr(m, attr):
                monkeypatch.setattr(m, attr, value)
    main(cfg)
    return seen


@pytest.mark.parametrize("name", ["vpu_base448_cocolvis",
                                  "vpu_large448_cocolvis",
                                  "vpu_huge448_cocolvis",
                                  "vpu_tiny_synthetic"])
def test_recipe_wiring_matches_jax(name, monkeypatch, tmp_path):
    """The same model config, datasets (sampler, augmentations, object
    filter, epoch length, stuff_prob), loaders, TrainConfig, optimizer
    arguments, checkpoint schedule and epochs as the JAX recipe, with
    train.py's flags as they come by default."""
    flags = vars(ttrain.parse_args([str(TINY)]))
    cfg = texp.EasyCfg(LVIS_v1_PATH="/nonexistent", CHECKPOINTS_PATH=tmp_path,
                       LOGS_PATH=tmp_path, IMAGENET_PRETRAINED_MODELS={},
                       **{k: v for k, v in flags.items() if k != "device"})
    jmod = jexp.load_module(REPO / "models" / "iSegNet" / f"{name}.py")
    jseen = _record_recipe([jmod], jmod.main, monkeypatch, cfg, jdata)
    from pvpuformer_tpu_torch.recipes.iSegNet import vpu_base448_cocolvis
    tmod = importlib.import_module(
        f"pvpuformer_tpu_torch.recipes.iSegNet.{name}")
    tseen = _record_recipe({tmod, vpu_base448_cocolvis}, tmod.main,
                           monkeypatch, cfg, tdata)
    assert tmod.MODEL_NAME == jmod.MODEL_NAME == name
    assert tseen.get("coco") == jseen.get("coco")
    assert tseen["opt"] == jseen["opt"]
    jt, tt = jseen["trainer"], tseen["trainer"]
    assert len(tt.args) == len(jt.args)
    assert tser.config_from_dict(jser.config_to_dict(jt.args[1])) == \
        tt.args[1]
    for i in range(3, len(jt.args)):                # the loaders
        assert _loader_record(tt.args[i]) == _loader_record(jt.args[i])
    assert set(jt.kw) - set(tt.kw) <= {"mesh", "param_mode"}
    assert set(tt.kw) - set(jt.kw) == {"device"}
    for k in set(jt.kw) & set(tt.kw) - {"metrics"}:
        assert tt.kw[k] == jt.kw[k], k
    assert [(type(m).__name__, m.thresh_step, m.thresh_beta, m.iou_beta)
            for m in tt.kw["metrics"]] == \
        [(type(m).__name__, m.thresh_step, m.thresh_beta, m.iou_beta)
         for m in jt.kw["metrics"]]
    assert tt.run_kw == jt.run_kw


def test_recipes_take_train_flags():
    args = ttrain.parse_args([str(TINY), "--batch-size", "4", "--epochs",
                              "3", "--device", "cpu", "--accumulate-grad",
                              "2", "--debug"])
    assert (args.batch_size, args.epochs, args.device, args.accumulate_grad,
            args.debug) == (4, 3, "cpu", 2, True)


@pytest.mark.parametrize("flag", [["--model-parallel", "2"],
                                  ["--param-mode", "fsdp"],
                                  ["--platform", "cpu"], ["--random-split"]])
def test_train_refuses_flags_of_later_slices(flag):
    with pytest.raises(SystemExit) as e:
        ttrain.parse_args([str(TINY)] + flag)
    assert e.value.code == 2


# ------------------------------------------------------------------ losses

def _loss_inputs(seed, c=1):
    r = np.random.default_rng(seed)
    logits = (r.normal(size=(2, 12, 14, c)) * 2).astype(np.float32)
    if c == 1:
        label = (r.uniform(size=(2, 12, 14, 1)) > 0.6).astype(np.float32)
        label[r.uniform(size=label.shape) > 0.9] = -1.0     # ignore pixels
        label[1, 3:9, 2:10] = 1.0
    else:
        label = r.integers(0, c, (2, 12, 14)).astype(np.int32)
        label[r.uniform(size=label.shape) > 0.85] = 255
    return logits, label


# name -> (JAX function, port function, classes, differentiable)
LOSSES = {
    "focal": (jloss.focal_loss, tloss.focal_loss, 1, True),
    "focal_from_logits": (
        lambda x, y: jloss.focal_loss(jax.nn.sigmoid(x), y, alpha=0.4,
                                      gamma=1.5, scale=2.0, from_logits=True),
        lambda x, y: tloss.focal_loss(torch.sigmoid(x), y, alpha=0.4,
                                      gamma=1.5, scale=2.0, from_logits=True),
        1, True),
    "soft_iou": (jloss.soft_iou_loss, tloss.soft_iou_loss, 1, True),
    "boundary_bce": (lambda x, y: jloss.boundary_bce_loss(y, x),
                     lambda x, y: tloss.boundary_bce_loss(y, x), 1, True),
    "error_count": (lambda x, y: jloss.error_count(y, x),
                    lambda x, y: tloss.error_count(y, x), 1, False),
    "cross_entropy": (jloss.cross_entropy_loss, tloss.cross_entropy_loss, 5,
                      True),
    "cross_entropy_weighted": (
        lambda x, y: jloss.cross_entropy_loss(x, y, class_weight=[1, 2, .5,
                                                                  1, 3]),
        lambda x, y: tloss.cross_entropy_loss(x, y, class_weight=[1, 2, .5,
                                                                  1, 3]),
        5, True),
    "accuracy": (jloss.accuracy, tloss.accuracy, 5, False),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_new_losses_match_jax(name):
    """Value and gradient with respect to the logits within 1e-6 x max(1,
    largest magnitude) in f32: the sums run in another order than XLA's
    (a CE of 2.65 differs by 1.4e-6, six f32 ulps)."""
    jfn, tfn, c, grad = LOSSES[name]
    for seed in (0, 1):
        logits, label = _loss_inputs(seed, c)
        x = torch.from_numpy(logits).requires_grad_(grad)
        got = tfn(x, torch.from_numpy(label))
        want = jfn(jnp.asarray(logits), jnp.asarray(label))
        want = np.asarray(want)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                                   atol=1e-6 * max(1.0, np.abs(want).max()))
        if grad:
            got.sum().backward()
            jg = jax.grad(lambda v: jnp.sum(jfn(v, jnp.asarray(label))))(
                jnp.asarray(logits))
            jg = np.asarray(jg)
            np.testing.assert_allclose(x.grad.numpy(), jg, rtol=0,
                                       atol=1e-6 * max(1.0, np.abs(jg).max()))


def test_inner_boundary_matches_jax():
    m = np.random.default_rng(3).uniform(size=(3, 9, 11)) > 0.4
    np.testing.assert_array_equal(
        tloss._inner_boundary(torch.from_numpy(m)).numpy(),
        np.asarray(jloss._inner_boundary(jnp.asarray(m))))


# -------------------------------------------------------------- MAE ingest

def _mae_state(depth=4, d=64, grid=14, seed=0):
    """A made-up MAE ViT state dict (with the decoder keys MAE keeps)."""
    r = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(r.normal(size=shape).astype(np.float32))

    sd = {"patch_embed.proj.weight": t(d, 3, 16, 16),
          "patch_embed.proj.bias": t(d), "cls_token": t(1, 1, d),
          "pos_embed": t(1, 1 + grid * grid, d), "norm.weight": t(d),
          "norm.bias": t(d), "mask_token": t(1, 1, 32),
          "decoder_embed.weight": t(32, d)}
    for i in range(depth):
        p = f"blocks.{i}."
        sd.update({p + "norm1.weight": t(d), p + "norm1.bias": t(d),
                   p + "attn.qkv.weight": t(3 * d, d),
                   p + "attn.qkv.bias": t(3 * d),
                   p + "attn.proj.weight": t(d, d), p + "attn.proj.bias": t(d),
                   p + "norm2.weight": t(d), p + "norm2.bias": t(d),
                   p + "mlp.fc1.weight": t(4 * d, d),
                   p + "mlp.fc1.bias": t(4 * d),
                   p + "mlp.fc2.weight": t(d, 4 * d), p + "mlp.fc2.bias": t(d)})
    return sd


@pytest.mark.parametrize("img", [64, 224, 448])
def test_mae_ingest_matches_jax(tmp_path, img):
    """A 14x14-grid MAE checkpoint to a 4x4, 14x14 and 28x28 grid: the same
    ViT parameters as the JAX ingest (pos-embed within 1e-6), loaded into
    the port's ViT."""
    path = tmp_path / "mae.pth"
    torch.save({"model": _mae_state()}, path)
    jcfg = JViTConfig(img_size=(img, img), embed_dim=64, depth=4, num_heads=2)
    want = jser.flatten_tree(jingest.load_mae_pretrained(path, jcfg))
    tcfg = tser.config_from_dict(jser.config_to_dict(jcfg))
    tree = tingest.load_mae_pretrained(path, tcfg)
    got = tser.flatten_tree(tree)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape, k
        if k == "pos_embed":
            np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=0)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    vit = ViT(tcfg)
    tingest.load_vit_state(vit, tree)
    for n, p in vit.state_dict().items():
        np.testing.assert_array_equal(p.numpy(), got[tser.jax_name(n)],
                                      err_msg=n)


# ---------------------------------------------- the entry point end to end

def test_train_entry_runs_on_the_card_by_default(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ttrain.main([str(TINY), "--debug"])


def test_tiny_recipe_trains_and_both_clis_read_its_checkpoint(
        tmp_path, monkeypatch, capsys):
    """`train.main` on the tiny recipe (--debug: one epoch of 4 steps at
    batch 8) writes JAX's experiment layout; the JAX evaluation CLI and the
    port's read its checkpoint to the same NoC row and mIoU@k; --resume-exp
    continues from it."""
    monkeypatch.chdir(tmp_path)
    ttrain.main([str(TINY), "--debug", "--device", "cpu", "--workers", "2"])
    exp = tmp_path / "experiments" / "iSegNet" / "vpu_tiny_synthetic" / "000"
    assert (exp / "vpu_tiny_synthetic.py").read_text() == TINY.read_text()
    assert {p.name for p in exp.iterdir()} == {
        "checkpoints", "vis", "logs", "vpu_tiny_synthetic.py"}
    ckpt = exp / "checkpoints" / "last_checkpoint.npz"
    assert {p.name for p in (exp / "checkpoints").iterdir()} == {
        "000.npz", "last_checkpoint.npz"}
    log = next((exp / "logs").glob("train_*.log")).read_text()
    assert "epoch 0 done" in log and "saved checkpoint" in log
    flat, cfg, step, extra = jser.load_checkpoint(ckpt)
    assert step == 4 and extra["epoch"] == 0
    capsys.readouterr()

    common = ["--checkpoint", str(ckpt), "--datasets", "Synthetic",
              "--limit", "3", "--n-clicks", "3", "--dtype", "float32",
              "--print-ious"]
    monkeypatch.setattr(sys, "argv", ["evaluate.py"] + common + [
        "--logs-path", str(tmp_path / "jax")])
    with jax.default_matmul_precision("highest"):
        _jax_cli().main()
    want = capsys.readouterr().out
    port_evaluate(common + ["--device", "cpu", "--logs-path",
                            str(tmp_path / "port")])
    got = capsys.readouterr().out
    assert _table_row(got) == _table_row(want)
    assert [ln for ln in got.splitlines() if ln.startswith("mIoU@k")] == \
        [ln for ln in want.splitlines() if ln.startswith("mIoU@k")]

    ttrain.main([str(TINY), "--resume-exp", "000", "--epochs", "2",
                 "--device", "cpu", "--workers", "2"])
    _, _, step, extra = jser.load_checkpoint(ckpt)
    assert step == 8 and extra["epoch"] == 1
    assert (exp / "checkpoints" / "001.npz").exists()
