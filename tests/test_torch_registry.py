"""The port's model registry (pvpuformer_tpu_torch/models/registry.py) and
the checkpoint surface of every registered family, against the JAX
package's registry and serialization.

Every family's config has JAX's fields and defaults; its module has the
JAX `init_*` tree leaf for leaf (names and shapes); a JAX checkpoint loads
into the port and the port's checkpoint back into JAX with the config and
every leaf equal (exact); unregistered configs, the CLIP configs, f-BRS on
a family without insertion points and the batched mode on a zoo config are
refused as JAX refuses them (or, for the batched mode, fails)."""
import ast
import inspect

import jax
import numpy as np
import pytest
import torch

from pvpuformer_tpu.models import registry as jreg
from pvpuformer_tpu.models.zoo.clip_text import ClipTextConfig
from pvpuformer_tpu.models.zoo.swin import SwinISConfig as JSwin
from pvpuformer_tpu.utils import serialization as jser
from pvpuformer_tpu_torch.inference import brs, graphs
from pvpuformer_tpu_torch.inference.batched import BatchedEvaluator
from pvpuformer_tpu_torch.inference.predictor import (PredictorConfig,
                                                     init_session,
                                                     stack_states)
from pvpuformer_tpu_torch.models import registry
from pvpuformer_tpu_torch.utils import serialization as ser
from test_models import tiny_cfg
from test_torch_plainvit import tiny_plainvit
from test_torch_zoo import RESNET34, ZOO_CONFIGS, family_id, jax_weights

FAMILIES = [tiny_plainvit()] + ZOO_CONFIGS


def _port_cfg(jcfg):
    return ser.config_from_dict(jser.config_to_dict(jcfg))


def test_registry_covers_every_jax_family():
    want = {c.__name__ for c in jreg._REGISTRY}
    got = {c.__name__ for c in registry.CONFIGS}
    assert got == want
    assert len(want) == 8


@pytest.mark.parametrize("jcls", list(jreg._REGISTRY),
                         ids=lambda c: c.__name__)
def test_config_fields_and_defaults_match_jax(jcls):
    """The default config of each family encodes to JAX's header exactly
    (field names, defaults, nested configs, the dtype)."""
    pcls = next(c for c in registry.CONFIGS if c.__name__ == jcls.__name__)
    assert ser.config_to_dict(pcls()) == jser.config_to_dict(jcls())


def test_registry_registers_directly():
    """No try / except around a family's import: a broken family fails at
    import, not as a missing key later."""
    tree = ast.parse(inspect.getsource(registry))
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]


def test_unregistered_config_is_refused_by_name():
    class MadeUpConfig:
        pass
    for fn in (registry.forward_for, registry.model_for, registry.crop_size):
        with pytest.raises(KeyError, match="MadeUpConfig"):
            fn(MadeUpConfig())


@pytest.mark.parametrize("jcls", list(jreg._REGISTRY),
                         ids=lambda c: c.__name__)
def test_crop_size(jcls):
    """A ViT-backed family's crop is its backbone's img_size (the crop JAX's
    evaluate.py and batched mode read); a zoo family has none, DeepLab
    included, whose `backbone` field names its ResNet."""
    cfg = next(c for c in registry.CONFIGS if c.__name__ == jcls.__name__)()
    vit = jcls.__name__ in ("VPUConfig", "PlainVitConfig")
    want = tuple(jcls().backbone.img_size) if vit else None
    assert registry.crop_size(cfg) == want


def test_deeplab_config_takes_the_zoo_branch():
    """Regression: the CLIs and the batched mode told a ViT-backed config
    by a `backbone` field, which DeepLab's config also has (a string), so
    the evaluation CLI's crop and pos-embed step raised AttributeError on a
    DeepLab checkpoint. It is copied as it is at any crop, and the batched
    mode refuses it as it refuses the other zoo families."""
    from pvpuformer_tpu_torch.evaluate import at_crop
    cfg = _port_cfg(RESNET34)
    model = registry.build(cfg, torch.Generator().manual_seed(0), "cpu")
    out, ocfg = at_crop(model, cfg, (448, 448))
    assert ocfg == cfg and out is not model
    for k, v in model.state_dict().items():
        assert torch.equal(out.state_dict()[k], v)
    with pytest.raises(ValueError, match="DeeplabISConfig"):
        BatchedEvaluator(model, PredictorConfig(model=cfg), batch_size=2,
                         device="cpu")


def test_clip_configs_stay_refused():
    """The CLIP configs were refused until the text tower was ported; JAX
    registers all three, and the port now reads each back field for
    field. A class neither package has is still refused by name."""
    from pvpuformer_tpu.models.zoo.clip_text import (ClipViTConfig,
                                                     ClipVisualConfig)
    from pvpuformer_tpu_torch.models.zoo import clip_text as tclip
    for jcfg in (ClipTextConfig(), ClipVisualConfig(layers=(2, 3, 4, 5)),
                 ClipViTConfig(width=64)):
        got = ser.config_from_dict(jser.config_to_dict(jcfg))
        assert type(got) is getattr(tclip, type(jcfg).__name__)
        assert got.__dict__ == jcfg.__dict__
        assert ser.config_to_dict(got) == jser.config_to_dict(jcfg)
    with pytest.raises(ValueError, match="NoSuchConfig.*is not ported"):
        ser.config_from_dict({"__class__": "NoSuchConfig"})


@pytest.mark.parametrize("jcfg", FAMILIES + [RESNET34], ids=family_id)
def test_module_tree_is_the_jax_init_tree(jcfg):
    """registry.build's module (seeded random weights) has exactly the
    JAX init tree's `flatten_tree` leaves, names and shapes."""
    shapes = jax.eval_shape(lambda k: jreg.init_for(jcfg)(k, jcfg),
                            jax.random.key(0))
    want = {ser.torch_name(k): tuple(v.shape)
            for k, v in jser.flatten_tree(jax.tree_util.tree_map(
                lambda s: np.empty(s.shape, np.float32), shapes)).items()}
    model = registry.build(_port_cfg(jcfg), torch.Generator().manual_seed(0),
                           "cpu")
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == want


@pytest.mark.parametrize("jcfg", FAMILIES, ids=family_id)
def test_checkpoint_round_trip_through_the_port(tmp_path, jcfg):
    """JAX save_checkpoint -> the port's load_checkpoint and registry.load
    -> the port's save_checkpoint -> JAX load_checkpoint: the config equal,
    and the file's leaves those JAX wrote. HRNet's and HRFormer's trees
    hold empty `{}` nodes (unchanged transition branches, the diagonal of
    the fuse rows), which JAX's load_checkpoint drops when it rebuilds the
    lists (their items renumber), so for those the leaves are read from the
    file; for the others JAX's loaded tree equals the saved one."""
    params = jax_weights(jcfg)
    jser.save_checkpoint(tmp_path / "j.npz", params, jcfg)
    flat, cfg, _, _ = ser.load_checkpoint(tmp_path / "j.npz")
    model = registry.load(flat, cfg)
    assert type(model) is registry.model_for(cfg)
    ser.save_checkpoint(tmp_path / "p.npz", model.state_dict(), cfg)
    params2, cfg2, _, _ = jser.load_checkpoint(tmp_path / "p.npz")
    assert cfg2 == jcfg
    want = jser.flatten_tree(params)
    with np.load(tmp_path / "p.npz") as z:
        stored = {k[len("params/"):]: z[k] for k in z.files
                  if k.startswith("params/")}
    assert stored.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(stored[k], np.asarray(want[k]))
    if type(jcfg).__name__ not in ("HRNetISConfig", "HRFormerISConfig"):
        got = jser.flatten_tree(params2)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]))


def test_deeplab_downsample_rule():
    """resnetv1b's `_make_layer` (tests/test_zoo.py:86-101): block 0 gets a
    projection only where stride != 1 or the width changes, so ResNet-34's
    layer1 has none and ResNet-50's has one; layers 2-4 have one in block
    0 only."""
    for jcfg, l1_down in ((RESNET34, False), (ZOO_CONFIGS[2], True)):
        model = registry.build(_port_cfg(jcfg), None, "cpu")
        assert hasattr(model.layer1[0], "down") == l1_down
        for layer in (model.layer2, model.layer3, model.layer4):
            assert hasattr(layer[0], "down")
            assert not any(hasattr(b, "down") for b in layer[1:])


def _tiny_swin():
    jcfg = next(c for c in ZOO_CONFIGS if isinstance(c, JSwin))
    cfg = _port_cfg(jcfg)
    return registry.build(cfg, torch.Generator().manual_seed(0), "cpu"), cfg


def test_batched_mode_refuses_a_zoo_config():
    """JAX's batched mode reads cfg.model.backbone, so it takes only
    ViT-backed families; the port refuses a zoo config with a clear
    error."""
    model, cfg = _tiny_swin()
    with pytest.raises(ValueError, match="ViT-backed.*SwinISConfig"):
        BatchedEvaluator(model, PredictorConfig(model=cfg), batch_size=2,
                         device="cpu")


@pytest.mark.parametrize("jcfg", [c for c in FAMILIES if type(c).__name__
                                  not in ("HRNetISConfig",
                                          "DeeplabISConfig")],
                         ids=family_id)
def test_fbrs_is_refused_without_insertion_points(jcfg):
    """f-BRS has insertion maps for HRNet, DeepLab and VPU only (JAX's
    ValueError); input BRS takes every family."""
    cfg = _port_cfg(jcfg)
    model = registry.build(cfg, None, "cpu")
    pcfg = PredictorConfig(model=cfg, target_size=(64, 64))
    for mode in ("f-BRS-A", "f-BRS-B", "f-BRS-C"):
        with pytest.raises(ValueError, match="no insertion map for "
                           + type(cfg).__name__):
            brs.get_predictor(model, pcfg, mode, device="cpu")
    p = brs.get_predictor(model, pcfg, "DistMap-BRS", device="cpu")
    assert isinstance(p, brs.InputBRSPredictor)


def test_graph_key_tells_families_apart():
    """Two families' captured rounds never share a key: the
    PredictorConfig in the key holds the family's own config type."""
    swin, scfg = _tiny_swin()
    vcfg = _port_cfg(tiny_cfg())
    vpu = registry.build(vcfg, None, "cpu")
    st = stack_states([init_session(np.zeros((8, 8, 3), np.uint8),
                                    np.zeros((8, 8)), 4, (64, 64), "cpu")])
    k1 = graphs._key(swin, PredictorConfig(model=scfg), "click", st)
    k2 = graphs._key(vpu, PredictorConfig(model=vcfg), "click", st)
    assert k1 != k2
    assert PredictorConfig(model=scfg) != PredictorConfig(model=vcfg)
