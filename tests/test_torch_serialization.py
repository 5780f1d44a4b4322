"""Checkpoint bridge: JAX `.npz` checkpoints read by the PyTorch port
(numpy only), config headers decoded into the port's dataclasses, and the
port's parameter tree equal to the JAX `init_vpu` tree."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvpuformer_tpu.inference.predictor import PredictorConfig as JPredictorConfig
from pvpuformer_tpu.models.vpu import init_vpu as jax_init_vpu
from pvpuformer_tpu.models.vpu import vpu_base_config as jax_base_config
from pvpuformer_tpu.utils.serialization import (config_to_dict, flatten_tree,
                                                save_checkpoint)
from pvpuformer_tpu_torch.inference.predictor import PredictorConfig
from pvpuformer_tpu_torch.models.vpu import (VPUConfig, VPUModel, init_vpu,
                                             vpu_base_config)
from pvpuformer_tpu_torch.utils.serialization import (config_from_dict,
                                                      load_checkpoint,
                                                      params_from_numpy,
                                                      torch_name)
from test_models import tiny_cfg


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    cfg = tiny_cfg()
    params = jax_init_vpu(jax.random.key(0), cfg)
    path = tmp_path_factory.mktemp("ckpt") / "tiny.npz"
    save_checkpoint(path, params, cfg, step=7, extra={"note": "x"})
    return params, cfg, path


def test_checkpoint_leaves_bit_equal_with_same_names(jax_ckpt):
    params, _, path = jax_ckpt
    flat, cfg, step, extra = load_checkpoint(path)
    assert (step, extra) == (7, {"note": "x"})
    want = flatten_tree(params)
    assert set(flat) == set(want)
    state = params_from_numpy(flat)
    assert set(state) == {torch_name(k) for k in want}
    for k, v in want.items():
        t = state[torch_name(k)]
        assert t.dtype == torch.float32 and tuple(t.shape) == v.shape, k
        np.testing.assert_array_equal(t.numpy(), np.asarray(v), err_msg=k)
    model = VPUModel(cfg)
    model.load_state_dict(state, strict=True)
    got = model.state_dict()
    assert set(got) == set(state)
    for k, v in state.items():
        assert torch.equal(got[k], v), k


def test_config_header_decodes_to_port_dataclasses(jax_ckpt):
    _, jcfg, path = jax_ckpt
    _, cfg, _, _ = load_checkpoint(path)
    assert isinstance(cfg, VPUConfig)

    def as_tree(c):
        return {f.name: (as_tree(getattr(c, f.name))
                         if dataclasses.is_dataclass(getattr(c, f.name))
                         else getattr(c, f.name)) for f in dataclasses.fields(c)}

    want, got = as_tree(jcfg), as_tree(cfg)
    assert str(want.pop("dtype")) == "<class 'jax.numpy.float32'>"
    assert got.pop("dtype") is torch.float32
    assert got == want


def test_predictor_config_bf16_round_trip():
    jcfg = JPredictorConfig(model=jax_base_config(dtype=jnp.bfloat16),
                            target_size=(448, 448), net_clicks_limit=3)
    cfg = config_from_dict(config_to_dict(jcfg))
    assert isinstance(cfg, PredictorConfig)
    assert cfg.model.dtype is torch.bfloat16
    assert cfg.net_clicks_limit == 3 and cfg.model == vpu_base_config(
        dtype=torch.bfloat16)


def test_bf16_leaves_read_back_bit_equal(tmp_path):
    r = np.random.default_rng(0)
    w = jnp.asarray(r.normal(size=(5, 3)), jnp.bfloat16)
    save_checkpoint(tmp_path / "b.npz", {"a": [{"w": w}]})
    flat, cfg, _, _ = load_checkpoint(tmp_path / "b.npz")
    assert cfg is None
    t = params_from_numpy(flat)["a.0.w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), np.asarray(w, np.float32))


def test_init_tree_matches_jax_at_full_vit_b_width():
    """Names and shapes of the port's init_vpu tree == jax.eval_shape of the
    JAX init_vpu at ViT-B@448 (nothing materialized on either side)."""
    shapes = jax.eval_shape(lambda k: jax_init_vpu(k, jax_base_config()),
                            jax.random.key(0))
    # flatten_tree wraps each ShapeDtypeStruct leaf in a 0-d object array
    want = {torch_name(k): tuple(v.item().shape)
            for k, v in flatten_tree(shapes).items()}
    with torch.device("meta"):
        model = VPUModel(vpu_base_config())
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == want


def test_seeded_init_is_deterministic_and_in_family():
    cfg = vpu_base_config()
    cfg = cfg.replace(backbone=dataclasses.replace(cfg.backbone, depth=4))
    a = init_vpu(cfg, torch.Generator().manual_seed(3))
    b = init_vpu(cfg, torch.Generator().manual_seed(3))
    sa, sb = a.state_dict(), b.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    w = sa["backbone.blocks.0.attn.qkv.w"]                 # xavier uniform
    assert w.abs().max() <= (6.0 / (768 + 3 * 768)) ** 0.5
    assert float(sa["backbone.pos_embed"].std()) == pytest.approx(0.02, rel=0.05)
    assert torch.equal(sa["backbone.blocks.0.norm1.scale"], torch.ones(768))


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_loader_refuses_mismatched_trees(jax_ckpt, fault):
    _, _, path = jax_ckpt
    flat, cfg, _, _ = load_checkpoint(path)
    state = params_from_numpy(flat)
    if fault == "missing":
        state.pop("neck.down32.conv1.w")
    elif fault == "extra":
        state["neck.bogus.w"] = torch.zeros(1)
    else:
        state["head.fusion.w"] = state["head.fusion.w"][..., :1]
    with pytest.raises(RuntimeError):
        VPUModel(cfg).load_state_dict(state, strict=True)
