"""The port's reference-checkpoint converters of the ViT-backed models
(pvpuformer_tpu_torch/utils/torch_ingest.py: the PVPUFormer VPU and
SimpleClick's PlainVit) against the JAX package's, on the CPU.

The state dicts are made up with the reference's key names and small
shapes: the VPU's from tests/test_utils.py:make_reference_vpu_sd, with its
zero biases and unit norms redrawn so that the forward sees every leaf;
PlainVit's from `make_reference_plainvit_sd` below, with the keys JAX's
`convert_plainvit_checkpoint` reads. Each converted tree equals JAX's key
for key and bit for bit, except the interpolated pos-embed when the
checkpoint's grid differs from the config's (the port interpolates in f64
with torch, JAX with its numpy bicubic: within 1e-6, as the MAE ingest of
tests/test_torch_train_entry.py); it loads strictly into the port's module
through `registry.load`, and the forward on it matches JAX's f32 forward
within tests/test_torch_zoo.py's FWD_TOL of the largest logit."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvpuformer_tpu.models import registry as jreg
from pvpuformer_tpu.utils import serialization as jser
from pvpuformer_tpu.utils import torch_ingest as jingest
from pvpuformer_tpu_torch.models import registry
from pvpuformer_tpu_torch.utils import serialization as ser
from pvpuformer_tpu_torch.utils import torch_ingest as tingest
from test_models import tiny_cfg
from test_torch_plainvit import tiny_plainvit
from test_torch_zoo import FWD_TOL, forward_inputs, rel_err
from test_utils import make_reference_vpu_sd


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class Payload:
    """An object a pickle would rebuild by running code."""


def redraw_constants(sd, seed=1):
    """Every bias and 1-D weight (norm scales) of a made-up dict redrawn
    around its value, so that no leaf of the forward is a zero or a one."""
    r = np.random.default_rng(seed)
    out = dict(sd)
    for k, v in sd.items():
        if k.endswith(".bias") or (k.endswith(".weight") and v.ndim == 1):
            out[k] = (v + r.normal(0, 0.05, v.shape)).astype(np.float32)
    return out


def make_reference_plainvit_sd(cfg, seed=0):
    """A SimpleClick PlainVitModel state dict (is_plainvit_model.py:59-95
    names): the MAE ViT, the coord patch embed, SimpleFPN without the DMA
    and the SegFormer head without P2CL."""
    r = np.random.default_rng(seed)
    d = cfg.backbone.embed_dim
    gh, gw = cfg.backbone.grid_size
    ph, pw = cfg.backbone.patch_size
    hidden = int(d * cfg.backbone.mlp_ratio)
    sd = {}

    def w(name, *shape):
        sd[name] = r.normal(0, 0.02, shape).astype(np.float32)

    def lin(name, i, o):
        w(f"{name}.weight", o, i)
        w(f"{name}.bias", o)

    def norm(name, c):
        sd[f"{name}.weight"] = (1 + r.normal(0, 0.1, (c,))).astype(np.float32)
        w(f"{name}.bias", c)

    def conv(name, i, o, k=1):
        w(f"{name}.weight", o, i, k, k)
        w(f"{name}.bias", o)

    def deconv(name, i, o):
        w(f"{name}.weight", i, o, 2, 2)
        w(f"{name}.bias", o)

    w("backbone.patch_embed.proj.weight", d, 3, ph, pw)
    w("backbone.patch_embed.proj.bias", d)
    w("backbone.pos_embed", 1, gh * gw + 1, d)
    w("backbone.cls_token", 1, 1, d)
    for i in range(cfg.backbone.depth):
        b = f"backbone.blocks.{i}"
        norm(f"{b}.norm1", d)
        lin(f"{b}.attn.qkv", d, 3 * d)
        lin(f"{b}.attn.proj", d, d)
        norm(f"{b}.norm2", d)
        lin(f"{b}.mlp.fc1", d, hidden)
        lin(f"{b}.mlp.fc2", hidden, d)
    conv("patch_embed_coords.proj", 3 if cfg.with_prev_mask else 2, d, k=ph)

    nc = cfg.neck
    deconv("neck.down_4.0", d, nc.down4_chan)
    norm("neck.down_4.1", nc.down4_chan)
    deconv("neck.down_4.3", nc.down4_chan, nc.down4_chan // 2)
    norm("neck.down_4.4", nc.down4_chan // 2)
    conv("neck.down_4.5", nc.down4_chan // 2, nc.out_dims[0])
    norm("neck.down_4.6", nc.out_dims[0])
    deconv("neck.down_8.0", d, nc.down8_chan)
    norm("neck.down_8.1", nc.down8_chan)
    conv("neck.down_8.2", nc.down8_chan, nc.out_dims[1])
    norm("neck.down_8.3", nc.out_dims[1])
    conv("neck.down_16.0", d, nc.out_dims[2])
    norm("neck.down_16.1", nc.out_dims[2])
    conv("neck.down_32.0", d, nc.down32_chan, k=2)
    norm("neck.down_32.1", nc.down32_chan)
    conv("neck.down_32.2", nc.down32_chan, nc.out_dims[3])
    norm("neck.down_32.3", nc.out_dims[3])

    hc = cfg.head
    oc = hc.out_channels
    for i, ic in enumerate(hc.in_channels):
        conv(f"head.convs.{i}.conv", ic, oc)
    conv("head.fusion_conv.conv", oc * len(hc.in_channels), oc)
    conv("head.conv_seg", hc.channels, hc.num_classes)
    if hc.upsample in ("x2", "x4"):
        deconv("head.up_conv1.0", oc, oc // 2)
        norm("head.up_conv1.1", oc // 2)
        conv("head.up_conv1.2", oc // 2, oc // 2)
        norm("head.up_conv1.3", oc // 2)
    if hc.upsample == "x4":
        deconv("head.up_conv2.0", oc // 2, oc // 4)
        norm("head.up_conv2.1", oc // 4)
        conv("head.up_conv2.2", oc // 4, oc // 4)
        norm("head.up_conv2.3", oc // 4)
    return sd


def port_cfg(jcfg):
    return ser.config_from_dict(jser.config_to_dict(jcfg))


def assert_trees_equal(got, want, approx=()):
    """Flattened trees: the same names, shapes and dtypes, every leaf bit
    for bit but those named in `approx` (within 1e-6)."""
    fg, fw = ser.flatten_tree(got), jser.flatten_tree(want)
    assert fg.keys() == fw.keys(), (sorted(set(fw) - set(fg))[:5],
                                    sorted(set(fg) - set(fw))[:5])
    for k, v in fw.items():
        v = np.asarray(v)
        assert fg[k].shape == v.shape and fg[k].dtype == v.dtype, k
        if k in approx:
            np.testing.assert_allclose(fg[k], v, atol=1e-6, rtol=0,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(fg[k], v, err_msg=k)


def init_names(jcfg):
    """The JAX init tree's leaf names and shapes (jax.eval_shape)."""
    shapes = jax.eval_shape(lambda k: jreg.init_for(jcfg)(k, jcfg),
                            jax.random.key(0))
    shapes = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    return {k: v.shape for k, v in jser.flatten_tree(shapes).items()}


def forward_both(tree, jcfg, model, cfg):
    img, pts = forward_inputs()
    fwd = jreg.forward_for(jcfg)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda p, i, q: fwd(p, jcfg, i, q))(
            params, jnp.asarray(img), jnp.asarray(pts))
    with torch.no_grad():
        got = registry.forward_for(cfg)(model, cfg, torch.from_numpy(img),
                                        torch.from_numpy(pts))
    return got, want


def test_vpu_tree_load_and_forward_match_jax(tmp_path):
    """A reference PVPUFormer .pth through `load_vpu_checkpoint` in both
    packages: the same tree, the JAX init's leaf names and shapes, a strict
    load into the port's VPUModel and the forward of JAX's tree."""
    jcfg = tiny_cfg()
    sd = redraw_constants(make_reference_vpu_sd(jcfg))
    path = tmp_path / "vpu.pth"
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()},
                "config": {"arch": "VitMultiGaussianVector_ed_Model"}}, path)
    cfg = port_cfg(jcfg)
    tree = tingest.load_vpu_checkpoint(path, cfg)
    want = jingest.load_vpu_checkpoint(path, jcfg)
    assert_trees_equal(tree, want)
    flat = ser.flatten_tree(tree)
    assert {k: v.shape for k, v in flat.items()} == init_names(jcfg)

    model = registry.load(flat, cfg)
    for n, p in model.state_dict().items():
        np.testing.assert_array_equal(p.numpy(), flat[ser.jax_name(n)])
    got, ref = forward_both(tree, jcfg, model, cfg)
    for key in ("instances", "instances_aux"):
        assert rel_err(got[key].numpy(), np.asarray(ref[key])) <= FWD_TOL, key


def test_vpu_grid_change_interpolates_pos_embed():
    """A checkpoint trained at 96 x 96 (a 6 x 6 grid) converted for the
    64 x 64 config (4 x 4): the pos-embed is resized bicubically as JAX
    resizes it, and the model loads and runs."""
    jcfg = tiny_cfg()
    src = jcfg.replace(backbone=dataclasses.replace(jcfg.backbone,
                                                    img_size=(96, 96)))
    sd = make_reference_vpu_sd(src, seed=3)
    assert sd["backbone.pos_embed"].shape == (1, 37, 64)
    cfg = port_cfg(jcfg)
    tree = tingest.convert_vpu_checkpoint(sd, cfg)
    want = jingest.convert_vpu_checkpoint(sd, jcfg)
    assert tree["backbone"]["pos_embed"].shape == (1, 17, 64)
    assert_trees_equal(tree, want, approx={"backbone/pos_embed"})
    model = registry.load(ser.flatten_tree(tree), cfg)
    got, ref = forward_both(want, jcfg, model, cfg)
    assert rel_err(got["instances"].numpy(),
                   np.asarray(ref["instances"])) <= FWD_TOL


@pytest.mark.parametrize("upsample", ["x1", "x4"])
def test_plainvit_tree_load_and_forward_match_jax(upsample):
    """SimpleClick's weights: the same tree as JAX's converter, JAX's init
    names and shapes, a strict load into the port's PlainVitModel and the
    forward; "x4" adds the head's two upsampling stages."""
    jcfg = tiny_plainvit()
    jcfg = dataclasses.replace(
        jcfg, head=dataclasses.replace(jcfg.head, upsample=upsample,
                                       channels=32 // {"x1": 1,
                                                       "x4": 4}[upsample]))
    sd = make_reference_plainvit_sd(jcfg)
    cfg = port_cfg(jcfg)
    tree = tingest.convert_plainvit_checkpoint(sd, cfg)
    want = jingest.convert_plainvit_checkpoint(sd, jcfg)
    assert_trees_equal(tree, want)
    flat = ser.flatten_tree(tree)
    assert {k: v.shape for k, v in flat.items()} == init_names(jcfg)
    model = registry.load(flat, cfg)
    got, ref = forward_both(tree, jcfg, model, cfg)
    assert rel_err(got["instances"].numpy(),
                   np.asarray(ref["instances"])) <= FWD_TOL


def test_load_torch_state_dict_reads_tensors_only(tmp_path):
    """`load_torch_state_dict` unwraps "model" / "state_dict" and refuses a
    pickled object (weights_only): no code in the file runs."""
    sd = {"a.weight": torch.ones(2, 3), "a.bias": torch.zeros(2)}
    torch.save({"model": sd}, tmp_path / "m.pth")
    got = tingest.load_torch_state_dict(tmp_path / "m.pth")
    assert got.keys() == sd.keys()
    assert got["a.weight"].dtype == np.float32
    torch.save({"state_dict": sd, "obj": Payload()}, tmp_path / "bad.pth")
    with pytest.raises(Exception):
        tingest.load_torch_state_dict(tmp_path / "bad.pth")
