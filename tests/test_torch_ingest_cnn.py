"""The port's RITM zoo converters (pvpuformer_tpu_torch/utils/torch_ingest.py:
HRNet and DeepLab) against the JAX package's, on the CPU.

HRNet's state dict is tests/test_utils.py:make_reference_hrnet_sd (RITM's
hrnet_ocr.py names), with its biases and BN affines redrawn away from zero
and one; it carries torch conv biases in front of two BNs of the OCR head
(`conv3x3_ocr.0`, `aux_head.0`), leaves JAX's `init_hrnet_is` lacks and
JAX's forward adds: the port's strict `registry.load` gives those convs
their bias and the forward matches JAX's on the converted tree within
tests/test_torch_zoo.py's FWD_TOL. DeepLab's dict is made up below with the
names JAX's `convert_deeplab_checkpoint` reads, for resnet34 (7x7 stem,
basic blocks) and resnet50 (deep stem, bottlenecks). Every tree equals
JAX's key for key and bit for bit."""
import dataclasses

import numpy as np
import pytest
import torch

from pvpuformer_tpu.models.zoo.deeplab import DeeplabISConfig
from pvpuformer_tpu.models.zoo.hrnet import HRNetISConfig
from pvpuformer_tpu.utils import torch_ingest as jingest
from pvpuformer_tpu_torch.models import registry
from pvpuformer_tpu_torch.models.zoo.deeplab import RESNET_SPECS
from pvpuformer_tpu_torch.utils import serialization as ser
from pvpuformer_tpu_torch.utils import torch_ingest as tingest
from test_torch_ingest_vit import (assert_trees_equal, forward_both,
                                   init_names, port_cfg, redraw_constants)
from test_torch_zoo import FWD_TOL, rel_err
from test_utils import make_reference_hrnet_sd

HRNET = HRNetISConfig(width=8, small=True, ocr_width=16)
OCR_BIASES = {"ocr/conv3x3/conv/b", "ocr/aux/c1/conv/b"}


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_hrnet_tree_biases_load_and_forward_match_jax():
    sd = redraw_constants(make_reference_hrnet_sd(HRNET))
    cfg = port_cfg(HRNET)
    tree = tingest.convert_hrnet_checkpoint(sd, cfg)
    want = jingest.convert_hrnet_checkpoint(sd, HRNET)
    assert_trees_equal(tree, want)
    # identity transitions and fuse diagonals are {} in both trees
    assert tree["tr2"][0] == {} and tree["stage2"][0]["fuse"][0][0] == {}

    flat = ser.flatten_tree(tree)
    names = init_names(HRNET)
    assert set(flat) - set(names) == OCR_BIASES
    assert all(flat[k].shape == s for k, s in names.items())
    model = registry.load(flat, cfg)
    state = model.state_dict()
    assert set(map(ser.jax_name, state)) == set(flat)
    for n, p in state.items():
        np.testing.assert_array_equal(p.numpy(), flat[ser.jax_name(n)])
    assert all(np.abs(flat[k]).max() > 0 for k in OCR_BIASES)
    got, ref = forward_both(tree, HRNET, model, cfg)
    for key in ("instances", "instances_aux"):
        assert rel_err(got[key].numpy(), np.asarray(ref[key])) <= FWD_TOL, key


@pytest.mark.parametrize("leaf", ["ocr/cls/extra", "ocr/conv3x3/bn/b",
                                  "ocr/conv3x3/conv/b"])
def test_strict_load_refuses_other_leaves(leaf):
    """Only a missing conv bias of the conv's width is taken: an unknown
    leaf, a bias of a non-conv and a mis-shaped conv bias raise."""
    flat = ser.flatten_tree(tingest.convert_hrnet_checkpoint(
        make_reference_hrnet_sd(HRNET), port_cfg(HRNET)))
    flat[leaf] = np.zeros((3,), np.float32)
    with pytest.raises(RuntimeError):
        registry.load(flat, port_cfg(HRNET))


def make_reference_deeplab_sd(cfg, seed=0):
    """A RITM DeeplabModel state dict (is_deeplab_model.py:10-27,
    deeplab_v3.py:12-176, resnetv1b.py names): bias-free convs in the
    ResNet, ASPP and separable convs, biased 1x1 classifiers."""
    r = np.random.default_rng(seed)
    layers, block, stem = RESNET_SPECS[cfg.backbone]
    exp = cfg.expansion
    ch = cfg.ch
    sd = {}

    def conv(name, i, o, k=1, bias=False, groups=1):
        sd[f"{name}.weight"] = r.normal(
            0, 0.05, (o, i // groups, k, k)).astype(np.float32)
        if bias:
            sd[f"{name}.bias"] = r.normal(0, 0.05, (o,)).astype(np.float32)

    def bn(name, c):
        sd[f"{name}.weight"] = (1 + r.normal(0, 0.1, (c,))).astype(np.float32)
        sd[f"{name}.bias"] = r.normal(0, 0.1, (c,)).astype(np.float32)
        sd[f"{name}.running_mean"] = r.normal(0, 0.1, (c,)).astype(np.float32)
        sd[f"{name}.running_var"] = r.uniform(0.5, 2, (c,)).astype(np.float32)

    def cb(cname, bname, i, o, k=1):
        conv(cname, i, o, k)
        bn(bname, o)

    def sep(prefix, i, o):
        conv(f"{prefix}.body.0", i, i, 3, groups=i)
        conv(f"{prefix}.body.1", i, o)
        bn(f"{prefix}.body.2", o)

    conv("maps_transform.0", 3 if cfg.with_prev_mask else 2, 16, bias=True)
    conv("maps_transform.2", 16, 64, k=3, bias=True)
    sd["maps_transform.3.scale"] = np.asarray([-0.07], np.float32)
    bb = "feature_extractor.backbone."
    if stem == "deep":
        cb(f"{bb}conv1.0", f"{bb}conv1.1", 3, 64, 3)
        cb(f"{bb}conv1.3", f"{bb}conv1.4", 64, 64, 3)
        cb(f"{bb}conv1.6", f"{bb}bn1", 64, 128, 3)
    else:
        cb(f"{bb}conv1", f"{bb}bn1", 3, 64, 7)
    cin = cfg.stem_out
    for li, (n, planes, stride) in enumerate(
            zip(layers, (64, 128, 256, 512), (1, 2, 1, 1)), start=1):
        out = planes * exp
        for j in range(n):
            p = f"{bb}layer{li}.{j}"
            c = cin if j == 0 else out
            if block == "bottleneck":
                cb(f"{p}.conv1", f"{p}.bn1", c, planes)
                cb(f"{p}.conv2", f"{p}.bn2", planes, planes, 3)
                cb(f"{p}.conv3", f"{p}.bn3", planes, out)
            else:
                cb(f"{p}.conv1", f"{p}.bn1", c, planes, 3)
                cb(f"{p}.conv2", f"{p}.bn2", planes, planes, 3)
            if j == 0 and (stride != 1 or cin != out):
                cb(f"{p}.downsample.0", f"{p}.downsample.1", c, out)
        cin = out

    fe = "feature_extractor."
    aspp_in = 512 * exp
    for i, k in enumerate((1, 3, 3, 3)):
        cb(f"{fe}aspp.concurent.{i}.0", f"{fe}aspp.concurent.{i}.1",
           aspp_in, ch, k)
    cb(f"{fe}aspp.concurent.4.gap.1", f"{fe}aspp.concurent.4.gap.2",
       aspp_in, ch)
    cb(f"{fe}aspp.project.0", f"{fe}aspp.project.1", 5 * ch, ch)
    cb(f"{fe}skip_project.skip_project.0", f"{fe}skip_project.skip_project.1",
       64 * exp, 32)
    sep(f"{fe}head.block.0", ch + 32, ch)
    sep(f"{fe}head.block.1", ch, ch)
    conv(f"{fe}head.block.2", ch, ch, bias=True)
    sep("head.layers.0", ch, ch // 2)
    sep("head.layers.1", ch // 2, ch // 2)
    conv("head.layers.2", ch // 2, 1, bias=True)
    return sd


@pytest.mark.parametrize("backbone", ["resnet34", "resnet50"])
def test_deeplab_tree_and_strict_load_match_jax(backbone):
    """Both stems and block types at the ResNets' full widths (ch 32): the
    same tree as JAX's converter, exactly JAX's init names and shapes, and
    a strict load that keeps every leaf."""
    jcfg = DeeplabISConfig(backbone=backbone, ch=32)
    sd = make_reference_deeplab_sd(jcfg)
    cfg = port_cfg(jcfg)
    tree = tingest.convert_deeplab_checkpoint(sd, cfg)
    want = jingest.convert_deeplab_checkpoint(sd, jcfg)
    assert_trees_equal(tree, want)
    flat = ser.flatten_tree(tree)
    assert {k: v.shape for k, v in flat.items()} == init_names(jcfg)
    assert flat["maps_transform/scale"] == np.float32(0.07)
    model = registry.load(flat, cfg)
    for n, p in model.state_dict().items():
        np.testing.assert_array_equal(p.numpy(), flat[ser.jax_name(n)])


def test_hrnet_tree_reaches_the_session_path():
    """The loaded HRNet runs a CPU session through the registry's predictor
    (finite, in [0, 1])."""
    from pvpuformer_tpu_torch.inference.predictor import (Predictor,
                                                          PredictorConfig)
    cfg = dataclasses.replace(port_cfg(HRNET), num_max_points=6)
    tree = tingest.convert_hrnet_checkpoint(
        redraw_constants(make_reference_hrnet_sd(HRNET)), cfg)
    model = registry.load(ser.flatten_tree(tree), cfg)
    pred = Predictor(model, PredictorConfig(model=cfg, target_size=(64, 64)),
                     device="cpu")
    img = (np.random.default_rng(0).uniform(size=(64, 80, 3)) * 255
           ).astype(np.uint8)
    gt = np.zeros((64, 80), np.float32)
    gt[20:40, 25:60] = 1
    pred.set_input(img, gt)
    ious = pred.run_clicks(2)
    assert ious.shape == (2,) and np.isfinite(ious).all()
    assert ((ious >= 0) & (ious <= 1)).all()
