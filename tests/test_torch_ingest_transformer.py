"""The port's transformer-backbone converters
(pvpuformer_tpu_torch/utils/torch_ingest.py: MiT in mmseg's and in the
official NVlabs layout, Swin, HRFormer) against the JAX package's, on the
CPU.

The state dicts are made up with each layout's key names at small widths:
MiT (mmseg) and Swin as tests/test_utils.py's
`test_mit_backbone_ingest` / `test_swin_backbone_ingest` build them, the
official MiT layout and HRFormer (HRT_B_OCR_V3 keys) with the names JAX's
`convert_mit_official` / `convert_hrformer_checkpoint` read. Every tree
equals JAX's key for key and bit for bit. A backbone-only tree (MiT, Swin:
the releases carry no head) replaces those leaves of the family's tree
and loads strictly; HRFormer's is the whole tree and loads strictly as it
is."""
import numpy as np
import pytest

from pvpuformer_tpu.models.zoo.hrformer import HRFormerISConfig
from pvpuformer_tpu.models.zoo.segformer import SegformerISConfig
from pvpuformer_tpu.models.zoo.swin import SwinISConfig
from pvpuformer_tpu.utils import torch_ingest as jingest
from pvpuformer_tpu_torch.models import registry
from pvpuformer_tpu_torch.utils import serialization as ser
from pvpuformer_tpu_torch.utils import torch_ingest as tingest
from test_torch_ingest_vit import assert_trees_equal, init_names, port_cfg

MIT = SegformerISConfig(embed_dims=(16, 32, 48, 64), depths=(1, 2, 1, 1),
                        num_heads=(1, 2, 3, 4), head_channels=32)
SWIN = SwinISConfig(embed_dim=16, depths=(1, 1), num_heads=(2, 4), window=4,
                    head_channels=16, patch_norm=True)
HRFORMER = HRFormerISConfig(width=8, num_heads=(1, 2, 4, 8),
                            num_units=(1, 1, 1), window=4, ocr_width=16)
MIT_PATCH = [(7, 3), (3, 16), (3, 32), (3, 48)]    # (kernel, in channels)


class Maker:
    """Random leaves of a made-up state dict, in torch layouts."""

    def __init__(self, seed=0):
        self.r = np.random.default_rng(seed)
        self.sd = {}

    def put(self, name, *shape, std=0.05, mean=0.0):
        self.sd[name] = self.r.normal(mean, std, shape).astype(np.float32)

    def lin(self, name, i, o, bias=True):
        self.put(f"{name}.weight", o, i)
        if bias:
            self.put(f"{name}.bias", o, std=0.02)

    def ln(self, name, c):
        self.put(f"{name}.weight", c, mean=1.0)
        self.put(f"{name}.bias", c, std=0.02)

    def conv(self, name, i, o, k, bias=True, groups=1):
        self.put(f"{name}.weight", o, i // groups, k, k)
        if bias:
            self.put(f"{name}.bias", o, std=0.02)

    def bn(self, name, c):
        self.ln(name, c)
        self.put(f"{name}.running_mean", c, std=0.1)
        self.sd[f"{name}.running_var"] = self.r.uniform(
            0.5, 2.0, (c,)).astype(np.float32)

    def cb(self, cname, bname, i, o, k, bias=False, groups=1):
        self.conv(cname, i, o, k, bias, groups)
        self.bn(bname, o)


def make_mit_mmseg_sd(cfg):
    m = Maker()
    for i, d in enumerate(cfg.embed_dims):
        k, cin = MIT_PATCH[i]
        m.conv(f"layers.{i}.0.projection", cin, d, k)
        m.ln(f"layers.{i}.0.norm", d)
        for j in range(cfg.depths[i]):
            b = f"layers.{i}.1.{j}"
            m.ln(f"{b}.norm1", d)
            m.put(f"{b}.attn.attn.in_proj_weight", 3 * d, d)
            m.put(f"{b}.attn.attn.in_proj_bias", 3 * d, std=0.02)
            m.lin(f"{b}.attn.attn.out_proj", d, d)
            if cfg.sr_ratios[i] > 1:
                m.conv(f"{b}.attn.sr", d, d, cfg.sr_ratios[i])
                m.ln(f"{b}.attn.norm", d)
            m.ln(f"{b}.norm2", d)
            hidden = int(d * cfg.mlp_ratio)
            m.conv(f"{b}.ffn.layers.0", d, hidden, 1)
            m.conv(f"{b}.ffn.layers.1", hidden, hidden, 3, groups=hidden)
            m.conv(f"{b}.ffn.layers.4", hidden, d, 1)
        m.ln(f"layers.{i}.2", d)
    return m.sd


def make_mit_official_sd(cfg, prefix=""):
    """mix_transformer.py:308- names (mit_b0..b5.pth)."""
    m = Maker(1)
    for i, d in enumerate(cfg.embed_dims):
        k, cin = MIT_PATCH[i]
        s = f"{prefix}patch_embed{i + 1}"
        m.conv(f"{s}.proj", cin, d, k)
        m.ln(f"{s}.norm", d)
        for j in range(cfg.depths[i]):
            b = f"{prefix}block{i + 1}.{j}"
            m.ln(f"{b}.norm1", d)
            m.lin(f"{b}.attn.q", d, d)
            m.lin(f"{b}.attn.kv", d, 2 * d)
            m.lin(f"{b}.attn.proj", d, d)
            if cfg.sr_ratios[i] > 1:
                m.conv(f"{b}.attn.sr", d, d, cfg.sr_ratios[i])
                m.ln(f"{b}.attn.norm", d)
            m.ln(f"{b}.norm2", d)
            hidden = int(d * cfg.mlp_ratio)
            m.lin(f"{b}.mlp.fc1", d, hidden)
            m.conv(f"{b}.mlp.dwconv.dwconv", hidden, hidden, 3, groups=hidden)
            m.lin(f"{b}.mlp.fc2", hidden, d)
        m.ln(f"{prefix}norm{i + 1}", d)
    m.put(f"{prefix}head.weight", 1000, cfg.embed_dims[-1])
    return m.sd


def make_swin_sd(cfg, stage_norms=True):
    """Official Swin names; `stage_norms` False gives a classification
    release's single final `norm` in place of `norm{i}`."""
    m = Maker(2)
    m.conv("patch_embed.proj", 3, cfg.embed_dim, 4)
    m.ln("patch_embed.norm", cfg.embed_dim)
    for i, d in enumerate(cfg.stage_dims):
        for j in range(cfg.depths[i]):
            b = f"layers.{i}.blocks.{j}"
            m.ln(f"{b}.norm1", d)
            m.lin(f"{b}.attn.qkv", d, 3 * d)
            m.lin(f"{b}.attn.proj", d, d)
            m.put(f"{b}.attn.relative_position_bias_table",
                  (2 * cfg.window - 1) ** 2, cfg.num_heads[i], std=0.02)
            m.sd[f"{b}.attn.relative_position_index"] = np.zeros(
                (cfg.window ** 4,), np.float32)
            m.ln(f"{b}.norm2", d)
            m.lin(f"{b}.mlp.fc1", d, 4 * d)
            m.lin(f"{b}.mlp.fc2", 4 * d, d)
        if stage_norms:
            m.ln(f"norm{i}", d)
        if i < len(cfg.depths) - 1:
            m.ln(f"layers.{i}.downsample.norm", 4 * d)
            m.lin(f"layers.{i}.downsample.reduction", 4 * d, 2 * d,
                  bias=False)
    if not stage_norms:
        m.ln("norm", cfg.stage_dims[-1])
    return m.sd


def make_hrformer_sd(cfg):
    """HRT_B_OCR_V3 names (hrformer.py:55-110, hrt_backbone.py): the stem
    takes the RGB and coord channels, every transformer MLP conv is biased,
    the fuse convs are not, the OCR convs are."""
    m = Maker(3)
    bb = "backbone."
    w = cfg.branch_widths
    coord_ch = 3 if cfg.with_prev_mask else 2
    m.cb(f"{bb}conv1", f"{bb}bn1", 3 + coord_ch, 64, 3)
    m.cb(f"{bb}conv2", f"{bb}bn2", 64, 64, 3)
    for j in range(2):
        p = f"{bb}layer1.{j}"
        cin = 64 if j == 0 else 256
        m.cb(f"{p}.conv1", f"{p}.bn1", cin, 64, 1)
        m.cb(f"{p}.conv2", f"{p}.bn2", 64, 64, 3)
        m.cb(f"{p}.conv3", f"{p}.bn3", 64, 256, 1)
        if j == 0:
            m.cb(f"{p}.downsample.0", f"{p}.downsample.1", cin, 256, 1)

    def transition(name, prev, cur):
        for i, cw in enumerate(cur):
            base = f"{bb}{name}.{i}"
            if i < len(prev):
                if prev[i] != cw:
                    m.cb(f"{base}.0", f"{base}.1", prev[i], cw, 3)
            else:
                m.cb(f"{base}.0.0", f"{base}.0.1", prev[-1], cw, 3)

    def stage(name, widths, units):
        for u in range(units):
            p = f"{bb}{name}.{u}"
            for bi, d in enumerate(widths):
                for j in range(cfg.blocks_per_unit):
                    b = f"{p}.branches.{bi}.{j}"
                    a = f"{b}.attn.attn"
                    m.ln(f"{b}.norm1", d)
                    for part in ("q_proj", "k_proj", "v_proj", "out_proj"):
                        m.lin(f"{a}.{part}", d, d)
                    m.put(f"{a}.relative_position_bias_table",
                          (2 * cfg.window - 1) ** 2, cfg.num_heads[bi],
                          std=0.02)
                    m.ln(f"{b}.norm2", d)
                    hidden = int(d * cfg.mlp_ratio)
                    m.cb(f"{b}.mlp.fc1", f"{b}.mlp.norm1", d, hidden, 1,
                         bias=True)
                    m.cb(f"{b}.mlp.dw3x3", f"{b}.mlp.norm2", hidden, hidden,
                         3, bias=True, groups=hidden)
                    m.cb(f"{b}.mlp.fc2", f"{b}.mlp.norm3", hidden, d, 1,
                         bias=True)
            for i in range(len(widths)):
                for j in range(len(widths)):
                    f = f"{p}.fuse_layers.{i}.{j}"
                    if j > i:
                        m.cb(f"{f}.0", f"{f}.1", widths[j], widths[i], 1)
                    elif j < i:
                        for k in range(i - j):
                            cout = widths[i] if k == i - j - 1 else widths[j]
                            m.cb(f"{f}.{k}.0", f"{f}.{k}.1", widths[j],
                                 widths[j], 3, groups=widths[j])
                            m.cb(f"{f}.{k}.2", f"{f}.{k}.3", widths[j], cout,
                                 1)

    transition("transition1", (256,), w[:2])
    stage("stage2", w[:2], cfg.num_units[0])
    transition("transition2", w[:2], w[:3])
    stage("stage3", w[:3], cfg.num_units[1])
    transition("transition3", w[:3], w)
    stage("stage4", w, cfg.num_units[2])

    in_ch, hid = sum(w), cfg.ocr_width
    g = int(np.gcd(in_ch, hid))
    kc = hid // 2
    m.cb("conv3x3.0", "conv3x3.1.0", in_ch, hid, 7, bias=True, groups=g)
    m.cb("aux_head.0", "aux_head.1.0", in_ch, hid, 7, bias=True, groups=g)
    m.conv("aux_head.2", hid, 1, 1)
    oc = "ocr_distri_head.object_context_block"
    for name in ("f_pixel", "f_object"):
        m.cb(f"{oc}.{name}.0", f"{oc}.{name}.1.0", hid, kc, 1, bias=True)
        m.cb(f"{oc}.{name}.2", f"{oc}.{name}.3.0", kc, kc, 1, bias=True)
    m.cb(f"{oc}.f_down.0", f"{oc}.f_down.1.0", hid, kc, 1, bias=True)
    m.cb(f"{oc}.f_up.0", f"{oc}.f_up.1.0", kc, hid, 1, bias=True)
    m.cb("ocr_distri_head.conv_bn_dropout.0",
         "ocr_distri_head.conv_bn_dropout.1.0", 2 * hid, hid, 1, bias=True)
    m.conv("cls_head", hid, 1, 1)
    return m.sd


def load_part(jcfg, part):
    """The family's zero tree with `part`'s leaves in place of its own,
    loaded strictly: `part` must name only leaves of that tree, at their
    shapes, and every one of them lands in the module."""
    names = init_names(jcfg)
    new = ser.flatten_tree(part)
    assert {k: names.get(k) for k in new} == {k: v.shape
                                              for k, v in new.items()}
    cfg = port_cfg(jcfg)
    flat = {ser.jax_name(n): p.numpy() for n, p in
            registry.model_for(cfg)(cfg).state_dict().items()}
    assert set(flat) == set(names)
    flat.update(new)
    state = registry.load(flat, cfg).state_dict()
    for k, v in new.items():
        np.testing.assert_array_equal(state[ser.torch_name(k)].numpy(), v,
                                      err_msg=k)


def test_mit_mmseg_tree_and_load_match_jax():
    """With the stage-1 channel surgery (3 RGB channels + 3 coord channels
    copied from the first three)."""
    sd = make_mit_mmseg_sd(MIT)
    tree = tingest.convert_mit_backbone(sd, port_cfg(MIT))
    assert_trees_equal(tree, jingest.convert_mit_backbone(sd, MIT))
    assert tree["stages"][0]["patch"]["w"].shape == (7, 7, 6, 16)
    load_part(MIT, tree)


@pytest.mark.parametrize("prefix", ["", "backbone."])
def test_mit_official_tree_and_load_match_jax(prefix):
    sd = make_mit_official_sd(MIT, prefix)
    tree = tingest.convert_mit_official(sd, port_cfg(MIT), prefix=prefix)
    assert_trees_equal(tree, jingest.convert_mit_official(sd, MIT,
                                                          prefix=prefix))
    load_part(MIT, tree)


@pytest.mark.parametrize("stage_norms", [True, False],
                         ids=["segmentation", "classification"])
def test_swin_tree_and_load_match_jax(stage_norms):
    """A segmentation release (norm{i} per stage) and a classification one
    (one final norm; the other stages' norms stay the identity)."""
    sd = make_swin_sd(SWIN, stage_norms)
    tree = tingest.convert_swin_backbone(sd, port_cfg(SWIN))
    assert_trees_equal(tree, jingest.convert_swin_backbone(sd, SWIN))
    if not stage_norms:
        np.testing.assert_array_equal(tree["stages"][0]["norm"]["scale"],
                                      np.ones(16, np.float32))
    load_part(SWIN, tree)


def test_hrformer_tree_and_strict_load_match_jax():
    sd = make_hrformer_sd(HRFORMER)
    cfg = port_cfg(HRFORMER)
    tree = tingest.convert_hrformer_checkpoint(sd, cfg)
    assert_trees_equal(tree, jingest.convert_hrformer_checkpoint(sd,
                                                                 HRFORMER))
    flat = ser.flatten_tree(tree)
    assert {k: v.shape for k, v in flat.items()} == init_names(HRFORMER)
    model = registry.load(flat, cfg)
    for n, p in model.state_dict().items():
        np.testing.assert_array_equal(p.numpy(), flat[ser.jax_name(n)])


def test_hrformer_backbone_only_checkpoint_has_no_ocr():
    """An HRT backbone release without the OCR head converts to the
    backbone's leaves alone, which load over the family's tree."""
    sd = {k: v for k, v in make_hrformer_sd(HRFORMER).items()
          if k.startswith("backbone.")}
    tree = tingest.convert_hrformer_checkpoint(sd, port_cfg(HRFORMER))
    assert "ocr" not in tree
    assert_trees_equal(tree, jingest.convert_hrformer_checkpoint(sd,
                                                                 HRFORMER))
    load_part(HRFORMER, tree)

