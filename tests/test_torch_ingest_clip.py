"""The port's CLIP converters (pvpuformer_tpu_torch/utils/torch_ingest.py:
convert_clip_resnet, convert_clip_vit, convert_clip_text) against the JAX
package's, on the CPU.

The state dicts are chip_smoke.py's reference-named generators
(`clip_resnet_reference_sd`, `clip_vit_reference_sd`,
`clip_text_reference_sd`: modeling/clip.py's names and shapes, BN and LN
affines away from the identity) at small widths; the visual ones also
under the `visual.` prefix of a whole CLIP checkpoint. Every converted
tree equals JAX's key for key and bit for bit, `load_clip` loads it
strictly (a missing or extra leaf raises), and the loaded module's f32
forward is within 1e-5 of JAX's jitted forward on JAX's tree, relative to
its largest magnitude (tests/test_torch_clip.py's bound)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from pvpuformer_tpu.models.zoo import clip_text as jclip
from pvpuformer_tpu.utils import torch_ingest as jingest
from pvpuformer_tpu_torch.models.zoo import clip_text as tclip
from pvpuformer_tpu_torch.utils import torch_ingest as tingest
from test_torch_clip import (RESNET, TEXT, VIT, _j_resnet, _j_text, _j_vit,
                             pcfg, rel_err)
from test_torch_clip import two_torch_threads  # noqa: F401 (autouse)
from test_torch_ingest_vit import assert_trees_equal

CASES = {
    "resnet": (RESNET, chip_smoke.clip_resnet_reference_sd,
               "convert_clip_resnet", _j_resnet, tclip.encode_image_resnet),
    "vit": (VIT, chip_smoke.clip_vit_reference_sd, "convert_clip_vit",
            _j_vit, tclip.encode_image_vit),
    "text": (TEXT, chip_smoke.clip_text_reference_sd, "convert_clip_text",
             _j_text, tclip.encode_text),
}


def _input(name, jcfg):
    if name == "text":
        return jclip.byte_tokenizer(["a cat", "the red ball", ""],
                                    jcfg.context_length)
    hw = jcfg.input_resolution
    return np.random.default_rng(1).normal(size=(2, hw, hw, 3)) \
        .astype(np.float32)


@pytest.mark.parametrize("name", list(CASES))
def test_clip_converter_matches_jax_and_loads_strictly(name):
    jcfg, make_sd, conv, jfwd, tfwd = CASES[name]
    cfg = pcfg(jcfg)
    sd = make_sd(cfg, seed=2)
    tree = getattr(tingest, conv)(sd, cfg)
    want = getattr(jingest, conv)(sd, jcfg)
    assert_trees_equal(tree, want)
    module = tingest.load_clip(tree, cfg)
    x = _input(name, jcfg)
    got = tfwd(module, cfg, torch.from_numpy(x))
    ref = jfwd(jax_tree(want), jcfg, jnp.asarray(x))
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for g, w in zip(got, ref):
        assert tuple(g.shape) == w.shape
        assert rel_err(g.detach(), w) <= 1e-5


def jax_tree(tree):
    """A converted numpy tree as JAX arrays (lists and dicts kept)."""
    if isinstance(tree, dict):
        return {k: jax_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [jax_tree(v) for v in tree]
    return jnp.asarray(tree)


@pytest.mark.parametrize("name", ["resnet", "vit"])
def test_visual_prefix_is_read(name):
    """A whole CLIP checkpoint keeps the towers under `visual.`."""
    jcfg, make_sd, conv, _, _ = CASES[name]
    cfg = pcfg(jcfg)
    sd = make_sd(cfg, seed=3)
    bare = {k[len("visual."):] if k.startswith("visual.") else k: v
            for k, v in sd.items()}
    pre = {f"visual.{k}": v for k, v in bare.items()}
    a = getattr(tingest, conv)(bare, cfg)
    assert_trees_equal(a, getattr(jingest, conv)(pre, jcfg))
    assert_trees_equal(getattr(tingest, conv)(pre, cfg),
                       getattr(jingest, conv)(bare, jcfg))


def test_load_clip_refuses_a_missing_or_extra_leaf():
    cfg = pcfg(TEXT)
    tree = tingest.convert_clip_text(
        chip_smoke.clip_text_reference_sd(cfg), cfg)
    missing = {k: v for k, v in tree.items() if k != "text_projection"}
    with pytest.raises(RuntimeError, match="text_projection"):
        tingest.load_clip(missing, cfg)
    extra = dict(tree, spare=np.zeros(3, np.float32))
    with pytest.raises(RuntimeError, match="spare"):
        tingest.load_clip(extra, cfg)
    # a state dict without logit_scale gets CLIP's initial value
    sd = chip_smoke.clip_text_reference_sd(cfg)
    sd.pop("logit_scale")
    got = tingest.load_clip(tingest.convert_clip_text(sd, cfg), cfg)
    assert float(got.logit_scale) == pytest.approx(np.log(1 / 0.07))
