"""The port's CLIP towers and tokenizers (pvpuformer_tpu_torch/models/zoo/
clip_text.py) against the JAX package's, on the CPU at small sizes.

Weights: each JAX `init_*` tree, its structure read with `jax.eval_shape`,
its leaves drawn from a numpy seed (tests/test_torch_zoo.py:_leaf: LayerNorm
and BN affines and BN statistics away from the identity, biases non-zero),
read by the port as a checkpoint is (`params_from_numpy`), strictly.

Tolerances: f32 forwards within 1e-5 of the jitted JAX forward relative to
its largest magnitude (the same f32 math summed in another order); the bf16
text encoder within 2e-2 of it (two bf16 roundings of the output and of
every block's residual stream; measured 1.06e-2); the tokenizers and
the bicubic matrices exactly."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvpuformer_tpu.models.zoo import clip_text as jclip
from pvpuformer_tpu.ops import resize as jresize
from pvpuformer_tpu.utils.serialization import flatten_tree
from pvpuformer_tpu_torch.models.zoo import clip_text as tclip
from pvpuformer_tpu_torch.ops import resize as tresize
from pvpuformer_tpu_torch.utils.serialization import (params_from_numpy,
                                                      torch_name)
from test_torch_zoo import _leaf

TOL = 1e-5
TEXT = jclip.ClipTextConfig(width=32, heads=2, layers=2, context_length=32,
                            embed_dim=16)
RESNET = jclip.ClipVisualConfig(layers=(2, 1, 1, 1), width=8, heads=4,
                                output_dim=16, input_resolution=64)
VIT = jclip.ClipViTConfig(input_resolution=32, patch_size=16, width=32,
                          layers=2, heads=2, output_dim=16)
CAPTIONS = ["the left box", "a small square", "", "x" * 40]


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def jax_tree(init, cfg, seed: int = 0):
    """`init(key, cfg)`'s tree (eval_shape) with numpy-drawn leaves."""
    shapes = jax.eval_shape(lambda k: init(k, cfg), jax.random.key(0))
    r = np.random.default_rng(seed)

    def leaf(path, s):
        name = getattr(path[-1], "key", None)
        return jnp.asarray(_leaf(r, name, s.shape).astype(np.float32))
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def pcfg(jcfg):
    """The port's config of the same class name and fields."""
    return getattr(tclip, type(jcfg).__name__)(**jcfg.__dict__)


def port_module(cls, tree, jcfg):
    """The port's module of `jcfg` with the JAX tree's leaves, loaded
    strictly."""
    m = cls(pcfg(jcfg))
    m.load_state_dict(params_from_numpy(flatten_tree(tree)))
    return m


@functools.lru_cache(maxsize=None)
def text_tree():
    return jax_tree(jclip.init_clip_text, TEXT, 1)


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(1e-30, np.abs(want).max()))


_j_text = jax.jit(jclip.encode_text, static_argnums=1)
_j_resnet = jax.jit(jclip.encode_image_resnet, static_argnums=1)
_j_vit = jax.jit(jclip.encode_image_vit, static_argnums=1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_text_matches_jax(dtype):
    """The causal tower pooled at EOT (the first maximum: the empty caption
    and the 40-byte one cut at the context both have one EOS)."""
    tree = text_tree()
    toks = jclip.byte_tokenizer(CAPTIONS, TEXT.context_length)
    jdt = getattr(jnp, dtype)
    want = _j_text(jax.tree_util.tree_map(lambda a: a.astype(jdt), tree),
                   TEXT, jnp.asarray(toks))
    m = port_module(tclip.ClipText, tree, TEXT).to(getattr(torch, dtype))
    got = tclip.encode_text(m, pcfg(TEXT),
                            torch.from_numpy(toks))
    assert got.dtype == getattr(torch, dtype) and got.shape == (4, 16)
    assert rel_err(got.float(), want.astype(jnp.float32)) <= \
        (TOL if dtype == "float32" else 2e-2)


def test_causal_attention_keeps_f32_logits():
    """bf16, one block: the tower's attention is not `nn.sdpa` (which
    rounds its logits to bf16). It equals JAX's eager `_causal_attn` bit for
    bit (measured: every output); with the logits rounded to bf16 about
    half the outputs move (measured 48%)."""
    tree = text_tree()
    jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16),
                                tree["blocks"][0])
    x = np.random.default_rng(0).normal(size=(2, 32, 32)).astype(np.float32)
    want = np.asarray(jclip._causal_attn(jp, jnp.asarray(x, jnp.bfloat16),
                                         2).astype(jnp.float32))
    blk = port_module(tclip.ClipText, tree, TEXT).to(torch.bfloat16).blocks[0]
    xt = torch.from_numpy(x).bfloat16()
    np.testing.assert_array_equal(tclip._attn(blk, xt, 2).float().numpy(),
                                  want)
    orig = torch.einsum

    def rounded(spec, a, b):
        out = orig(spec, a, b)
        return out.bfloat16().float() if spec == "bqhd,bkhd->bhqk" else out
    torch.einsum = rounded
    try:
        worse = tclip._attn(blk, xt, 2).float().numpy()
    finally:
        torch.einsum = orig
    assert (worse != want).mean() > 0.1


@pytest.mark.parametrize("hw", [64, 96], ids=["native", "resized-pos"])
def test_encode_image_resnet_matches_jax(hw):
    """RN tower at width 8 (embed 256), two blocks in layer1 (one with and
    one without the downsample); 96 px resizes the pool's 2 x 2 positional
    grid to 3 x 3 through the bicubic matrices."""
    tree = jax_tree(jclip.init_modified_resnet, RESNET, 2)
    img = np.random.default_rng(3).normal(size=(2, hw, hw, 3)) \
        .astype(np.float32)
    want = _j_resnet(tree, RESNET, jnp.asarray(img))
    m = port_module(tclip.ModifiedResNet, tree, RESNET)
    got = tclip.encode_image_resnet(m, pcfg(RESNET),
                                    torch.from_numpy(img))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        assert rel_err(g, w) <= TOL


def test_encode_image_vit_matches_jax():
    tree = jax_tree(jclip.init_clip_vit, VIT, 4)
    img = np.random.default_rng(5).normal(size=(2, 32, 32, 3)) \
        .astype(np.float32)
    want = _j_vit(tree, VIT, jnp.asarray(img))
    m = port_module(tclip.ClipViT, tree, VIT)
    got = tclip.encode_image_vit(m, pcfg(VIT),
                                 torch.from_numpy(img))
    assert tuple(got.shape) == want.shape == (2, 4, 16)
    assert rel_err(got, want) <= TOL


@pytest.mark.parametrize("cls,jinit,cfg", [
    (tclip.ClipText, jclip.init_clip_text, TEXT),
    (tclip.ModifiedResNet, jclip.init_modified_resnet, RESNET),
    (tclip.ClipViT, jclip.init_clip_vit, VIT)], ids=["text", "resnet", "vit"])
def test_module_tree_is_the_jax_init_tree(cls, jinit, cfg):
    shapes = flatten_tree(jax.tree_util.tree_map(
        lambda s: np.empty(s.shape, np.float32),
        jax.eval_shape(lambda k: jinit(k, cfg), jax.random.key(0))))
    m = cls(pcfg(cfg), torch.Generator().manual_seed(0))
    got = {k: tuple(v.shape) for k, v in m.state_dict().items()}
    assert got == {torch_name(k): v.shape for k, v in shapes.items()}


def test_tokenizers_equal_jax(tmp_path):
    merges = tmp_path / "merges.txt"
    merges.write_text("#version\na b</w>\nh e\nl l\nhe ll\nt h\nth e</w>\n")
    texts = ["ab cd", "hello &amp; the  World's 42 cats!", "", "über ✓",
             "x" * 100]
    jtok, ttok = jclip.BPETokenizer(str(merges)), \
        tclip.BPETokenizer(str(merges))
    assert ttok.encoder == jtok.encoder and ttok.bpe_ranks == jtok.bpe_ranks
    for t in texts:
        assert ttok.encode(t) == jtok.encode(t)
    for n in (8, 77):
        np.testing.assert_array_equal(ttok(texts, n), jtok(texts, n))
        out = tclip.byte_tokenizer(texts, n)
        assert out.dtype == np.int32
        np.testing.assert_array_equal(out, jclip.byte_tokenizer(texts, n))
    assert tclip.get_tokenizer(None) is tclip.byte_tokenizer
    assert tclip.get_tokenizer(str(tmp_path / "none.txt")) is \
        tclip.byte_tokenizer
    assert isinstance(tclip.get_tokenizer(str(merges)), tclip.BPETokenizer)
    assert (tclip.BOS, tclip.EOS) == (jclip.BOS, jclip.EOS)


@pytest.mark.parametrize("src,dst", [(2, 3), (7, 14), (7, 7), (14, 7),
                                     (5, 1), (1, 4)])
def test_bicubic_axis_matrix_equals_jax(src, dst):
    got = tresize._bicubic_axis_matrix(src, dst)
    want = jresize._bicubic_axis_matrix(src, dst)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
