"""The port's vision-language decoder (pvpuformer_tpu_torch/models/
decoder.py) against the JAX package's, on the CPU.

Weights: JAX's `init_decoder` tree (jax.eval_shape) with numpy-drawn
leaves (tests/test_torch_clip.py:jax_tree), loaded strictly. The four
`as_text` x `image_to_token` forms, each with its per-layer outputs; with
both set JAX adds the text positions to the threaded vis tokens, so that
form takes as many text tokens as image tokens (JAX raises otherwise, and
so does the port).

Tolerances: f32 within 1e-5 of the jitted JAX forward relative to its
largest magnitude (measured at most 5.3e-7); the int8 decoder
(`nn.quantize_params`: the packed in-projection is one `QuantLinear`,
sliced per projection) within the same 1e-5 of JAX's jitted int8 decoder
on the same float weights (measured 2.4e-7: no int8 value moved), and
against the float decoder at JAX's own bound, cosine > 0.98
(tests/test_quant.py:169-183; measured 0.9998)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvpuformer_tpu import nn as jnn
from pvpuformer_tpu.models import decoder as jdec
from pvpuformer_tpu.utils.serialization import flatten_tree
from pvpuformer_tpu_torch import nn as tnn
from pvpuformer_tpu_torch.models import decoder as tdec
from pvpuformer_tpu_torch.utils.serialization import params_from_numpy
from test_torch_clip import jax_tree, rel_err

CFG = jdec.DecoderConfig(num_layers=2, d_model=64, nhead=4, dim_ffn=128,
                         return_intermediate=True)
GRID = (4, 4)
FORMS = [(False, False), (True, False), (False, True), (True, True)]


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    tree = jax_tree(jdec.init_decoder, CFG, 7)
    cfg = tdec.DecoderConfig(**CFG.__dict__)
    m = tdec.Decoder(cfg)
    m.load_state_dict(params_from_numpy(flatten_tree(tree)))
    return tree, m, cfg


def _inputs(as_text, image_to_token, seed=0):
    r = np.random.default_rng(seed)
    hw = GRID[0] * GRID[1]
    n_txt = hw if as_text and image_to_token else 5
    vis = r.normal(size=(2, hw, 64)).astype(np.float32)
    txt = r.normal(size=(2, n_txt, 64)).astype(np.float32)
    return vis, txt


_j_fwd = jax.jit(jdec.decoder_forward, static_argnums=(1, 4, 5, 6))


def test_positions_equal_jax():
    for d, n in ((64, 5), (512, 77)):
        np.testing.assert_array_equal(tdec.pos1d_sincos(d, n),
                                      jdec.pos1d_sincos(d, n))
    for d, h, w in ((64, 4, 4), (512, 28, 28), (16, 3, 5)):
        np.testing.assert_array_equal(tdec.pos2d_sincos(d, h, w),
                                      jdec.pos2d_sincos(d, h, w))


@pytest.mark.parametrize("as_text,image_to_token", FORMS,
                         ids=["txt", "txt-pos", "i2t", "i2t-pos"])
def test_decoder_forward_matches_jax(models, as_text, image_to_token):
    tree, m, cfg = models
    vis, txt = _inputs(as_text, image_to_token)
    want = _j_fwd(tree, CFG, jnp.asarray(vis), jnp.asarray(txt), GRID,
                  as_text, image_to_token)
    got = tdec.decoder_forward(m, cfg, torch.from_numpy(vis),
                               torch.from_numpy(txt), GRID, as_text,
                               image_to_token)
    assert len(got) == len(want) == CFG.num_layers
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        assert rel_err(g, w) <= 1e-5
    final = tdec.decoder_forward(
        m, tdec.DecoderConfig(**{**cfg.__dict__,
                                 "return_intermediate": False}),
        torch.from_numpy(vis), torch.from_numpy(txt), GRID, as_text,
        image_to_token)
    assert torch.equal(final, got[-1])


def test_both_flags_need_as_many_text_tokens_as_image_tokens(models):
    _, m, cfg = models
    vis = torch.zeros(1, 16, 64)
    with pytest.raises(RuntimeError):
        tdec.decoder_forward(m, cfg, vis, torch.zeros(1, 5, 64), GRID,
                             as_text=True, image_to_token=True)


@pytest.mark.parametrize("as_text,image_to_token", [(False, False),
                                                    (False, True)],
                         ids=["txt", "i2t"])
def test_int8_decoder_matches_jax(models, as_text, image_to_token):
    tree, m, cfg = models
    q = tnn.quantize_params(m)
    ip = q.layers[0].self_attn.in_proj
    assert isinstance(ip, tnn.QuantLinear) and tuple(ip.w_q.shape) == \
        (64, 192)
    # each projection's column slice keeps the column-major layout that
    # the card's int8 product takes as its second operand
    assert all(ip.w_q[:, i * 64:(i + 1) * 64].t().is_contiguous()
               for i in range(3))
    jq = jnn.quantize_params(tree)
    vis, txt = _inputs(as_text, image_to_token, seed=1)
    args = (jnp.asarray(vis), jnp.asarray(txt), GRID, as_text,
            image_to_token)
    want_q = _j_fwd(jq, CFG, *args)[-1]
    want_f = np.asarray(_j_fwd(tree, CFG, *args)[-1]).ravel()
    got = tdec.decoder_forward(q, cfg, torch.from_numpy(vis),
                               torch.from_numpy(txt), GRID, as_text,
                               image_to_token)[-1]
    assert rel_err(got, want_q) <= 1e-5
    g = got.numpy().ravel()
    cos = float(g @ want_f / (np.linalg.norm(g) * np.linalg.norm(want_f)))
    assert cos > 0.98, cos
