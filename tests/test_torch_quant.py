"""The port's int8 PTQ serving path (`nn.quantize_params`, `nn.linear_int8`,
the int8 ViT block, `Predictor(int8=)`, `BatchedEvaluator(int8=)`) vs the
JAX package's, tiny config, the same converted weights.

Tolerances: the quantized parameter paths equal JAX's (mapped through
`serialization.torch_name`) and w_q / w_s / b are bit-equal, in f32 and
after the bf16 cast; `linear_int8` is bit-identical to JAX's
`_linear_int8` as XLA compiles it (which scales by f32(1/127), the
Predictor's and every jitted caller's) at the ViT block's linears, and
within 1e-6 relative elsewhere and of JAX's op-by-op division (measured
4.8e-7 absolute on outputs of size ~5: XLA's CPU backend contracts the
last `* w_s + b` into a fused multiply-add at the patch embed's shapes);
the int8 block within 1e-5 of JAX's.

Int8 sessions: a last-bit difference anywhere upstream of a quantized
linear moves a value across a rounding boundary now and then, and one
int8 quantum is ~1% of its row's largest value, so sessions carry noise
of about 1e-3 in IoU. JAX's own int8 session differs that much between
its jitted and op-by-op (`jax.disable_jit`) runs on the CPU: 1.56e-3
at seed 7, and seed 3's clicks part after a few rounds. The port against
JAX's jitted Predictor: the first click (the EDT of the gt, no network)
identical and IoU within 5e-3 at seeds 3, 7, 11 (measured 3.8e-3, 1.6e-3,
1.1e-3), and at seed 7, the sample of chip_smoke's parity phases, every
click identical; `BatchedEvaluator(int8=True)` against JAX's within 5e-3
(measured 3.4e-4) and against the port's sequential int8 sessions within
1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvpuformer_tpu import nn as jnn
from pvpuformer_tpu.inference.batched import BatchedEvaluator as JBatched
from pvpuformer_tpu.inference.datasets import SyntheticDataset as JSynthetic
from pvpuformer_tpu.inference.predictor import (Predictor as JPredictor,
                                                PredictorConfig as JConfig)
from pvpuformer_tpu.models import vit as jvit
from pvpuformer_tpu.utils.serialization import config_to_dict, flatten_tree
from pvpuformer_tpu_torch import nn
from pvpuformer_tpu_torch.inference import brs
from pvpuformer_tpu_torch.inference.batched import BatchedEvaluator
from pvpuformer_tpu_torch.inference.datasets import SyntheticDataset
from pvpuformer_tpu_torch.inference.predictor import Predictor
from pvpuformer_tpu_torch.models import vit
from pvpuformer_tpu_torch.utils.serialization import (config_from_dict,
                                                      torch_name)
from test_torch_eval import eval_weights
from test_torch_eval import two_torch_threads  # noqa: F401 (autouse)

CLICKS = 4


@pytest.fixture(scope="module")
def weights():
    params, jcfg, model = eval_weights()
    jpc = JConfig(model=jcfg, target_size=(64, 64), min_crop_size=32)
    return params, jpc, model, config_from_dict(config_to_dict(jpc))


def _leaf(t: torch.Tensor) -> np.ndarray:
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_params_picks_jax_paths_bit_equal(weights, dtype):
    params, _, model, _ = weights
    jq = flatten_tree(jnn.quantize_params(
        jnn.cast_params(params, getattr(jnp, dtype))))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    q = nn.quantize_params(model, dtype=getattr(torch, dtype))
    sd = q.state_dict()
    assert {torch_name(k) for k in jq} == set(sd)
    assert {torch_name(k)[:-4] for k in jq if k.endswith("/w_q")} == {
        name for name, m in q.named_modules()
        if isinstance(m, nn.QuantLinear)}
    # linears and patch embeds only: never a conv, not even the neck's
    # 2x2 / 2 conv, which the port runs as a patch matmul
    orig = dict(model.named_modules())
    assert {type(orig[name]) for name, m in q.named_modules()
            if isinstance(m, nn.QuantLinear)} == {nn.Linear, nn.PatchEmbed}
    for k, v in jq.items():
        t = sd[torch_name(k)]
        assert np.asarray(v).shape == tuple(t.shape), k
        np.testing.assert_array_equal(_leaf(t), np.asarray(v, _leaf(t).dtype),
                                      err_msg=k)
        if k.endswith(("/w_s", "/w_q")) or (k.endswith("/b") and
                                            k[:-2] + "/w_q" in jq):
            assert t.dtype == {"w_q": torch.int8}.get(k[-3:], torch.float32)
    # the caller's module is a float module as it was
    for k, v in model.state_dict().items():
        assert v.dtype == before[k].dtype and torch.equal(v, before[k])
    # casts and moves of the copy leave the int8 leaves as they are
    q2 = nn.cast_params(q, torch.bfloat16).to("cpu")
    lin = q2.backbone.blocks[0].attn.qkv
    assert (lin.w_q.dtype, lin.w_s.dtype, lin.b.dtype) == (
        torch.int8, torch.float32, torch.float32)
    assert lin.w_q.t().is_contiguous()


@pytest.mark.parametrize("shape", [(5, 64), (2, 16, 64), (3, 7, 64),
                                   (2, 16, 768)])
def test_linear_int8_matches_jax(weights, shape):
    params, _, model, _ = weights
    jq, q = jnn.quantize_params(params), nn.quantize_params(model)
    if shape[-1] == 64:
        jql, ql = jq["backbone"]["blocks"][0]["attn"]["qkv"], \
            q.backbone.blocks[0].attn.qkv
    else:
        jql, ql = jq["backbone"]["patch_embed"], q.backbone.patch_embed
    x = (np.random.default_rng(sum(shape)).normal(size=shape) * 3
         ).astype(np.float32)
    got = nn.linear(ql, torch.from_numpy(x)).numpy()
    jit = np.asarray(jax.jit(jnn._linear_int8)(jql, jnp.asarray(x)))
    eager = np.asarray(jnn._linear_int8(jql, jnp.asarray(x)))
    for want in (jit, eager):
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())
    if shape[-1] == 64:
        np.testing.assert_array_equal(got, jit)
    if shape[-1] != 64:
        return
    xb = torch.from_numpy(x).bfloat16()
    yb = nn.linear(ql, xb)
    assert yb.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        yb.float().numpy(), np.asarray(jax.jit(jnn._linear_int8)(
            jql, jnp.asarray(x, jnp.bfloat16)), np.float32))


@pytest.mark.parametrize("m,k,n", [(1, 64, 192), (5, 20, 12), (17, 64, 64),
                                   (40, 3072, 768)])
def test_int_mm_padded_exact(m, k, n):
    """The card's padding (m > 16; k, n multiples of 8), run on the CPU:
    exact against an int32 product, both operand layouts."""
    r = np.random.default_rng(m + k + n)
    a = torch.from_numpy(r.integers(-127, 128, (m, k)).astype(np.int8))
    b = torch.from_numpy(r.integers(-127, 128, (k, n)).astype(np.int8))
    want = a.int() @ b.int()
    assert torch.equal(nn.int_mm_padded(a, b), want)
    assert torch.equal(nn.int_mm_padded(a, b.t().contiguous().t()), want)
    assert torch.equal(nn.int_mm(a, b), want)


def test_int8_block_matches_jax_and_leaves_the_fused_kernel(weights,
                                                             monkeypatch):
    params, jpc, model, cfg = weights
    jblk = jnn.quantize_params(params)["backbone"]["blocks"][1]
    blk = nn.quantize_params(model).backbone.blocks[1]
    x = np.random.default_rng(5).normal(size=(2, 16, 64)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = jvit.block_forward(jblk, jnp.asarray(x), 2, 1e-6,
                                  attn_impl="xla", mlp_impl="fused")
    calls = []
    monkeypatch.setattr(vit, "fused_ln_mlp",
                        lambda *a, **kw: calls.append(1))
    got = vit.block_forward(blk, torch.from_numpy(x), 2, 1e-6)
    assert not calls
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    vit.block_forward(model.backbone.blocks[1], torch.from_numpy(x), 2, 1e-6)
    assert calls == [1]


def _sample(seed=7):
    r = np.random.default_rng(seed)
    image = (r.uniform(size=(60, 90, 3)) * 255).astype(np.uint8)
    gt = np.zeros((60, 90), np.float32)
    gt[14:50, 18:46] = 1.0
    return image, gt


@pytest.fixture(scope="module")
def int8_predictors(weights):
    params, jpc, model, cfg = weights
    pred = Predictor(model, cfg, device="cpu", int8=True)
    assert nn.is_quantized(pred.model) and not nn.is_quantized(model)
    return JPredictor(params, jpc, int8=True), pred


@pytest.mark.parametrize("seed", [3, 7, 11])
def test_int8_session_matches_jax(int8_predictors, seed):
    jpred, pred = int8_predictors
    image, gt = _sample(seed)
    with jax.default_matmul_precision("highest"):
        jpred.set_input(image, gt)
        jious = jpred.run_clicks(CLICKS)
    pred.set_input(image, gt)
    ious = pred.run_clicks(CLICKS)
    jclicks = np.asarray(jpred.clicks)
    first = jclicks[:, 2] == 0
    np.testing.assert_array_equal(pred.clicks[first], jclicks[first])
    np.testing.assert_allclose(ious, np.asarray(jious), atol=5e-3)
    if seed == 7:
        np.testing.assert_array_equal(pred.clicks, jclicks)


def test_int8_user_click_matches_jax(int8_predictors):
    """One user click of the int8 predictor, no gt: the same first
    forward as JAX's within the session noise above."""
    jpred, pred = int8_predictors
    image, _ = _sample()
    gt = np.zeros(image.shape[:2], np.float32)
    jpred.set_input(image, gt)
    pred.set_input(image, gt)
    with jax.default_matmul_precision("highest"):
        jpred.user_click(20.5, 33.7, True)
    assert pred.user_click(20.5, 33.7, True) == 0.0
    np.testing.assert_array_equal(pred.clicks, np.asarray(jpred.clicks))
    np.testing.assert_allclose(pred.probs, np.asarray(jpred.probs), atol=5e-3)


def test_int8_predictor_reuses_a_quantized_model(weights):
    _, _, model, cfg = weights
    q = nn.quantize_params(model, dtype=cfg.model.dtype)
    pred = Predictor(q, cfg, device="cpu", int8=True)
    assert pred.model is q


@pytest.mark.parametrize("build", [
    lambda q, cfg: Predictor(q, cfg, device="cpu"),
    lambda q, cfg: brs.FeatureBRSPredictor(q, cfg, device="cpu"),
    lambda q, cfg: brs.InputBRSPredictor(q, cfg, device="cpu")],
    ids=["NoBRS", "f-BRS", "RGB-BRS"])
def test_float_paths_refuse_a_quantized_model(weights, build):
    """Only the int8 flag makes a path run int8: a quantized module given
    to a float path (whose BRS gradients `round` would zero) is refused."""
    _, _, model, cfg = weights
    q = nn.quantize_params(model, dtype=cfg.model.dtype)
    with pytest.raises(ValueError, match="int8=True"):
        build(q, cfg)


def test_batched_int8_matches_jax_and_sequential(weights):
    params, jpc, model, cfg = weights
    jcurves, _, _ = JBatched(params, jpc, batch_size=2, int8=True).evaluate(
        JSynthetic(3, (64, 64)), max_clicks=3)
    curves, _, _ = BatchedEvaluator(model, cfg, batch_size=2, device="cpu",
                                    int8=True).evaluate(
        SyntheticDataset(3, (64, 64)), max_clicks=3)
    assert len(curves) == len(jcurves) == 3
    pred = Predictor(model, cfg, device="cpu", int8=True)
    ds = SyntheticDataset(3, (64, 64))
    for i, (c, jc) in enumerate(zip(curves, jcurves)):
        np.testing.assert_allclose(c, jc, atol=5e-3)     # the session noise
        s = ds.get_sample(i)
        pred.set_input(s.image, s.gt_mask(s.objects_ids[0]))
        seq = pred.run_clicks(3)[:len(c)]
        np.testing.assert_allclose(c, seq, atol=1e-6)
