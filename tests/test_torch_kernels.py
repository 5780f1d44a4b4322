"""The port's four kernels: their plain PyTorch versions vs the JAX/Pallas
functions (Pallas in interpret mode on the CPU), with the launch counters
untouched on the CPU. The CUDA kernels themselves are held against these
plain versions in tests/test_torch_cuda.py, which runs on a card.

Tolerances: f32 attention atol 2e-5 / rtol 1e-4 (the JAX attention tests'
own bound; only summation order differs); bf16 attention 1e-2 (one bf16
rounding of P and of O may fall either side); min-plus exact (integer-valued
f32); LN+MLP bf16 atol 0.06 / rtol 0.05 as tests/test_fused_mlp.py, and the
f32 route 1e-5: the same f32 ops, but XLA and torch's CPU BLAS sum the
1024-term dot products in different orders (measured max 2.9e-6 at |x| ~ 3),
so the 1e-6 of the XLA-vs-XLA test does not hold across the two libraries."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvpuformer_tpu.ops.attention import flash_attention as jax_flash
from pvpuformer_tpu.ops.edt_pallas import minplus_rows as jax_minplus
from pvpuformer_tpu.ops.fused_attention import fused_attention as jax_fused
from pvpuformer_tpu.ops.fused_mlp import fused_ln_mlp as jax_fused_mlp
from pvpuformer_tpu_torch.ops import attention, edt_minplus, fused_attention
from pvpuformer_tpu_torch.ops import fused_mlp

WRAPPERS = (fused_attention.fused_attention, attention.flash_attention,
            edt_minplus.minplus_rows, fused_mlp.fused_ln_mlp)


@pytest.fixture(autouse=True)
def no_launch_on_cpu():
    before = [w.launches for w in WRAPPERS]
    yield
    assert [w.launches for w in WRAPPERS] == before


def _qkv(shape, seed):
    r = np.random.default_rng(seed)
    return [r.normal(size=shape).astype(np.float32) for _ in range(3)]


def _j(a, dt=jnp.float32):
    return jnp.asarray(a, dt)


def _t(a, dt=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dt)


@pytest.mark.parametrize("shape", [(2, 52, 3, 16), (1, 196, 4, 64),
                                   (2, 2, 49, 2, 8)])
def test_fused_attention_plain_matches_jax_f32(shape):
    q, k, v = _qkv(shape, 3)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax_fused(_j(q), _j(k), _j(v)))
    got = fused_attention.fused_attention(_t(q), _t(k), _t(v)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)


def test_fused_attention_plain_matches_jax_bf16():
    q, k, v = _qkv((2, 52, 3, 16), 5)
    want = np.asarray(jax_fused(*(_j(a, jnp.bfloat16) for a in (q, k, v))),
                      np.float32)
    got = fused_attention.fused_attention(
        *(_t(a, torch.bfloat16) for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("shape", [(1, 196, 4, 64), (2, 128, 2, 32),
                                   (1, 200, 3, 64)])
def test_flash_attention_plain_matches_jax(shape):
    """N = 196 and 200 are not multiples of the 128 block: JAX pads and masks."""
    q, k, v = _qkv(shape, 1)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax_flash(_j(q), _j(k), _j(v)))
    got = attention.flash_attention(_t(q), _t(k), _t(v)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)


def test_flash_attention_plain_matches_jax_bf16():
    q, k, v = _qkv((1, 196, 4, 64), 2)
    want = np.asarray(jax_flash(*(_j(a, jnp.bfloat16) for a in (q, k, v))),
                      np.float32)
    got = attention.flash_attention(*(_t(a, torch.bfloat16) for a in (q, k, v)))
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-2, rtol=1e-2)


def test_attention_kernel_rejects_head_dims_it_cannot_tile():
    q = torch.zeros(1, 8, 2, 24)
    with pytest.raises(ValueError, match="head dim 24"):
        fused_attention.launch_attention(q, q, q, 0.2, flash=False)


@pytest.mark.parametrize("shape", [(37, 53), (64, 64), (16, 200)])
def test_minplus_plain_matches_pallas_exactly(shape):
    r = np.random.default_rng(11)
    f = np.square(r.integers(0, 60, size=shape)).astype(np.float32)
    f[r.uniform(size=shape) < 0.3] = 0.0
    want = np.asarray(jax_minplus(jnp.asarray(f), interpret=True))
    for chunk in (32, None):
        got = edt_minplus.minplus_rows(torch.from_numpy(f), chunk=chunk)
        np.testing.assert_array_equal(got.numpy(), want)


def _mlp_setup(d=256, hidden=1024, seed=0):
    r = np.random.default_rng(seed)
    x = r.normal(size=(2, 100, d)).astype(np.float32)
    ln = {"scale": r.normal(1, 0.1, d), "bias": r.normal(0, 0.1, d)}
    mlp = {"fc1": {"w": r.normal(0, 0.05, (d, hidden)),
                   "b": r.normal(0, 0.05, hidden)},
           "fc2": {"w": r.normal(0, 0.05, (hidden, d)),
                   "b": r.normal(0, 0.05, d)}}
    return x, ln, mlp


def _ns(tree, conv):
    if isinstance(tree, dict):
        return types.SimpleNamespace(**{k: _ns(v, conv) for k, v in tree.items()})
    return conv(tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_ln_mlp_plain_matches_jax(dtype):
    x, ln, mlp = _mlp_setup()
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jln = jax.tree.map(lambda a: _j(a), ln)
    jmlp = jax.tree.map(lambda a: _j(a, jdt), mlp)
    want = np.asarray(jax_fused_mlp(_j(x, jdt), jln, jmlp), np.float32)
    got = fused_mlp.fused_ln_mlp(_t(x, tdt), _ns(ln, _t),
                                 _ns(mlp, lambda a: _t(a, tdt)))
    assert got.dtype == tdt and got.shape == x.shape
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == "float32" else \
        dict(atol=0.06, rtol=0.05)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)
