"""The explicit bf16 backward of the LN+MLP half (`fused_ln_mlp_bwd`) on
the CPU, at small widths (D = 64, hidden = 256; 2 x 48 rows and a ragged 37).

The JAX backward is `jax.vjp` of `_xla_ref` (pvpuformer_tpu/ops/fused_mlp.py
`_fused_bwd`); its forward runs the Pallas kernel in interpret mode, as the
JAX package's own tests run it on the CPU. Inputs are made with numpy from a
seed; x and the cotangent are bf16, the parameters f32 (the training path's
types: f32 weights, bf16 activations).

Tolerances, per gradient, in bf16 ulps of the gradient's largest entry
(`_ulp_of_max`); an ulp of each element is no measure where a sum cancels
(dw1's small entries, and dx = g + dx_ln):
- against autograd through `fused_ln_mlp_plain` on the same inputs: 1 ulp.
  Both round at the same points and, on the CPU, take the same f32
  products of bf16 values; they differ only by the hi + lo split of dh_pre
  (2**-18 relative) and the arrangement of the LayerNorm backward's f32
  sums, which flips a bf16 rounding of dy or dw1 now and then (the share of
  elements that differ is printed, 0.2-0.3 % of dw1 when measured);
- against JAX's vjp: 2 ulps. The same rounding points, the products summed
  in XLA's order;
- the hi + lo product against the product of the f32 operand, computed in
  f64: 2**-16 of the product's largest entry (the split leaves 2**-18 of
  each term, plus f32 sums).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvpuformer_tpu.ops import fused_mlp as jfm
from pvpuformer_tpu_torch.ops import fused_mlp as tfm

D, HIDDEN = 64, 256
NAMES = ("dx", "dscale", "dbias", "dw1", "db1", "dw2", "db2")


def _inputs(rows: int, seed: int):
    """x, the six LN / MLP parameters and the cotangent, as f32 numpy; the
    weights at the JAX kernel test's scale N(0, 0.05)."""
    r = np.random.default_rng(seed)
    arrs = (r.normal(size=(rows, D)), r.normal(1, 0.1, D), r.normal(0, 0.1, D),
            r.normal(0, 0.05, (D, HIDDEN)), r.normal(0, 0.05, HIDDEN),
            r.normal(0, 0.05, (HIDDEN, D)), r.normal(0, 0.05, D),
            r.normal(size=(rows, D)))
    return [np.asarray(a, np.float32) for a in arrs]


def _torch(arrs):
    x, *params, g = (torch.from_numpy(a) for a in arrs)
    return x.bfloat16(), params, g.bfloat16()


def _ulp_of_max(t: torch.Tensor) -> float:
    """One bf16 ulp at the largest magnitude of t."""
    m = float(t.float().abs().max())
    return 2.0 ** (np.floor(np.log2(m)) - 7) if m > 0 else 0.0


@jax.jit
def _jax_vjp(x, params, g):
    def f(x, scale, bias, w1, b1, w2, b2):
        return jfm.fused_ln_mlp(x, {"scale": scale, "bias": bias},
                                {"fc1": {"w": w1, "b": b1},
                                 "fc2": {"w": w2, "b": b2}})
    return jax.vjp(f, x, *params)[1](g)


@pytest.mark.parametrize("rows", [96, 37], ids=["2x48", "ragged37"])
def test_bf16_bwd_matches_jax(rows):
    arrs = _inputs(rows, seed=11)
    x, params, g = _torch(arrs)
    got = tfm.fused_ln_mlp_bwd(x, *params, 1e-6, g)
    want = _jax_vjp(jnp.asarray(arrs[0], jnp.bfloat16),
                    tuple(jnp.asarray(a) for a in arrs[1:7]),
                    jnp.asarray(arrs[7], jnp.bfloat16))
    for name, a, w, src in zip(NAMES, got, want, [x, *params]):
        assert a.dtype == src.dtype and a.shape == src.shape, name
        w = torch.from_numpy(np.array(w, np.float32))
        err = float((a.float() - w).abs().max())
        assert err <= 2 * _ulp_of_max(w), (name, err, _ulp_of_max(w))


@pytest.mark.parametrize("rows", [96, 37], ids=["2x48", "ragged37"])
def test_bf16_bwd_matches_autograd_through_plain(rows):
    x, params, g = _torch(_inputs(rows, seed=12))
    got = tfm.fused_ln_mlp_bwd(x, *params, 1e-6, g)
    leaves = [t.clone().requires_grad_() for t in (x, *params)]
    want = torch.autograd.grad(tfm.fused_ln_mlp_plain(*leaves, 1e-6), leaves,
                               g)
    shares = {}
    for name, a, w in zip(NAMES, got, want):
        assert a.dtype == w.dtype, name
        err = float((a.float() - w.float()).abs().max())
        assert err <= _ulp_of_max(w), (name, err, _ulp_of_max(w))
        shares[name] = float((a != w).float().mean())
    print(f"share of elements that differ: {shares}")


def test_bf16_bwd_is_the_autograd_backward_and_skips_the_plain_version(
        monkeypatch):
    """`fused_ln_mlp`'s bf16 backward returns fused_ln_mlp_bwd's gradients
    and never recomputes through fused_ln_mlp_plain."""
    x, params, g = _torch(_inputs(48, seed=13))
    xt = x.clone().requires_grad_()
    pt = [p.clone().requires_grad_() for p in params]
    ln = type("LN", (), {"scale": pt[0], "bias": pt[1]})
    lin = lambda w, b: type("Lin", (), {"w": w, "b": b})  # noqa: E731
    mlp = type("MLP", (), {"fc1": lin(pt[2], pt[3]), "fc2": lin(pt[4], pt[5])})
    out = tfm.fused_ln_mlp(xt.reshape(2, 24, D), ln, mlp)

    def refuse(*a, **k):
        raise AssertionError("the bf16 backward called fused_ln_mlp_plain")

    monkeypatch.setattr(tfm, "fused_ln_mlp_plain", refuse)
    got = torch.autograd.grad(out, [xt, *pt], g.reshape(2, 24, D))
    want = tfm.fused_ln_mlp_bwd(x, *params, 1e-6, g)
    for name, a, w in zip(NAMES, got, want):
        assert torch.equal(a, w), name


@pytest.mark.parametrize("f32_side", ["left", "right"])
def test_split_product_matches_f32_product(f32_side):
    """dy = dh_pre . W1^T (f32 on the left) and dW1 = y^T . dh_pre (f32 on
    the right), as fused_ln_mlp_bwd computes them from hi + lo."""
    r = np.random.default_rng(14)
    a32 = torch.from_numpy(r.normal(size=(96, HIDDEN)).astype(np.float32))
    if f32_side == "left":                # dh_pre (96, HIDDEN) . W1^T
        w1 = torch.from_numpy(r.normal(size=(D, HIDDEN)).astype(np.float32))
        w1 = w1.bfloat16()
        want = a32.double() @ w1.double().t()
        hi, lo = tfm.split_bf16(a32.clone())
        got = tfm.mm_f32(hi, w1.t()) + tfm.mm_f32(lo, w1.t())
    else:                                 # y^T (D, 96) . dh_pre
        y = torch.from_numpy(r.normal(size=(96, D)).astype(np.float32))
        y = y.bfloat16()
        want = y.double().t() @ a32.double()
        hi, lo = tfm.split_bf16(a32.clone())
        got = tfm.mm_f32(y.t(), hi) + tfm.mm_f32(y.t(), lo)
    assert got.dtype == torch.float32
    rel = float((got.double() - want).abs().max() / want.abs().max())
    assert rel <= 2.0 ** -16, rel
