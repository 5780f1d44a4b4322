"""The attention kernels' row statistics and strided interface, on the CPU.

The fused forward writes per-row statistics (m = max(s*scale), l = sum
exp(s*scale - m)), (BH, N, 2) in f32, and the backward reads them instead of
recomputing them; the kernels read q, k, v as strided (..., N, H, D) views.
Here the plain versions, which the CUDA kernels are held against on a card
(tests/test_torch_cuda.py), are held against the JAX package: the plain
forward's output and statistics, and the plain backward given those
statistics, against `jax.vjp` of `pvpuformer_tpu.ops.fused_attention
.fused_attention` (its Pallas kernels in interpret mode on the CPU, as
tests/test_torch_grad.py runs them); the statistics against a float64
numpy reference. The stride derivation is checked through
`torch.as_strided`, and the autograd function through a ViT block.

Tolerances: f32 atol 2e-5 / rtol 1e-4 (the JAX attention tests' own bound:
only the summation order differs); bf16 atol / rtol 1e-2 (one bf16 rounding
of P, ds or the output may fall either side); the statistics are f32 in
both dtypes, 1e-5 relative; the ViT block's gradients 1e-4 of each
gradient's largest entry (f32, several products and a LayerNorm in
another summation order)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvpuformer_tpu.models import vit as jvit
from pvpuformer_tpu.ops import fused_attention as jfa
from pvpuformer_tpu.utils.serialization import flatten_tree
from pvpuformer_tpu_torch.models import vit as tvit
from pvpuformer_tpu_torch.ops import fused_attention as tfa
from pvpuformer_tpu_torch.utils.serialization import params_from_numpy

NS = (1, 17, 100, 196)
DS = (16, 32, 64, 80, 128)
TOL = {"float32": dict(atol=2e-5, rtol=1e-4),
       "bfloat16": dict(atol=1e-2, rtol=1e-2)}


@functools.cache
def _jax_fwd_bwd(scale: float):
    def f(q, k, v, g):
        out, vjp = jax.vjp(lambda *a: jfa.fused_attention(*a, scale), q, k, v)
        return out, vjp(g)
    return jax.jit(f)


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("n", NS)
def test_plain_stats_and_bwd_from_stats_match_jax(n, d, dtype):
    r = np.random.default_rng(n * 1000 + d)
    shape = (1, n, 2, d)
    q, k, v, g = (r.normal(size=shape).astype(np.float32) for _ in range(4))
    scale = d ** -0.5
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    with jax.default_matmul_precision("highest"):
        want_o, want_g = _jax_fwd_bwd(scale)(
            *(jnp.asarray(x, jdt) for x in (q, k, v, g)))
    qt, kt, vt, gt = (torch.from_numpy(x).to(tdt) for x in (q, k, v, g))
    out, stats = tfa.fused_attention_plain(qt, kt, vt, scale,
                                           return_stats=True)
    assert out.dtype == tdt and stats.dtype == torch.float32
    assert stats.shape == (2, n, 2)
    np.testing.assert_allclose(_np(out), np.asarray(want_o, np.float32),
                               **TOL[dtype])
    # the statistics against float64 on the same (rounded) inputs
    qd, kd = (x.double().numpy().transpose(0, 2, 1, 3).reshape(2, n, d)
              for x in (qt, kt))
    s = qd @ kd.transpose(0, 2, 1) * scale
    m = s.max(-1)
    l = np.exp(s - m[..., None]).sum(-1)
    np.testing.assert_allclose(stats[..., 0].numpy(), m, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(stats[..., 1].numpy(), l, rtol=1e-5)
    grads = tfa.fused_attention_bwd_plain(qt, kt, vt, gt, scale, stats)
    for got, want in zip(grads, want_g):
        assert got.dtype == tdt and got.shape == shape
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                                   **TOL[dtype])
    # given the forward's own statistics, the backward is the one that
    # computes them itself, bit for bit
    for a, b in zip(grads, tfa.fused_attention_bwd_plain(qt, kt, vt, gt,
                                                        scale)):
        assert torch.equal(a, b)


def _qkv(lead, n, h, d, dtype=torch.float32):
    x = torch.randn(*lead, n, 3, h, d, generator=torch.Generator()
                    .manual_seed(0)).to(dtype)
    return [x[..., i, :, :] for i in range(3)]


def _as_bnhd(x, st):
    """x read through the kernels' addressing: (B, N, H, D) from its
    storage with the derived strides."""
    *lead, n, h, d = x.shape
    sb, sn, sh = st
    return torch.as_strided(x, (int(np.prod(lead)), n, h, d), (sb, sn, sh, 1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lead,n,h,d", [((2,), 196, 12, 64),
                                        ((2, 3), 17, 2, 16),
                                        ((4,), 1, 3, 80),
                                        ((1, 2), 49, 1, 128)])
def test_strides_address_qkv_views_in_place(lead, n, h, d, dtype):
    """The `qkv[:, :, i]` slices of models/vit.py, with one or several lead
    dimensions, are addressed in place; the kernels' strided read gives the
    same elements as the view itself."""
    for i, x in enumerate(_qkv(lead, n, h, d, dtype)):
        st = tfa.bnhd_strides(x)
        assert st is not None
        assert st == ((n * 3 * h * d if np.prod(lead) > 1 else 0),
                      (3 * h * d if n > 1 else 0), (d if h > 1 else 0))
        assert torch.equal(_as_bnhd(x, st), x.reshape(-1, n, h, d))
        ten, used = tfa._ten(x)
        assert used is x and ten.ptr == x.data_ptr()
        assert (ten.sb, ten.sn, ten.sh) == st


@pytest.mark.parametrize("case", ["lead_not_one_stride", "last_dim_strided",
                                  "unaligned_rows", "unaligned_base"])
def test_strides_refuse_what_the_kernels_cannot_address(case):
    """Tensors the kernels cannot read in place get None, and `_ten` hands
    the kernel a contiguous copy that it can."""
    g = torch.Generator().manual_seed(1)
    x = {
        "lead_not_one_stride":
            lambda: torch.randn(3, 2, 10, 2, 16, generator=g).transpose(0, 1),
        "last_dim_strided":
            lambda: torch.randn(2, 10, 2, 32, generator=g)[..., ::2],
        "unaligned_rows":                       # 18-element (72-byte) rows
            lambda: torch.randn(2, 10, 2, 18, generator=g)[..., :16],
        "unaligned_base":                       # base 4 bytes past 16
            lambda: torch.randn(2 * 10 * 2 * 16 + 1, generator=g)[1:]
            .view(2, 10, 2, 16),
    }[case]()
    assert tfa.bnhd_strides(x) is None
    ten, used = tfa._ten(x)
    assert used is not x and used.is_contiguous()
    assert torch.equal(used, x)
    st = tfa.bnhd_strides(used)
    assert st is not None and (ten.sb, ten.sn, ten.sh) == st
    assert torch.equal(_as_bnhd(used, st), x.reshape(-1, *x.shape[-3:]))


def test_fused_attention_autograd_saves_stats_and_matches_plain():
    """The autograd function's CPU forward saves the statistics, and its
    backward (the plain backward given them) equals the plain backward."""
    q, k, v = (t.clone().requires_grad_() for t in _qkv((2,), 30, 2, 16))
    out = tfa.fused_attention(q, k, v)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(3))
    auto = torch.autograd.grad(out, (q, k, v), g)
    want = tfa.fused_attention_bwd_plain(q.detach(), k.detach(), v.detach(),
                                         g, 16 ** -0.5)
    for a, b in zip(auto, want):
        assert torch.equal(a, b)


def test_vit_block_grads_through_fused_attention_match_jax():
    """_FusedAttention on the CPU inside a ViT block (qkv slices in, a
    reshape out) gives JAX's gradients of the same block with its fused
    attention, for every parameter and the input."""
    dim, heads, b, n = 64, 2, 2, 17
    jp = jvit.init_block(jax.random.key(0), dim, heads, 4.0, True)
    blk = tvit.Block(dim, heads, 4.0, True)
    blk.load_state_dict(params_from_numpy(flatten_tree(jp)))
    blk.requires_grad_(True)
    r = np.random.default_rng(8)
    x = r.normal(size=(b, n, dim)).astype(np.float32)
    w = r.normal(size=(b, n, dim)).astype(np.float32)

    def loss(p, x):
        y = jvit.block_forward(p, x, heads, 1e-6, attn_impl="fused")
        return jnp.sum(y * w)

    with jax.default_matmul_precision("highest"):
        jg_p, jg_x = jax.jit(jax.grad(loss, argnums=(0, 1)))(jp, x)
    xt = torch.from_numpy(x).requires_grad_()
    n0 = tfa.fused_attention.launches
    (tvit.block_forward(blk, xt, heads, 1e-6) * torch.from_numpy(w)).sum() \
        .backward()
    assert tfa.fused_attention.launches == n0       # the plain versions
    want = {k: np.asarray(a) for k, a in flatten_tree(jg_p).items()}
    got = {k: p.grad for k, p in blk.named_parameters()}
    want_t = params_from_numpy(want)
    assert set(want_t) == set(got)
    want_t["x"], got["x"] = torch.from_numpy(np.array(jg_x)), xt.grad
    for name, gw in want_t.items():
        gg = got[name]
        assert gg is not None, name
        scale = float(gw.abs().max())
        err = float((gg - gw).abs().max())
        assert err <= 1e-4 * scale, (name, err, scale)
