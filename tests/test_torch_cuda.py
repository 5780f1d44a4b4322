"""The port's CUDA kernels vs their plain PyTorch versions, on a card.

This file imports only torch and numpy (the machine with the card has no
JAX), and every test skips where no CUDA device is present. Run it on a GPU
without tests/conftest.py, which imports JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances: f32 attention 1e-4 (scalar FMAs vs cuBLAS f32, TF32 off); bf16
attention atol 5e-3 for the fused entry and 1.5e-2 for the flash entry,
about 2-3x the error measured on an H100 (the fused entry shares its plain
version's rounding points; the flash entry rounds P before normalizing, its
plain version after); min-plus bit-exact; LN+MLP bf16 atol 0.06 / rtol 0.05
as the JAX kernel's own test, at its operand scale (weights N(0, 0.05))."""
import types

import numpy as np
import pytest
import torch

from pvpuformer_tpu_torch.ops import attention, edt_minplus, fused_attention
from pvpuformer_tpu_torch.ops import fused_mlp


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _t(a, dt=torch.float32, dev="cpu"):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dev, dt)


def _cmp(got, want, atol, rtol):
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=atol, rtol=rtol)


ATTN_CASES = [(entry, shape) for entry in ("fused", "flash")
              for shape in ((8, 196, 12, 64), (2, 784, 12, 64), (1, 200, 3, 80))]
ATTN_CASES.append(("fused", (2, 2, 49, 2, 16)))   # 5-D lead (B, windows)


@pytest.mark.cuda
@pytest.mark.parametrize("entry,shape", ATTN_CASES)
def test_attention_kernel_matches_plain(cuda, entry, shape):
    mod, fn = ((fused_attention, "fused_attention") if entry == "fused"
               else (attention, "flash_attention"))
    kern, plain = getattr(mod, fn), getattr(mod, fn + "_plain")
    r = np.random.default_rng(4)
    bf16_atol = 5e-3 if entry == "fused" else 1.5e-2
    for dt, tol in ((torch.float32, (1e-4, 1e-4)),
                    (torch.bfloat16, (bf16_atol, 0.0))):
        q, k, v = (_t(r.normal(size=shape), dt, cuda) for _ in range(3))
        n0 = kern.launches
        got = kern(q, k, v)
        assert kern.launches == n0 + 1 and got.dtype == dt
        _cmp(got, plain(q, k, v, shape[-1] ** -0.5), *tol)


@pytest.mark.cuda
def test_attention_kernel_raises_outside_its_envelope(cuda):
    q = torch.zeros(1, 8, 2, 24, device=cuda)
    with pytest.raises(ValueError, match="head dim 24"):
        fused_attention.fused_attention(q, q, q)
    with pytest.raises(TypeError):
        fused_attention.fused_attention(*(q.half(),) * 3)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(896, 448), (37, 53), (3, 16, 200),
                                   (2, 8192)])
def test_minplus_kernel_bit_exact(cuda, shape):
    r = np.random.default_rng(2)
    f = _t(np.square(r.integers(0, 300, size=shape)), dev=cuda)
    n0 = edt_minplus.minplus_rows.launches
    got = edt_minplus.minplus_rows(f)
    assert edt_minplus.minplus_rows.launches == n0 + 1
    torch.cuda.synchronize()
    assert torch.equal(got, edt_minplus.minplus_rows_plain(f))


@pytest.mark.cuda
def test_minplus_kernel_raises_above_its_tile(cuda):
    with pytest.raises(ValueError, match="W=8193"):
        edt_minplus.minplus_rows(torch.zeros(2, 8193, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1568, 100])
def test_fused_ln_mlp_kernel_matches_plain(cuda, m):
    r = np.random.default_rng(0)
    d, hidden = 768, 3072
    bf = torch.bfloat16
    x = _t(r.normal(size=(m, d)), bf, cuda)
    ln = types.SimpleNamespace(scale=_t(r.normal(1, 0.1, d), dev=cuda),
                               bias=_t(r.normal(0, 0.1, d), dev=cuda))
    lin = lambda i, o: types.SimpleNamespace(           # noqa: E731
        w=_t(r.normal(0, 0.05, (i, o)), bf, cuda),
        b=_t(r.normal(0, 0.05, o), bf, cuda))
    mlp = types.SimpleNamespace(fc1=lin(d, hidden), fc2=lin(hidden, d))
    n0 = fused_mlp.fused_ln_mlp.launches
    got = fused_mlp.fused_ln_mlp(x, ln, mlp)
    assert fused_mlp.fused_ln_mlp.launches == n0 + 1
    want = fused_mlp.fused_ln_mlp_plain(x, ln.scale, ln.bias, mlp.fc1.w,
                                        mlp.fc1.b, mlp.fc2.w, mlp.fc2.b, 1e-6)
    _cmp(got, want, 0.06, 0.05)
    # f32 is a semantic route to the plain ops: no launch
    fused_mlp.fused_ln_mlp(x.float(), ln, mlp)
    assert fused_mlp.fused_ln_mlp.launches == n0 + 1
