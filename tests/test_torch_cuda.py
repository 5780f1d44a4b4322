"""The port's CUDA kernels vs their plain PyTorch versions, on a card.

This file imports only torch and numpy (the machine with the card has no
JAX), and every test skips where no CUDA device is present. Run it on a GPU
without tests/conftest.py, which imports JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Torch's precision flags are left as they come (the package pins its own).
Tolerances: f32 attention 1e-4 (scalar FMAs vs cuBLAS f32, not TF32); bf16
attention atol 5e-3 for the fused entry and 1.5e-2 for the flash entry,
about 2-3x the error measured on an H100 (the fused entry shares its plain
version's rounding points; the flash entry rounds P before normalizing, its
plain version after); min-plus bit-exact and bit-identical on repeat,
also on the CPU model's adversarial rows, and trapping outside its domain;
LN+MLP bf16 atol 0.06 / rtol 0.05
as the JAX kernel's own test, at its operand scale (weights N(0, 0.05)), at
the ViT-B/L/H widths and 1 to 25088 rows, and bit-identical on repeat; its
bf16 backward within one bf16 ulp of each gradient's largest entry of
autograd through the plain version (as the CPU test); its tensor-parallel
fc2 launch (b') in f32 within 1e-3 + 1e-4 |x| of its plain version and,
with the bias and residual added, bit-identical to launch (b); the two CC kernels bit-exact (integer max); tiny f32 prompt sessions on the
card vs the same sessions on the CPU: identical clicks, IoU within 1e-5.
The attention backward: f32 1e-4, bf16 atol 1e-2 (~2.5x the error measured
on an H100 at the training shapes, 3.9e-3), and bit-identical on repeat (no
atomics); the fused forward's row statistics 1e-4 (f32 both, scores summed
in another order); both forward entries fed straight from `qkv` views at
the limits above; a bf16 ViT block's parameter
gradients on the card vs the CPU within 2e-2 of each gradient's largest
entry (~5x the measured 4e-3); a tiny f32 train step on the card vs the CPU
as chip_smoke.py phase 8 (loss 1e-4, gradients 1e-4 x max(max |g|, 1),
parameters 1e-6 after SGD). The serving slice: the int8 product exact at
padded and unpadded shapes; the int8 linear bit-identical to the CPU's;
tiny f32 user-click rounds within 1e-5 of the CPU's (int8: 5e-3, the int8
session noise of tests/test_torch_quant.py), captured into a CUDA graph;
RGB-BRS / DistMap-BRS objectives' gradients within 1e-4 of their largest
entry; chip_smoke.py phase 14's sessions at its tolerances. The model
families: a bf16 PlainVit click round launches the fused attention and
LN+MLP kernels once per block and the min-plus kernel once, and no SDPA;
each zoo family's f32 forward within 1e-4 of the CPU's, relative to the
largest logit."""
import dataclasses
import types

import numpy as np
import pytest
import torch

from pvpuformer_tpu_torch.ops import attention, cc, edt_minplus, fused_attention
from pvpuformer_tpu_torch.ops import fused_mlp


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
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


QKV_CASES = [(entry, n, d) for entry in ("fused", "flash")
             for n in (1, 17, 100, 196, 784) for d in (16, 32, 64, 80, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("entry,n,d", QKV_CASES)
def test_attention_kernel_reads_qkv_views(cuda, entry, n, d):
    """Both entries take q, k, v straight from the `qkv[:, :, i]` slices of
    models/vit.py (addressed in place, no copy) and return a contiguous
    (B, N, H, D) tensor, so the block's reshape is a view."""
    mod, fn = ((fused_attention, "fused_attention") if entry == "fused"
               else (attention, "flash_attention"))
    kern, plain = getattr(mod, fn), getattr(mod, fn + "_plain")
    r = np.random.default_rng(n + d)
    bf16_atol = 5e-3 if entry == "fused" else 1.5e-2
    for dt, tol in ((torch.float32, (1e-4, 1e-4)),
                    (torch.bfloat16, (bf16_atol, 0.0))):
        qkv = _t(r.normal(size=(2, n, 3, 2, d)), dt, cuda)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        assert all(fused_attention.bnhd_strides(x) is not None
                   for x in (q, k, v))
        got = kern(q, k, v)
        assert got.is_contiguous() and got.shape == q.shape
        assert got.reshape(2, n, 2 * d).data_ptr() == got.data_ptr()
        _cmp(got, plain(q, k, v, d ** -0.5), *tol)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dt", [((2, 784, 2, 64), torch.bfloat16),
                                      ((3, 100, 2, 80), torch.bfloat16),
                                      ((2, 17, 3, 32), torch.float32)])
def test_attention_stats_match_plain(cuda, shape, dt):
    """The fused forward's (m, l) against the plain forward's, f32 both:
    1e-4 relative (scores summed in another order; ex2.approx on bf16)."""
    r = np.random.default_rng(9)
    q, k, v = (_t(r.normal(size=shape), dt, cuda) for _ in range(3))
    sc = shape[-1] ** -0.5
    out, st = fused_attention.launch_attention_stats(q, k, v, sc)
    want_o, want_st = fused_attention.fused_attention_plain(
        q, k, v, sc, return_stats=True)
    assert st.shape == want_st.shape and st.dtype == torch.float32
    _cmp(st, want_st, 1e-4, 1e-4)
    _cmp(out, want_o, *((5e-3, 0.0) if dt == torch.bfloat16
                        else (1e-4, 1e-4)))


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
@pytest.mark.parametrize("shape", [(896, 448), (28672, 448), (2, 8192),
                                   (74, 53), (64, 1000), (5, 33), (3, 1),
                                   (129, 448), (4099, 31)])
def test_minplus_kernel_bit_exact_on_adversarial_rows(cuda, shape):
    """The CPU model's inputs (tests/test_torch_minplus_envelope.py: pass-1
    rows of blobs, a spiral, full and empty masks, one zero, ties, collinear
    sites, a ramp, values at 2^24 - 1) at the click, training and widest
    shapes and ragged row counts: bit-exact, bit-identical on repeat, one
    launch per call."""
    from test_torch_minplus_envelope import adversarial
    f = _t(adversarial(*shape), dev=cuda)
    n0 = edt_minplus.minplus_rows.launches
    got = edt_minplus.minplus_rows(f)
    again = edt_minplus.minplus_rows(f)
    assert edt_minplus.minplus_rows.launches == n0 + 2
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert torch.equal(got, edt_minplus.minplus_rows_plain(f))


MINPLUS_TRAP = """
import sys
import torch
sys.path.insert(0, '.')
from pvpuformer_tpu_torch.ops import edt_minplus
f = torch.zeros(3, 448, device="cuda")
print(float(edt_minplus.minplus_rows(f).sum()), flush=True)
f[1, 200] = {bad}
edt_minplus.minplus_rows(f)
torch.cuda.synchronize()
print("no trap", flush=True)
"""


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["-1.0", "0.5", "2.0 ** 24", "float('nan')"])
def test_minplus_kernel_traps_outside_its_domain(cuda, bad):
    """A value outside integer-valued [0, 2^24) traps the launch (the CUDA
    context is lost, so each case runs in a fresh process)."""
    import subprocess
    import sys
    from pathlib import Path
    run = subprocess.run([sys.executable, "-c", MINPLUS_TRAP.format(bad=bad)],
                         cwd=Path(__file__).resolve().parents[1],
                         capture_output=True, text=True, timeout=300)
    assert run.stdout.startswith("0.0\n"), run.stdout + run.stderr[-2000:]
    assert "no trap" not in run.stdout
    assert run.returncode != 0
    assert "CUDA error" in run.stderr or "cudaError" in run.stderr, \
        run.stderr[-2000:]


def _ln_mlp(r, d, hidden, dev, dt=torch.bfloat16):
    """LN and MLP parameters at the JAX kernel test's scale: LN scale / bias
    f32, weights and biases N(0, 0.05) in `dt`."""
    ln = types.SimpleNamespace(scale=_t(r.normal(1, 0.1, d), dev=dev),
                               bias=_t(r.normal(0, 0.1, d), dev=dev))
    lin = lambda i, o: types.SimpleNamespace(           # noqa: E731
        w=_t(r.normal(0, 0.05, (i, o)), dt, dev),
        b=_t(r.normal(0, 0.05, o), dt, dev))
    return ln, types.SimpleNamespace(fc1=lin(d, hidden), fc2=lin(hidden, d))


@pytest.mark.cuda
@pytest.mark.parametrize("d,hidden", [(768, 3072), (1024, 4096), (1280, 5120)],
                         ids=["vit_b", "vit_l", "vit_h"])
@pytest.mark.parametrize("m", [1, 100, 1568, 25088])
def test_fused_ln_mlp_kernel_matches_plain(cuda, m, d, hidden):
    r = np.random.default_rng(0)
    x = _t(r.normal(size=(m, d)), torch.bfloat16, cuda)
    ln, mlp = _ln_mlp(r, d, hidden, cuda)
    n0 = fused_mlp.fused_ln_mlp.launches
    got = fused_mlp.fused_ln_mlp(x, ln, mlp)
    assert fused_mlp.fused_ln_mlp.launches == n0 + 1
    want = fused_mlp.fused_ln_mlp_plain(x, ln.scale, ln.bias, mlp.fc1.w,
                                        mlp.fc1.b, mlp.fc2.w, mlp.fc2.b, 1e-6)
    _cmp(got, want, 0.06, 0.05)
    # no atomics, no split-K: the same bits on every call
    assert torch.equal(got, fused_mlp.fused_ln_mlp(x, ln, mlp))
    # f32 is a semantic route to the plain ops: no launch
    fused_mlp.fused_ln_mlp(x.float(), ln, mlp)
    assert fused_mlp.fused_ln_mlp.launches == n0 + 2


@pytest.mark.cuda
@pytest.mark.parametrize("d,hidden", [(768, 1536), (768, 768), (1024, 2048),
                                      (1280, 2560)],
                         ids=["vit_b_m2", "vit_b_m4", "vit_l_m2", "vit_h_m2"])
@pytest.mark.parametrize("m", [1, 100, 6272, 25088])
def test_fc2_partial_kernel_matches_plain(cuda, m, d, hidden):
    """Launch (b'), the tensor-parallel fc2 at the local hidden widths of
    M = 2 and 4: f32 within 1e-3 + 1e-4 |x| of `fc2_partial_plain` (the
    same products, summed in another order), bit-identical on repeat, and
    its sum + bias + residual rounded once bit-identical to launch (b) on
    the same h (the same tiles and sums)."""
    r = np.random.default_rng(1)
    x = _t(r.normal(size=(m, d)), torch.bfloat16, cuda)
    ln, mlp = _ln_mlp(r, d, hidden, cuda)
    h = fused_mlp._launch_fc1(x, ln.scale, ln.bias, mlp.fc1.w, mlp.fc1.b,
                              1e-6)
    got = fused_mlp.launch_fc2_partial(h, mlp.fc2.w)
    assert got.dtype == torch.float32 and got.shape == (m, d)
    _cmp(got, fused_mlp.fc2_partial_plain(h, mlp.fc2.w), 1e-3, 1e-4)
    assert torch.equal(got, fused_mlp.launch_fc2_partial(h, mlp.fc2.w))
    whole = fused_mlp._launch(x, ln.scale, ln.bias, mlp.fc1.w, mlp.fc1.b,
                              mlp.fc2.w, mlp.fc2.b, 1e-6)
    assert torch.equal((got + mlp.fc2.b.float() + x.float()).to(x.dtype),
                       whole)


@pytest.mark.cuda
def test_fused_ln_mlp_tp_on_one_rank_is_the_unsplit_block(cuda):
    """On a process group of one rank (nothing split, the all-reduces the
    identity) the tensor-parallel LN+MLP is the unsplit one: its forward
    ((a), (b'), the epilogue) and its backward bit for bit."""
    import torch.distributed as tdist
    r = np.random.default_rng(2)
    x = _t(r.normal(size=(1568, 768)), torch.bfloat16, cuda)
    ln, mlp = _ln_mlp(r, 768, 3072, cuda, dt=torch.float32)
    gy = _t(r.normal(size=(1568, 768)), torch.bfloat16, cuda)
    tdist.init_process_group("gloo", store=tdist.HashStore(), rank=0,
                             world_size=1)
    try:
        outs = []
        for tp in (False, True):
            xi = x.clone().requires_grad_()
            leaves = [ln.scale, ln.bias, mlp.fc1.w, mlp.fc1.b, mlp.fc2.w,
                      mlp.fc2.b]
            for t in leaves:
                t.requires_grad_().grad = None
            n0 = (fused_mlp.fused_ln_mlp.launches,
                  fused_mlp.fused_ln_mlp_tp.launches)
            y = (fused_mlp.fused_ln_mlp_tp(xi, ln, mlp, None) if tp
                 else fused_mlp.fused_ln_mlp(xi, ln, mlp))
            assert (fused_mlp.fused_ln_mlp.launches - n0[0],
                    fused_mlp.fused_ln_mlp_tp.launches - n0[1]) == \
                ((0, 1) if tp else (1, 0))
            y.backward(gy)
            outs.append([y.detach(), xi.grad] + [t.grad for t in leaves])
        for a, b in zip(*outs):
            assert torch.equal(a, b)
    finally:
        tdist.destroy_process_group()


@pytest.mark.cuda
def test_fused_ln_mlp_kernel_raises_outside_its_envelope(cuda):
    r = np.random.default_rng(0)
    ln, mlp = _ln_mlp(r, 1344, 5376, cuda)
    x = torch.zeros(8, 1344, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="D=1344"):
        fused_mlp.fused_ln_mlp(x, ln, mlp)
    ln, mlp = _ln_mlp(r, 768, 3072, cuda)
    mlp.fc1.b = mlp.fc1.b[:-128]             # the kernel would read past it
    with pytest.raises(ValueError, match="vectors"):
        fused_mlp.fused_ln_mlp(x[:, :768].contiguous(), ln, mlp)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1568, 25088])
def test_fused_ln_mlp_bf16_backward_matches_plain(cuda, m):
    """The bf16 backward on the card (cuBLAS bf16 products with f32 results)
    against autograd through the plain version (f32 products), both from
    bf16 x and f32 parameters, as the training path has them: each gradient
    within one bf16 ulp of its largest entry, as tests/test_torch_mlp_bwd.py
    holds it on the CPU; one backward counted."""
    r = np.random.default_rng(1)
    d, hidden = 768, 3072
    ln, mlp = _ln_mlp(r, d, hidden, cuda, torch.float32)
    params = [ln.scale, ln.bias, mlp.fc1.w, mlp.fc1.b, mlp.fc2.w, mlp.fc2.b]
    x = _t(r.normal(size=(m, d)), torch.bfloat16, cuda)
    g = _t(r.normal(size=(m, d)), torch.bfloat16, cuda)
    got_leaves = [t.clone().requires_grad_() for t in (x, *params)]
    lns = types.SimpleNamespace(scale=got_leaves[1], bias=got_leaves[2])
    lin = lambda w, b: types.SimpleNamespace(w=w, b=b)  # noqa: E731
    mlps = types.SimpleNamespace(fc1=lin(*got_leaves[3:5]),
                                 fc2=lin(*got_leaves[5:7]))
    out = fused_mlp.fused_ln_mlp(got_leaves[0], lns, mlps)
    n0 = fused_mlp.fused_ln_mlp.bwd_launches
    got = torch.autograd.grad(out, got_leaves, g)
    assert fused_mlp.fused_ln_mlp.bwd_launches == n0 + 1
    leaves = [t.clone().requires_grad_() for t in (x, *params)]
    want = torch.autograd.grad(fused_mlp.fused_ln_mlp_plain(*leaves, 1e-6),
                               leaves, g)
    torch.cuda.synchronize()
    for i, (a, w) in enumerate(zip(got, want)):
        assert a.dtype == w.dtype
        mx = float(w.float().abs().max())
        ulp = 2.0 ** (np.floor(np.log2(mx)) - 7)
        assert float((a.float() - w.float()).abs().max()) <= ulp, i


def _blobs(seed, b, h, w, n=8):
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    m = np.zeros((b, h, w), bool)
    for i in range(b):
        for _ in range(n):
            cy, cx = r.integers(0, h), r.integers(0, w)
            m[i] |= (yy - cy) ** 2 + (xx - cx) ** 2 <= r.integers(2, 40) ** 2
    return m


def _snake(h=40, w=40):
    """One component with 10 direction reversals: > 8 flood rounds."""
    m = np.zeros((1, h, w), bool)
    for i in range(0, h, 4):
        m[0, i, 1:w - 1] = True
        m[0, i:i + 4, w - 2 if (i // 4) % 2 == 0 else 1] = True
    return m


def _speckles():
    m = np.zeros((1, 64, 96), bool)
    m[0, 8::2, 1::2] = True                    # 28 x 48 = 1344 components
    return m


def _mask(name):
    """(B, H, W) masks by name, made when a test asks (some are large); the
    new cases share chip_smoke.py's generators (CC_MASKS): a 448 x 448
    spiral (more than 16 rounds, runs across every segment and pass
    boundary), full and 50176-component masks, 1 x W and H x 1 lines, and a
    4096 x 4096 image."""
    import chip_smoke
    own = {"path": lambda: _blobs(0, 2, 448, 448), "snake": _snake,
           "speckles": _speckles, "ragged": lambda: _blobs(1, 3, 74, 53, 4),
           "empty": lambda: np.zeros((2, 30, 40), bool)}
    return (own.get(name) or chip_smoke.CC_MASKS[name])()


CC_CASES = ("path", "snake", "speckles", "ragged", "empty", "spiral", "full",
            "dots", "row", "column", "long row", "long column", "large")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CC_CASES))
def test_cc_kernels_bit_exact(cuda, case):
    """Both kernels bit-exact against their plain versions and bit-identical
    on repeat at iters 1, 2, 8 and 16; one launch counted per call."""
    m = torch.from_numpy(_mask(case)).to(cuda)
    v = torch.randint(0, 10 ** 6, m.shape, dtype=torch.int32,
                      generator=torch.Generator().manual_seed(1)).to(cuda)
    n0, n1 = cc.cc_labels.launches, cc.component_max.launches
    for iters in (1, 2, 8, 16):
        got = cc.cc_labels(m, iters)
        got_v = cc.component_max(m, v, iters)
        torch.cuda.synchronize()
        assert torch.equal(got, cc.cc_labels_plain(m, iters)), iters
        assert torch.equal(got_v, cc.component_max_plain(m, v, iters)), iters
        assert torch.equal(got, cc.cc_labels(m, iters))
        assert torch.equal(got_v, cc.component_max(m, v, iters))
    assert (cc.cc_labels.launches,
            cc.component_max.launches) == (n0 + 8, n1 + 8)


@pytest.mark.cuda
def test_cc_kernels_on_concurrent_streams(cuda):
    """Calls on four streams, queued with no sync between them so their
    grids can run at the same time: each stream has its own barrier word,
    and every result is bit-exact."""
    masks = [torch.from_numpy(_blobs(s, 2, 448, 448)).to(cuda)
             for s in range(4)]
    v = torch.randint(0, 10 ** 6, masks[0].shape, dtype=torch.int32,
                      generator=torch.Generator().manual_seed(2)).to(cuda)
    streams = [torch.cuda.Stream(cuda) for _ in masks]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream(cuda))
    got, slots = [], set()
    for _ in range(3):
        for m, s in zip(masks, streams):
            with torch.cuda.stream(s):
                got.append((m, cc.cc_labels(m, 16), cc.component_max(m, v)))
                slots.add(cc._slot(m, cc._build.library()))
    torch.cuda.synchronize()
    assert len(slots) == len(streams)
    for m, labels, vmax in got:
        assert torch.equal(labels, cc.cc_labels_plain(m, 16))
        assert torch.equal(vmax, cc.component_max_plain(m, v))


@pytest.mark.cuda
def test_cc_kernels_raise_outside_their_envelope(cuda):
    with pytest.raises(ValueError, match="8192"):
        cc.cc_labels(torch.zeros(1, 2, 8193, dtype=torch.bool, device=cuda))
    with pytest.raises(TypeError, match="int32"):
        m = torch.ones(1, 4, 4, dtype=torch.bool, device=cuda)
        cc.component_max(m, m.long())


def _tiny_config():
    from pvpuformer_tpu_torch.models.fpn import NeckConfig
    from pvpuformer_tpu_torch.models.seg_head import HeadConfig
    from pvpuformer_tpu_torch.models.two_way import TwoWayConfig
    from pvpuformer_tpu_torch.models.vit import ViTConfig
    from pvpuformer_tpu_torch.models.vpu import VPUConfig
    return VPUConfig(
        backbone=ViTConfig(img_size=(64, 64), patch_size=(16, 16),
                           embed_dim=64, depth=4, num_heads=2,
                           window_pixels=32),
        neck=NeckConfig(in_dim=64, out_dims=(16, 32, 48, 64), img_size=(64, 64),
                        hide_dim=64, two_way=TwoWayConfig(
                            depth=3, embedding_dim=64, num_heads=4, mlp_dim=64)),
        head=HeadConfig(in_channels=(16, 32, 48, 64), channels=32, d_model=64),
        num_max_points=6)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,multi", [(1, True), (1, False), (2, True),
                                        (2, False)])
def test_prompt_session_cuda_matches_cpu(cuda, mode, multi):
    from pvpuformer_tpu_torch.inference.predictor import (Predictor,
                                                         PredictorConfig)
    from pvpuformer_tpu_torch.models.vpu import init_vpu
    cfg = PredictorConfig(model=_tiny_config(), target_size=(64, 64),
                          min_crop_size=32, prompt_mode=mode,
                          as_multi_prompts=multi, deterministic_prompts=True)
    r = np.random.default_rng(7)
    image = (r.uniform(size=(60, 90, 3)) * 255).astype(np.uint8)
    gt = np.zeros((60, 90), np.float32)
    gt[14:50, 18:46] = 1.0
    out = []
    for where in ("cpu", cuda):
        model = init_vpu(cfg.model, torch.Generator().manual_seed(1), "cpu")
        pred = Predictor(model, cfg, device=where)
        pred.set_input(image, gt)
        out.append((pred.run_clicks(4), pred.clicks))
    np.testing.assert_array_equal(out[0][1], out[1][1])
    np.testing.assert_allclose(out[0][0], out[1][0], atol=1e-5)
    # random prompts draw the same noise on both devices
    rnd = dataclasses.replace(cfg, deterministic_prompts=False)
    clicks = []
    for where in ("cpu", cuda):
        model = init_vpu(cfg.model, torch.Generator().manual_seed(1), "cpu")
        pred = Predictor(model, rnd, device=where)
        pred.set_input(image, gt)
        pred.run_clicks(3)
        clicks.append(pred.clicks)
    np.testing.assert_array_equal(clicks[0], clicks[1])


def default_flags_check():
    """Run in a fresh process by the test below, with torch's precision
    flags left as they come: a tiny-config f32 forward on the card against
    the CPU (logits within 1e-4, absolute and relative: the port's f32
    tolerance against JAX), then chip_smoke.py phase 4's 5-click f32
    session (identical clicks, IoU within 1e-5)."""
    import chip_smoke
    from pvpuformer_tpu_torch.models.vpu import init_vpu
    dev = torch.device("cuda")
    flags = {"cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
             "matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    cfg = chip_smoke.tiny_config()
    r = np.random.default_rng(3)
    img = torch.from_numpy(r.uniform(size=(2, 64, 64, 4)).astype(np.float32))
    pts = torch.full((2, 12, 3), -1.0)
    pts[0, 0] = torch.tensor([20.0, 30.0, 0.0])
    pts[1, 6] = torch.tensor([50.0, 50.0, 1.0])
    out = {}
    for where in ("cpu", dev):
        model = init_vpu(cfg, torch.Generator().manual_seed(1), "cpu")
        model.to(where)
        out[str(where)] = model(img.to(where), pts.to(where))[
            "instances"].cpu()
    err = float((out["cpu"] - out[str(dev)]).abs().max())
    print(f"flags {flags}: f32 forward cuda vs cpu max |d logits| {err:.2e}")
    np.testing.assert_allclose(out[str(dev)].numpy(), out["cpu"].numpy(),
                               atol=1e-4, rtol=1e-4)
    chip_smoke.phase_parity(dev)


@pytest.mark.cuda
def test_f32_forward_and_session_match_cpu_under_torch_default_flags(cuda):
    """Regression: torch's default cudnn.allow_tf32 (True) ran the neck's f32
    conv in TF32 on the card; the package now keeps its f32 products in f32
    whatever the process's flags. The check runs in a fresh process, since
    this file's fixture and other tests may have set flags here."""
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    code = ("import sys; sys.path[:0] = ['tests', '.']; "
            "import test_torch_cuda as t; t.default_flags_check()")
    run = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-4000:]


BWD_CASES = [((128, 196, 12, 64), torch.bfloat16), ((32, 784, 12, 64),
             torch.bfloat16), ((2, 100, 3, 32), torch.float32),
             ((1, 70, 1, 128), torch.float32), ((2, 2, 49, 2, 16),
                                                 torch.bfloat16),
             ((4, 256, 4, 80), torch.bfloat16), ((1, 70, 2, 80), torch.float32)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dt", BWD_CASES)
def test_attention_bwd_kernel_matches_plain(cuda, shape, dt):
    r = np.random.default_rng(6)
    q, k, v, g = (_t(r.normal(size=shape), dt, cuda) for _ in range(4))
    scale = shape[-1] ** -0.5
    n0 = fused_attention.fused_attention.bwd_launches
    got = fused_attention.launch_attention_bwd(q, k, v, g, scale)
    assert fused_attention.fused_attention.bwd_launches == n0 + 1
    want = fused_attention.fused_attention_bwd_plain(q, k, v, g, scale)
    tol = (1e-2, 0.0) if dt == torch.bfloat16 else (1e-4, 1e-4)
    for a, b in zip(got, want):
        assert a.dtype == dt and a.shape == q.shape
        _cmp(a, b, *tol)
    # through autograd: the kernel, not the plain version
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
    out = fused_attention.fused_attention(qg, kg, vg, scale)
    auto = torch.autograd.grad(out, (qg, kg, vg), g)
    assert fused_attention.fused_attention.bwd_launches == n0 + 2
    for a, b in zip(auto, got):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
def test_attention_bwd_bit_identical_on_repeat(cuda, dt):
    """No atomics: two backward calls through autograd, from q, k, v taken
    as `qkv` views, give the same bits, and agree with the plain backward."""
    r = np.random.default_rng(12)
    b, n, h, d = 4, 196, 3, 64
    base = _t(r.normal(size=(b, n, 3, h, d)), dt, cuda)
    g = _t(r.normal(size=(b, n, h, d)), dt, cuda)
    runs = []
    for _ in range(2):
        qkv = base.clone().requires_grad_()
        out = fused_attention.fused_attention(qkv[:, :, 0], qkv[:, :, 1],
                                              qkv[:, :, 2])
        (dqkv,) = torch.autograd.grad(out, qkv, g)
        runs.append(dqkv)
    assert torch.equal(runs[0], runs[1])
    want = fused_attention.fused_attention_bwd_plain(
        base[:, :, 0], base[:, :, 1], base[:, :, 2], g, d ** -0.5)
    tol = (1e-2, 0.0) if dt == torch.bfloat16 else (1e-4, 1e-4)
    for i in range(3):
        _cmp(runs[0][:, :, i], want[i], *tol)


@pytest.mark.cuda
def test_attention_bwd_kernel_raises_outside_its_envelope(cuda):
    q = torch.zeros(1, 8, 2, 24, device=cuda)
    with pytest.raises(ValueError, match="head dim 24"):
        fused_attention.launch_attention_bwd(q, q, q, q, 0.2)


@pytest.mark.cuda
def test_vit_block_bf16_grads_reach_every_parameter(cuda):
    """Regression: the kernels' wrappers returned tensors without a grad_fn,
    so a bf16 backward on the card stopped at the last block and every
    backbone weight got no gradient, with no error."""
    from pvpuformer_tpu_torch.models import vit
    blk = vit.Block(768, 12, 4.0, True, torch.Generator().manual_seed(1))
    x = torch.randn(8, 196, 768, generator=torch.Generator().manual_seed(2))
    grads = {}
    for where in ("cpu", cuda):
        b = vit.Block(768, 12, 4.0, True)
        b.load_state_dict(blk.state_dict())
        b.requires_grad_(True)
        b.to(where)
        xx = x.to(where, torch.bfloat16).requires_grad_()
        n0 = (fused_attention.fused_attention.bwd_launches,
              fused_mlp.fused_ln_mlp.bwd_launches)
        vit.block_forward(b, xx, 12, 1e-6).float().square().mean().backward()
        grads[str(where)] = {n: p.grad for n, p in b.named_parameters()}
        grads[str(where)]["x"] = xx.grad
    assert (fused_attention.fused_attention.bwd_launches,
            fused_mlp.fused_ln_mlp.bwd_launches) == (n0[0] + 1, n0[1] + 1)
    for n, gc in grads["cpu"].items():
        gg = grads[str(cuda)][n]
        assert gg is not None, f"{n}: no gradient on the card"
        scale = float(gc.float().abs().max())
        err = float((gg.float().cpu() - gc.float()).abs().max())
        assert err <= 2e-2 * scale, (n, err, scale)


@pytest.mark.cuda
def test_tiny_train_step_cuda_matches_cpu(cuda):
    import chip_smoke
    chip_smoke.phase_train_parity(cuda)


# --- the serving slice: int8 products, user clicks, BRS -----------------

@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(1, 64, 192), (5, 20, 12), (17, 64, 64),
                                   (33, 64, 192), (1568, 768, 2304)])
def test_int_mm_on_the_card_is_exact(cuda, m, k, n):
    """`nn.int_mm` pads to the shapes cuBLASLt takes and passes it a
    column-major second operand: exact against an int32 product, for
    either layout of b (a row-major b is refused by cuBLASLt at most m)."""
    from pvpuformer_tpu_torch import nn
    r = np.random.default_rng(m + k + n)
    a = torch.from_numpy(r.integers(-127, 128, (m, k)).astype(np.int8))
    b = torch.from_numpy(r.integers(-127, 128, (k, n)).astype(np.int8))
    want = a.int() @ b.int()
    for bb in (b, b.t().contiguous().t()):
        got = nn.int_mm(a.to(cuda), bb.to(cuda))
        assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
def test_int8_linear_card_is_bit_identical_to_cpu(cuda, dt):
    from pvpuformer_tpu_torch import nn
    g = torch.Generator().manual_seed(0)
    q = nn.quantize_params(nn.Linear(768, 2304, g=g), dtype=dt)
    x = (torch.randn((2, 784, 768), generator=g) * 2).to(dt)
    want = nn.linear(q, x)
    assert torch.equal(nn.linear(q.to(cuda), x.to(cuda)).cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
def test_user_click_step_captures_without_host_sync(cuda, int8):
    """A user-click round (tiny config, f32) captures into a CUDA graph:
    the click comes as device tensors and the round makes no host sync;
    its state equals the CPU round's."""
    from pvpuformer_tpu_torch.inference.predictor import (Predictor,
                                                         PredictorConfig,
                                                         user_click_step)
    from pvpuformer_tpu_torch.models.vpu import init_vpu
    cfg = PredictorConfig(model=_tiny_config(), target_size=(64, 64),
                          min_crop_size=32)
    image = (np.random.default_rng(7).uniform(size=(60, 90, 3)) * 255
             ).astype(np.uint8)
    states = []
    for where in ("cpu", cuda):
        model = init_vpu(cfg.model, torch.Generator().manual_seed(1), "cpu")
        pred = Predictor(model, cfg, device=where, int8=int8)
        pred.set_input(image, np.zeros((60, 90), np.float32))
        pred.user_click(20.5, 30.5, True)
        pred.user_click(40.0, 70.0, False)
        states.append(pred.state)
    for a, b in zip(*states):
        if a.dtype == torch.float32:
            np.testing.assert_allclose(b.cpu().numpy(), a.numpy(),
                                       atol=5e-3 if int8 else 1e-5)
        else:
            assert torch.equal(b.cpu(), a)
    y, x, pos = (torch.tensor(v, device=cuda) for v in (10.0, 12.0, True))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.no_grad(), torch.cuda.stream(side):
        user_click_step(pred.model, cfg, pred.state, y, x, pos)
    graph = torch.cuda.CUDAGraph()
    with torch.no_grad(), torch.cuda.graph(graph, stream=side):
        user_click_step(pred.model, cfg, pred.state, y, x, pos)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("target", ["rgb", "dmaps"])
def test_input_brs_objective_card_matches_cpu(cuda, target):
    """RGB-BRS / DistMap-BRS's value and gradient at a fixed delta (tiny
    config, f32): the card's attention forward and backward kernels
    against the CPU's plain versions, within 1e-4 of the gradient's
    largest entry."""
    from pvpuformer_tpu_torch.inference import brs
    from pvpuformer_tpu_torch.models.vpu import init_vpu
    cfg = _tiny_config()
    r = np.random.default_rng(3)
    crop = torch.from_numpy(r.uniform(size=(2, 64, 64, 4)).astype(np.float32))
    pts = torch.full((2, 12, 3), -1.0)
    pts[:, 0] = torch.tensor([20.0, 30.0, 0.0])
    pts[:, 6] = torch.tensor([50.0, 50.0, 1.0])
    nch = 3 if target == "rgb" else 2
    delta = torch.from_numpy((r.normal(size=64 * 64 * nch) * 0.05
                              ).astype(np.float32))
    pos, neg = brs.click_maps(pts, 64, 64)
    out = []
    for where in ("cpu", cuda):
        model = init_vpu(cfg, torch.Generator().manual_seed(1), where)
        (loss, _), g = brs.value_and_grad(
            brs._input_objective, model, cfg, crop.to(where), pts.to(where),
            delta.to(where), pos.to(where), neg.to(where), 1e-3, True, 64, 64,
            target, argnum=4)
        out.append((float(loss), g.cpu()))
    (lc, gc), (lg, gg) = out
    assert abs(lc - lg) <= 1e-5 * max(1.0, abs(lc))
    assert float((gg - gc).abs().max()) <= 1e-4 * float(gc.abs().max())


@pytest.mark.cuda
def test_serving_parity_cuda_matches_cpu(cuda):
    import chip_smoke
    chip_smoke.phase_serving_parity(cuda)


def _replay_setup(cuda, **kw):
    """A tiny f32 Predictor on the card (its rounds replayed from captured
    rounds) and the prompt tests' image and gt."""
    from pvpuformer_tpu_torch.inference.predictor import (Predictor,
                                                         PredictorConfig)
    from pvpuformer_tpu_torch.models.vpu import init_vpu
    cfg = PredictorConfig(model=_tiny_config(), target_size=(64, 64),
                          min_crop_size=32, **kw)
    model = init_vpu(cfg.model, torch.Generator().manual_seed(1), "cpu")
    r = np.random.default_rng(7)
    image = (r.uniform(size=(60, 90, 3)) * 255).astype(np.uint8)
    gt = np.zeros((60, 90), np.float32)
    gt[14:50, 18:46] = 1.0
    return Predictor(model, cfg, device=cuda), image, gt


def _launches():
    import chip_smoke
    return chip_smoke._counts()


def _zero():
    import chip_smoke
    chip_smoke._zero_counts()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["clicks", "mode2_multi", "batched",
                                  "batched_mode1_points", "user"])
def test_replayed_rounds_match_eager(cuda, kind):
    """Rounds replayed from a captured round (inference/graphs.py) against
    the eager functions from the same state: every state field and IoU
    bit-identical (the same ops in the same order). The wrappers count the
    calls of the rounds run eagerly or captured, none of a replay; a
    profiler trace of a replayed run shows each kernel launched on the card
    as often as the eager run calls its wrapper."""
    import chip_smoke
    from pvpuformer_tpu_torch.inference import batched, graphs
    from pvpuformer_tpu_torch.inference import predictor as P
    kw = {"mode2_multi": dict(prompt_mode=2),
          "batched_mode1_points": dict(prompt_mode=1,
                                       as_multi_prompts=False)}.get(kind, {})
    pred, image, gt = _replay_setup(cuda, **kw)
    graphs.clear()
    if kind.startswith("batched"):
        r = np.random.default_rng(0)
        cfg = batched.resolve_batched_cfg(pred.cfg)
        states = P.stack_states([P.init_session(
            image, np.roll(gt, int(r.integers(-10, 10)), 1), 6, (64, 128),
            cuda) for _ in range(3)])

        def eager():
            return batched.batched_click_scan(pred.model, cfg, states, 4)

        def replayed():
            return graphs.click_rounds(pred.model, cfg, states, 4)
    elif kind == "user":
        clicks = [(20.5, 30.25, True), (40.0, 70.0, False), (10.0, 50.0, True)]
        pred.set_input(image, gt)
        state0 = pred.state

        def eager():
            st, ious = state0, []
            for y, x, pos in clicks:
                st, iou = P.user_click_step(
                    pred.model, pred.cfg, st, torch.tensor(y, device=cuda),
                    torch.tensor(x, device=cuda),
                    torch.tensor(pos, device=cuda))
                ious.append(iou)
            return st, torch.stack(ious)

        def replayed():
            pred.state = state0
            ious = [pred.user_click(y, x, pos) for y, x, pos in clicks]
            return pred.state, torch.tensor(ious)
    else:
        pred.set_input(image, gt)
        state0 = pred.state

        def eager():
            return P.click_scan(pred.model, pred.cfg, state0, 4)

        def replayed():
            pred.state = state0
            pred.gen.manual_seed(P.NOISE_SEED)
            ious = pred.run_clicks(4)
            return pred.state, torch.from_numpy(ious)
    n = 3 if kind == "user" else 4                 # rounds per run
    counts, outs, ran = [], [], []
    # eager; replayed: an eager round, a capture, replays; replays only
    for fn in (eager, replayed, replayed):
        r0 = dict(graphs.rounds)
        _zero()
        with torch.no_grad():
            st, ious = fn()
        torch.cuda.synchronize()
        counts.append(_launches())
        ran.append({k: graphs.rounds[k] - r0[k] for k in r0})
        outs.append((st, ious.cpu()))
    assert len(graphs._graphs) == 1
    assert ran[1:] == [{"eager": 1, "captured": 1, "replayed": n - 1},
                       {"eager": 0, "captured": 0, "replayed": n}]
    assert counts[0]["fused_attention"] > 0
    assert all(v % n == 0 for v in counts[0].values())
    assert counts[1] == {k: v // n * 2 for k, v in counts[0].items()}
    assert not any(counts[2].values())
    with torch.no_grad():
        _, device = chip_smoke._device_launches(replayed)
    assert device == {k: counts[0][k] for k in device}
    for st, ious in outs[1:]:
        assert torch.equal(ious.float(), outs[0][1].float())
        for name, a, b in zip(P.SessionState._fields, st, outs[0][0]):
            assert torch.equal(a, b), name


@pytest.mark.cuda
def test_undo_keeps_a_copy_across_replays(cuda):
    """The undo stack holds states no later replay writes, also when
    another session on the same model replays the same captured round."""
    from pvpuformer_tpu_torch.inference import graphs
    from pvpuformer_tpu_torch.inference.predictor import Predictor
    pred, image, gt = _replay_setup(cuda)
    other = Predictor(pred.model, pred.cfg, device=cuda)
    pred.set_input(image, gt)
    other.set_input(image[:, ::-1].copy(), gt[:, ::-1].copy())
    pred.next_click()
    kept_state = pred.state
    kept = [t.clone() for t in kept_state]
    pred.next_click()
    other.run_clicks(3)
    pred.next_click()
    pred.undo_click()
    pred.undo_click()
    assert pred.state is kept_state
    for a, b in zip(pred.state, kept):
        assert torch.equal(a, b)
    static = {t.data_ptr() for r in graphs._graphs.values() for t in r.state}
    assert not static & {t.data_ptr() for t in pred.state}


def _plainvit_config(dtype):
    """A small PlainVit whose blocks fit the bf16 LN+MLP kernel (D = 128,
    the kernel's least width; head dim 64)."""
    from pvpuformer_tpu_torch.models.fpn import NeckConfig
    from pvpuformer_tpu_torch.models.plainvit import PlainVitConfig
    from pvpuformer_tpu_torch.models.seg_head import HeadConfig
    from pvpuformer_tpu_torch.models.vit import ViTConfig
    return PlainVitConfig(
        backbone=ViTConfig(img_size=(128, 128), patch_size=(16, 16),
                           embed_dim=128, depth=4, num_heads=2,
                           window_pixels=64),
        neck=NeckConfig(in_dim=128, out_dims=(16, 32, 48, 64),
                        img_size=(128, 128), hide_dim=64),
        head=HeadConfig(in_channels=(16, 32, 48, 64), channels=32,
                        d_model=128, ed_loss=False),
        num_max_points=6, dtype=dtype)


@pytest.mark.cuda
def test_plainvit_bf16_click_runs_the_kernels_and_no_sdpa(cuda, monkeypatch):
    """One eager bf16 PlainVit click round on the card calls the fused
    attention kernel and the LN+MLP kernel once per block and the min-plus
    kernel once, and never torch's scaled_dot_product_attention."""
    import torch.nn.functional as F
    from pvpuformer_tpu_torch.inference.predictor import (PredictorConfig,
                                                         click_step,
                                                         init_session)
    from pvpuformer_tpu_torch.models.plainvit import init_plainvit
    from pvpuformer_tpu_torch.nn import inference_model

    def no_sdpa(*a, **kw):
        raise AssertionError("scaled_dot_product_attention was called")
    monkeypatch.setattr(F, "scaled_dot_product_attention", no_sdpa)
    cfg = _plainvit_config(torch.bfloat16)
    model = inference_model(init_plainvit(
        cfg, torch.Generator().manual_seed(0), "cpu"), torch.bfloat16, cuda)
    pcfg = PredictorConfig(model=cfg, target_size=(128, 128),
                           min_crop_size=64)
    r = np.random.default_rng(0)
    image = (r.uniform(size=(120, 150, 3)) * 255).astype(np.uint8)
    gt = np.zeros((120, 150), np.float32)
    gt[30:90, 40:110] = 1.0
    state = init_session(image, gt, 6, (128, 192), cuda)
    kernels = (fused_attention.fused_attention, attention.flash_attention,
               edt_minplus.minplus_rows, fused_mlp.fused_ln_mlp)
    for k in kernels:
        k.launches = 0
    with torch.no_grad():
        state, iou = click_step(model, pcfg, state)
        iou = float(iou)
    assert np.isfinite(iou) and 0.0 <= iou <= 1.0
    depth = cfg.backbone.depth
    assert [k.launches for k in kernels] == [depth, 0, 1, depth]


ZOO_CUDA_CONFIGS = {
    "segformer": dict(embed_dims=(16, 32, 48, 64), depths=(1, 1, 1, 1),
                      num_heads=(1, 2, 3, 4), head_channels=32),
    "hrnet": dict(width=8, small=True, ocr_width=16),
    "deeplab": dict(ch=32),
    "swin": dict(embed_dim=16, depths=(1, 1, 1, 1), num_heads=(1, 2, 4, 8),
                 head_channels=16, window=4),
    "hrformer": dict(width=8, num_heads=(1, 2, 4, 8), num_units=(1, 1, 1),
                     window=4, ocr_width=16),
    "swin_unet": dict(embed_dim=16, depths=(1, 1, 1, 1),
                      num_heads=(1, 2, 4, 8), window=4),
}


@pytest.mark.cuda
@pytest.mark.parametrize("family", sorted(ZOO_CUDA_CONFIGS))
def test_zoo_forward_on_the_card_matches_cpu(cuda, family):
    """Each zoo family's f32 forward (tests/test_zoo.py's tiny configs) on
    the card within 1e-4 of its CPU twin relative to the largest logit.
    The model is placed through `registry.build`, whose `resolve_device`
    pins cuDNN's TF32 off (torch's default would run f32 convs in TF32)."""
    import importlib
    from pvpuformer_tpu_torch.models import registry
    mod = importlib.import_module(f"pvpuformer_tpu_torch.models.zoo.{family}")
    cls = next(getattr(mod, n) for n in dir(mod) if n.endswith("ISConfig"))
    cfg = cls(**ZOO_CUDA_CONFIGS[family])
    r = np.random.default_rng(1)
    img = torch.from_numpy(r.uniform(size=(2, 64, 64, 4)).astype(np.float32))
    pts = torch.full((2, 8, 3), -1.0)
    pts[0, 0] = torch.tensor([30.0, 30.0, 0.0])
    pts[1, 4] = torch.tensor([10.0, 50.0, 1.0])
    out = {}
    for where in ("cpu", cuda):
        model = registry.build(cfg, torch.Generator().manual_seed(0), where)
        with torch.no_grad():
            out[str(where)] = registry.forward_for(cfg)(
                model, cfg, img.to(where), pts.to(where))["instances"].cpu()
    want = out["cpu"]
    err = float((out[str(cuda)] - want).abs().max())
    assert err <= 1e-4 * max(1.0, float(want.abs().max())), err
