"""The port's bf16 VPU forward against the JAX package's, on the CPU.

The tiny test config in bf16, on the same weights (converted through
utils/serialization): JAX's `vpu_forward` with `attn_impl="fused"` and
`mlp_impl="fused"`, whose Pallas kernels run in interpret mode on the CPU,
against the port's forward, whose ViT blocks run the plain versions of its
kernels (the same numerics as those two JAX kernels: the port has no other
MLP half, see `models/vit.py:ViTConfig`). The JAX side is jitted once per
module.

Tolerance, from the measured error (the CPU, the seeds below): the port's
logits differ from JAX's by at most 0.0078 on `instances` and 0.0059 on
`instances_aux`, mean 0.0014 / 0.0005, against logits of magnitude up to
0.82 (81% / 99.5% of them within one bf16 ulp). Both sides round at the
same points; a bf16 intermediate on a rounding boundary moves by one ulp
when the f32 sums before it differ in their last bits, and such flips pass
through 8 ViT blocks, the two-way transformer, neck and head. Limits: max
0.02 and mean 0.004 (about 2.5x and 3x the measured). Zeroing one block's
fc2 weight moves the logits by 0.17 max / 0.026 mean and fails both; JAX's
other MLP numerics (`mlp_impl="xla"`, fc1 rounded to bf16 before its bias
and GELU) differ from the port by 0.0098 / 0.0015, inside these limits: at
this size the test holds the port to JAX's bf16 model, not to one
rounding point.

The rounding points are held one ViT block deep, before flips accumulate
(`test_bf16_vit_block_keeps_jax_fused_rounding_points`): the port's bf16
block against JAX's `block_forward` with both fused kernels differs in
0% / 0.02% / 0.12% of its outputs at (dim, tokens) (64, 16) / (64, 64) /
(128, 64), mean error 0 / 6e-8 / 1.7e-6; JAX's `mlp_impl="xla"` differs
from the port in 49-51% (mean 2.0e-3), with `ln_f32=False` as well in
55-59% (mean 2.5e-3), and the fused MLP with a bf16 pre-attention
LayerNorm in 39-51% (mean 1.4e-3). Limits: at most 1% of the outputs
differ and the mean error is at most 1e-4; the test also asserts that
those three JAX variants break both. The module takes ~30 s (one JAX jit
of the forward with both Pallas kernels in interpret mode, ~20 s; 12 jits
of one block, ~10 s).
"""
import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvpuformer_tpu.models import vit as jvit
from pvpuformer_tpu.models import vpu as jvpu
from pvpuformer_tpu.utils.serialization import config_to_dict, flatten_tree
from pvpuformer_tpu_torch.models import vit, vpu
from pvpuformer_tpu_torch.utils.serialization import (config_from_dict,
                                                      params_from_numpy)
from test_models import tiny_cfg
from test_torch_model import two_torch_threads  # noqa: F401

ATOL, MEAN = 0.02, 0.004
BLOCK_SHARE, BLOCK_MEAN = 0.01, 1e-4


def _inputs():
    r = np.random.default_rng(11)
    img = r.uniform(size=(2, 64, 64, 4)).astype(np.float32)
    pts = np.full((2, 12, 3), -1.0, np.float32)
    pts[0, 0] = [20, 30, 0]
    pts[0, 6] = [40, 10, 1]
    pts[1, 0] = [5, 60, 0]
    pts[1, 1] = [33, 33, 2]
    pts[1, 6] = [50, 50, 1]
    return img, pts


@pytest.fixture(scope="module")
def forwards():
    """(JAX logits, port logits) of the bf16 forward, f32 numpy arrays. The
    tiny config at depth 8: blocks 1, 3, 5, 7 run on 2 x 2 token windows,
    2, 4, 6, 8 on the whole 4 x 4 grid (at depth 4 every block is global)."""
    jcfg = tiny_cfg(window_pixels=32)
    jcfg = jcfg.replace(dtype=jnp.bfloat16, backbone=dataclasses.replace(
        jcfg.backbone, depth=8, attn_impl="fused", mlp_impl="fused"))
    params = jvpu.init_vpu(jax.random.key(0), jcfg)
    img, pts = _inputs()
    fwd = jax.jit(functools.partial(jvpu.vpu_forward, cfg=jcfg))
    want = fwd(params, image=jnp.asarray(img), points=jnp.asarray(pts))
    cfg = config_from_dict(config_to_dict(jcfg))
    assert cfg.dtype == torch.bfloat16
    model = vpu.VPUModel(cfg)
    model.load_state_dict(params_from_numpy(flatten_tree(params)))
    with torch.no_grad():
        got = model(torch.from_numpy(img), torch.from_numpy(pts))
    return ({k: np.asarray(want[k].astype(jnp.float32)) for k in want},
            {k: got[k].float().numpy() for k in got})


@pytest.mark.parametrize("key", ["instances", "instances_aux"])
def test_bf16_forward_matches_jax_fused_kernels(forwards, key):
    want, got = forwards
    assert got[key].shape == want[key].shape
    assert np.isfinite(got[key]).all()
    err = np.abs(got[key] - want[key])
    assert err.max() <= ATOL and err.mean() <= MEAN, (err.max(), err.mean())


@pytest.mark.parametrize("dim,n", [(64, 16), (64, 64), (128, 64)])
def test_bf16_vit_block_keeps_jax_fused_rounding_points(dim, n):
    """One bf16 ViT block, the port's against JAX's with
    attn_impl="fused" and mlp_impl="fused": the share of outputs that
    differ and the mean error stay within the limits, which JAX's other
    numerics (the XLA MLP; bf16 LayerNorm statistics) break."""
    heads, b = 2, 2
    jp = jvit.init_block(jax.random.key(0), dim, heads, 4.0, True)
    blk = vit.Block(dim, heads, 4.0, True)
    blk.load_state_dict(params_from_numpy(flatten_tree(jp)))
    blk = blk.to(torch.bfloat16)
    jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), jp)
    x = np.random.default_rng(5).normal(size=(b, n, dim)).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)

    def errors(**kw):
        f = jax.jit(lambda p, x: jvit.block_forward(p, x, heads, 1e-6,
                                                    attn_impl="fused", **kw))
        e = np.abs(got - np.asarray(f(jp, xb).astype(jnp.float32)))
        return float((e > 0).mean()), float(e.mean())

    with torch.no_grad():
        got = vit.block_forward(blk, torch.from_numpy(x).bfloat16(), heads,
                                1e-6).float().numpy()
    share, mean = errors(mlp_impl="fused")
    assert share <= BLOCK_SHARE and mean <= BLOCK_MEAN, (share, mean)
    for kw in (dict(mlp_impl="xla"), dict(mlp_impl="xla", ln_f32=False),
               dict(mlp_impl="fused", ln_f32=False)):
        share, mean = errors(**kw)
        assert share > BLOCK_SHARE and mean > BLOCK_MEAN, (kw, share, mean)


def test_bf16_layer_norm_matches_jax_op_by_op():
    """`layer_norm(..., f32=False)` in bf16 rounds where JAX's does op by
    op: bit-identical to JAX's eager call. (JAX's jitted one differs in
    ~1.4% of its outputs, where XLA's CPU fusion keeps excess precision
    between the ops, so `ln_f32=False` is not held to a jitted JAX model.)"""
    from pvpuformer_tpu import nn as jnn
    from pvpuformer_tpu_torch import nn as tnn
    r = np.random.default_rng(0)
    x = (r.normal(size=(4, 64, 128)) * 3 + 1).astype(np.float32)
    scale, bias = (r.normal(size=(128,)).astype(np.float32) for _ in "sb")
    want = jnn.layer_norm({"scale": jnp.asarray(scale),
                           "bias": jnp.asarray(bias)},
                          jnp.asarray(x).astype(jnp.bfloat16), 1e-6,
                          f32=False)
    p = types.SimpleNamespace(scale=torch.from_numpy(scale),
                              bias=torch.from_numpy(bias))
    got = tnn.layer_norm(p, torch.from_numpy(x).bfloat16(), 1e-6, f32=False)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
