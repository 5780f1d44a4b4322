"""The two connected-component kernels' plain versions and the port's
max_connected_regions vs the JAX package: cc_labels_pallas /
component_max_pallas in interpret mode, the XLA cc_labels, and
connected_regions_mask_batch with impl "xla" and "pallas".

All comparisons are exact: labels are integers and both sides run the same
bounded flood (8 rounds), so a mask whose components need more rounds (the
snake) keeps the same partial labels. The CUDA kernels are held against
these plain versions in tests/test_torch_cuda.py, on a card."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvpuformer_tpu.engine import prompt_sim as jps
from pvpuformer_tpu.ops.cc_pallas import cc_labels_pallas, component_max_pallas
from pvpuformer_tpu_torch.engine import prompt_sim as tps
from pvpuformer_tpu_torch.ops import cc
from test_engine import blobby_mask


@pytest.fixture(autouse=True)
def no_launch_on_cpu():
    before = (cc.cc_labels.launches, cc.component_max.launches)
    yield
    assert (cc.cc_labels.launches, cc.component_max.launches) == before


def snake(h=48, w=64):
    """One serpentine component with 10 direction reversals: more than the
    8 rounds a flood runs, so its labels stay partial."""
    m = np.zeros((h, w), bool)
    for i in range(0, h, 4):
        m[i, 1:w - 1] = True
        m[i:i + 4, w - 2 if (i // 4) % 2 == 0 else 1] = True
    return m


def speckles(h=48, w=64):
    """A 4x4 block plus 20 x 32 = 640 isolated pixels: more than the TPU
    path's compact_cap of 256 components."""
    m = np.zeros((h, w), bool)
    m[1:5, 1:5] = True
    m[8::2, 1::2] = True
    return m


def size_ties():
    """test_engine.py:80-93 (with 8 more empty rows): two joint-largest 4-px
    components among 42 speckles, each under 10% of the foreground."""
    m = np.zeros((48, 64), bool)
    m[2:4, 2:4] = True
    m[30:32, 50:52] = True
    for r in range(10, 28, 3):
        for c in range(8, 64, 8):
            m[r, c] = True
    return m


# one (2, 48, 64) batch per case, so that each JAX function compiles once;
# "ragged" has an odd shape of its own
CASES = {
    "blobs": np.stack([blobby_mask(s, 48, 64) for s in range(2)]),
    "snake": np.stack([snake(), blobby_mask(4, 48, 64)]),
    "speckles": np.stack([speckles(), size_ties()]),
    "empty": np.zeros((2, 48, 64), bool),
    "ragged": np.stack([blobby_mask(7, 37, 53, 6), snake(37, 53)]),
}
_xla_cc = jax.jit(jax.vmap(lambda m: jps.cc_labels(m, impl="xla")))


@pytest.mark.parametrize("case", sorted(CASES))
def test_cc_labels_plain_matches_jax(case):
    m = CASES[case]
    want = np.asarray(cc_labels_pallas(jnp.asarray(m), interpret=True))
    got = cc.cc_labels(torch.from_numpy(m))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(_xla_cc(jnp.asarray(m))))


def test_snake_needs_more_than_eight_rounds():
    m = torch.from_numpy(snake()[None])
    assert len(np.unique(CASES["snake"][0])) == 2          # one component
    assert len(torch.unique(cc.cc_labels(m, 8))) > 2      # partial labels
    assert len(torch.unique(cc.cc_labels(m, 16))) == 2    # one component


@pytest.mark.parametrize("case", sorted(CASES))
def test_component_max_plain_matches_pallas(case):
    m = CASES[case]
    v = np.random.default_rng(5).integers(0, 10 ** 6, m.shape).astype(np.int32)
    want = np.asarray(component_max_pallas(jnp.asarray(m), jnp.asarray(v),
                                           interpret=True))
    got = cc.component_max(torch.from_numpy(m), torch.from_numpy(v))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", ["blobs", "speckles", "empty"])
def test_connected_regions_matches_jax(case):
    """"speckles" holds both the > 256-component mask and the size tie."""
    m = CASES[case]
    got = tps.connected_regions_mask_batch(torch.from_numpy(m)).numpy()
    for impl in ("xla", "pallas"):
        want = np.asarray(_regions[impl](jnp.asarray(m)))
        np.testing.assert_array_equal(got, want, err_msg=impl)
    # the keep step alone, over the labels (the JAX scatter path's form)
    labs = cc.cc_labels(torch.from_numpy(m))
    want = jax.vmap(lambda x, lab: jps._scatter_keep_one(x, lab, 0.1))(
        jnp.asarray(m), jnp.asarray(labs.numpy()))
    np.testing.assert_array_equal(
        tps._scatter_keep_one(torch.from_numpy(m), labs, 0.1).numpy(),
        np.asarray(want))
    if case == "speckles":                   # the smallest label wins the tie
        assert got[1, 2:4, 2:4].all() and not got[1, 30:32, 50:52].any()


_regions = {impl: jax.jit(lambda m, impl=impl: jps.connected_regions_mask_batch(
    m, impl=impl)) for impl in ("xla", "pallas")}


def test_cc_wrapper_checks_what_the_kernel_takes():
    with pytest.raises(ValueError, match="iters"):
        cc._checked(torch.zeros(1, 4, 4, dtype=torch.bool), 0, "cc_labels")
    with pytest.raises(ValueError, match="8192"):
        cc._checked(torch.zeros(1, 2, 8193, dtype=torch.bool), 8, "cc_labels")
    with pytest.raises(TypeError, match="bool"):
        cc._checked(torch.zeros(1, 4, 4), 8, "cc_labels")
