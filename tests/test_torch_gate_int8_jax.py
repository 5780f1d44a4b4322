"""The port's int8 gate sessions (pvpuformer_tpu_torch/gate_int8.py:
`run_sessions`) against scripts/gate_int8.py's on the same weights, float
and int8, on the CPU at the gate's protocol config (depth 4 at 224, f32,
the JAX script's fields), and the int8-vs-float |dIoU| of both, on two
sets of weights: JAX's `init_vpu(key 0)` loaded into the port (the
weights JAX's recorded envelope was taken on, BASELINE.md "int8 accuracy
gate"), and the port's own seeded init (`init_vpu(gen 0)`, the weights
chip_smoke's gate runs on) loaded into JAX. Per case:

* float: every click sequence equal to JAX's and each per-click IoU
  within 1e-4 (measured 9.3e-6 at 768, 0 at 1280);
* int8: the first click equal and, until a session's clicks part from
  JAX's, each IoU within 5e-3, the int8 session tolerance of
  tests/test_torch_quant.py (a last-bit difference in front of a
  quantized linear moves an int8 quantum now and then; measured 5.6e-4 /
  1.6e-4 on JAX's init at 768 / 1280, 3.1e-3 / 2.4e-3 on the port's);
* float against int8, the port and JAX alike: JAX's bounds of
  tests/test_quant.py:101-164, mean |dIoU| < 0.005 and max < 0.02 with
  the first click equal.

Measured float-vs-int8 mean / max |dIoU|, port and JAX, 768 at 4 x 4 and
1280 at 2 x 3: on JAX's init 3.44e-4 / 9.70e-4 and 2.08e-4 / 5.42e-4
(768), 5.73e-5 / 1.82e-4 and 3.57e-5 / 8.49e-5 (1280); on the port's
init 1.63e-3 / 3.81e-3 and 1.42e-3 / 2.90e-3 (768), 1.44e-3 / 3.04e-3
and 2.19e-3 / 4.51e-3 (1280). On the same weights the port's deltas are
of the size of JAX's; on the port's weights JAX's own int8 path moves
as much as the port's. This is why the card's random-init deltas stand
above JAX's envelope (means 2e-4 at 768 and 8e-5 at 1280, BASELINE.md,
taken on a TPU): the draw, not the int8 path, sets their size; random
weights leave many probabilities near the 0.5 threshold. The cases
share one process's JAX compiles of the two widths' sessions."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvpuformer_tpu.models.vpu import init_vpu as jax_init_vpu
from pvpuformer_tpu.utils.serialization import unflatten_tree
from pvpuformer_tpu_torch import gate_int8 as tgate
from pvpuformer_tpu_torch.models.vpu import init_vpu
from pvpuformer_tpu_torch.utils.serialization import jax_name
from scripts import gate_int8 as jgate
from test_torch_model import port_model

FLOAT_TOL = 1e-4
INT8_TOL = 5e-3          # tests/test_torch_quant.py's int8 session bound
GATE_MEAN, GATE_MAX = 0.005, 0.02     # tests/test_quant.py:101-164


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def sessions_against_jax(params, jcfg, model, cfg, samples, clicks):
    """Float and int8 sessions of the port and of JAX's script on the same
    weights, held to each other; returns {int8: (jax, port)} of
    (curves, click sequences)."""
    out = {}
    for int8 in (False, True):
        jc, jseq = jgate.run_sessions(params, jcfg, samples, clicks, int8)
        pc, pseq = tgate.run_sessions(model, cfg, samples, clicks, int8,
                                      "cpu")
        assert pc.shape == jc.shape == (samples, clicks)
        for s in range(samples):
            assert pseq[s][0] == jseq[s][0], (int8, s, pseq[s], jseq[s])
            if not int8:
                assert pseq[s] == jseq[s], (s, pseq[s], jseq[s])
                np.testing.assert_allclose(pc[s], jc[s], atol=FLOAT_TOL,
                                           rtol=0)
            else:
                # clicks [0, k) equal give IoUs [0, k) on the same prompts
                k = tgate.first_divergence(pseq[s], jseq[s])
                np.testing.assert_allclose(pc[s, :k], jc[s, :k],
                                           atol=INT8_TOL, rtol=0)
        out[int8] = ((jc, jseq), (pc, pseq))
    for side in (0, 1):
        (bf, seq_bf), (q, seq_q) = out[False][side], out[True][side]
        delta = np.abs(bf - q)
        assert delta.mean() < GATE_MEAN, (side, delta.mean())
        assert delta.max() < GATE_MAX, (side, delta.max())
        assert all(a[0] == b[0] for a, b in zip(seq_bf, seq_q))
    return out


@pytest.mark.parametrize("dim,samples,clicks", [(768, 4, 4), (1280, 2, 3)])
def test_port_sessions_on_jax_init_match_jax(dim, samples, clicks):
    jcfg = jgate.protocol_cfg(dim=dim)
    params = jax_init_vpu(jax.random.key(0), jcfg)
    model, cfg = port_model(params, jcfg)
    assert cfg == tgate.protocol_cfg(dim=dim)
    sessions_against_jax(params, jcfg, model, cfg, samples, clicks)


@pytest.mark.parametrize("dim,samples,clicks", [(768, 4, 4), (1280, 2, 3)])
def test_jax_sessions_on_port_init_match_port(dim, samples, clicks):
    cfg = tgate.protocol_cfg(dim=dim)
    model = init_vpu(cfg, torch.Generator().manual_seed(0), device="cpu")
    params = unflatten_tree({jax_name(k): jnp.asarray(v.numpy())
                             for k, v in model.state_dict().items()})
    sessions_against_jax(params, jgate.protocol_cfg(dim=dim), model, cfg,
                         samples, clicks)
