"""The int8 gate's training (pvpuformer_tpu_torch/gate_int8.py:
`train_synthetic`) against scripts/gate_int8.py's, on the CPU, f32 at the
tiny config (tests/test_models.py:tiny_cfg, 64 x 64).

Two steps (num_iters 1 and 2) from the same JAX init: the batches (the
synthetic blobs and the sampler's clicks from one `default_rng(0)` stream)
are the same by construction, and JAX's draws of each step
(`jax.random.key(step)`) are injected into the port's `_train_noise`
(tests/test_torch_train.py:jax_train_noise), since torch cannot reproduce
them. Each step's loss within 1e-5 of JAX's, the tolerance of
tests/test_torch_train.py."""
import json

import jax
import numpy as np
import torch

from pvpuformer_tpu.engine import train_step as jts
from pvpuformer_tpu_torch import gate_int8 as tgate
from pvpuformer_tpu_torch.engine import train_step as tts
from scripts import gate_int8 as jgate
from test_torch_grad import jax_tiny_params
from test_torch_model import port_model, two_torch_threads  # noqa: F401
from test_torch_train import jax_train_noise

STEPS = 2


def test_train_synthetic_losses_match_jax(monkeypatch, capsys):
    params, jcfg = jax_tiny_params()
    model, cfg = port_model(params, jcfg)

    jax_losses = []
    step_fn = jts.train_step

    def record(*a, **kw):
        out = step_fn(*a, **kw)
        jax_losses.append(float(out[2]["loss"]))
        return out

    monkeypatch.setattr(jts, "train_step", record)
    jgate.train_synthetic(params, jcfg, STEPS)

    calls = []

    def jax_draws(tcfg, gen, b, h, w, num_iters):
        step = len(calls)
        calls.append(num_iters)
        return jax_train_noise(jax.random.key(step), b, h, w, num_iters)

    monkeypatch.setattr(tts, "_train_noise", jax_draws)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    losses = tgate.train_synthetic(model, cfg, STEPS, device="cpu")
    assert calls == [1, 2]
    assert len(losses) == len(jax_losses) == STEPS
    np.testing.assert_allclose(losses, jax_losses, atol=1e-5, rtol=0)
    # step 0 prints its loss, as JAX's does; the model was updated and is
    # frozen again for the sessions
    assert "train step 0: loss" in capsys.readouterr().out
    assert any(not torch.equal(p, before[n])
               for n, p in model.named_parameters())
    assert not any(p.requires_grad for p in model.parameters())


def test_train_batch_is_jax_batch():
    """The batch the port builds equals the one JAX's loop builds (images,
    masks and the sampler's clicks from the same rng stream)."""
    from pvpuformer_tpu.data.points_sampler import MultiPointSampler as JS
    from pvpuformer_tpu_torch.data.points_sampler import MultiPointSampler
    h = w = 64
    rj, rt = np.random.default_rng(0), np.random.default_rng(0)
    js, ts = JS(6, prob_gamma=0.8), MultiPointSampler(6, prob_gamma=0.8)
    for step in range(3):
        b = tgate.train_batch(step, 4, h, w, ts, rt)
        for i in range(4):
            img, gt = jgate.synth_sample(10_000 + step * 4 + i, h, w)
            np.testing.assert_array_equal(b["image"][i],
                                          (img / 255.0).astype(np.float32))
            np.testing.assert_array_equal(b["instances"][i, ..., 0], gt)
            np.testing.assert_array_equal(
                b["points"][i], js.sample(rj, [gt > 0.5])[0])
    assert b["scribbles"].shape == (4, 1000, 2)


def test_gate_cli_on_the_cpu(capsys):
    """`python -m pvpuformer_tpu_torch.gate_int8 --device cpu` prints the
    gate line and the summary's JSON."""
    dim = 768
    tgate.main(["--samples", "1", "--clicks", "2", "--dim", str(dim),
                "--device", "cpu"])
    text = capsys.readouterr().out
    assert f"# gate: depth-4/{dim}@224, 1 samples x 2 clicks, bfloat16" in text
    out = json.loads(text[text.index("{"):])
    assert out["dim"] == dim and out["samples"] == 1 and out["clicks"] == 2
