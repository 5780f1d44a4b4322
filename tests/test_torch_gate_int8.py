"""The port's int8 accuracy gate (pvpuformer_tpu_torch/gate_int8.py) against
the JAX package's scripts/gate_int8.py, and the gate's bounds on the port,
on the CPU.

* The helpers equal JAX's: `synth_sample` bit for bit, `protocol_cfg`'s
  fields at 768 / 1024 / 1280, `noc` on made-up curves, and `summarize`
  equal to the JSON the JAX script's `main` prints for the same curves and
  click sequences (its sessions and init stubbed; the script runs as it
  is).
* The bounds of tests/test_quant.py:101-164 on the port's int8 sessions
  against its bf16 sessions of the same seeded random model: mean |dIoU| <
  0.005 and max < 0.02 with the first click equal; 8 samples x 4 clicks at
  768, 4 x 3 at 1024 and 1280, as JAX's tests take them.
The training steps are held against JAX's in
tests/test_torch_gate_int8_train.py, and the sessions against JAX's on the
same weights (JAX's init and the port's) in
tests/test_torch_gate_int8_jax.py."""
import json
import sys

import numpy as np
import pytest
import torch

from pvpuformer_tpu.utils import serialization as jser
from pvpuformer_tpu_torch import gate_int8 as tgate
from pvpuformer_tpu_torch.models.vpu import init_vpu
from pvpuformer_tpu_torch.utils import serialization as ser
from scripts import gate_int8 as jgate


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed,h,w", [(0, 96, 128), (7, 96, 128),
                                      (10_003, 224, 224), (3, 64, 80)])
def test_synth_sample_bit_equal(seed, h, w):
    img, gt = tgate.synth_sample(seed, h, w)
    jimg, jgt = jgate.synth_sample(seed, h, w)
    assert img.dtype == jimg.dtype and gt.dtype == jgt.dtype
    np.testing.assert_array_equal(img, jimg)
    np.testing.assert_array_equal(gt, jgt)


@pytest.mark.parametrize("dim", [768, 1024, 1280])
def test_protocol_cfg_has_jax_fields(dim):
    """Encoded as a checkpoint header, the port's config is JAX's (f32 at
    the default dtype); with bf16 only the dtype differs."""
    want = jser.config_to_dict(jgate.protocol_cfg(dim=dim))
    assert ser.config_to_dict(tgate.protocol_cfg(dim=dim)) == want
    bf = ser.config_to_dict(tgate.protocol_cfg(dim=dim, dtype=torch.bfloat16))
    assert bf["dtype"] == {"__dtype__": "bfloat16"}
    assert {k: v for k, v in bf.items() if k != "dtype"} == \
        {k: v for k, v in want.items() if k != "dtype"}


def made_up(seed, n=6, clicks=5):
    r = np.random.default_rng(seed)
    curves = np.sort(r.uniform(0, 1, (n, clicks)), axis=1).astype(np.float32)
    q = np.clip(curves + r.normal(0, 0.01, curves.shape), 0, 1).astype(
        np.float32)
    seqs = [[(bool(r.integers(2)), int(r.integers(96)), int(r.integers(128)))
             for _ in range(clicks)] for _ in range(n)]
    seq_q = [list(s) for s in seqs]
    seq_q[1][3] = (True, 0, 0)           # diverges at click 3
    seq_q[4] = seq_q[4][:2]              # a shorter sequence: at click 2
    seq_q[5][0] = (False, 1, 1)          # at click 0
    return curves, q, seqs, seq_q


@pytest.mark.parametrize("thr", [0.5, 0.8, 0.95])
def test_noc_equal(thr):
    curves = made_up(0)[0]
    for c in (curves, np.zeros_like(curves), np.ones_like(curves)):
        assert tgate.noc(c, thr, 5) == jgate.noc(c, thr, 5)


@pytest.mark.parametrize("train_steps", [0, 60])
def test_summarize_equals_jax_main(monkeypatch, capsys, train_steps):
    """JAX's `main` on stubbed sessions (bf16 curves first, then int8), its
    init and training stubbed too: the printed JSON equals `summarize`."""
    bf, q, seq_bf, seq_q = made_up(1)
    n, clicks = bf.shape
    runs = iter([(bf, seq_bf), (q, seq_q)])
    import pvpuformer_tpu.models.vpu as jvpu
    monkeypatch.setattr(jgate, "run_sessions", lambda *a, **k: next(runs))
    monkeypatch.setattr(jgate, "train_synthetic", lambda p, *a, **k: p)
    monkeypatch.setattr(jvpu, "init_vpu", lambda key, cfg: {})
    monkeypatch.setattr(sys, "argv", [
        "gate_int8.py", "--samples", str(n), "--clicks", str(clicks),
        "--train-steps", str(train_steps), "--dim", "1024"])
    jgate.main()
    text = capsys.readouterr().out
    printed = json.loads(text[text.index("{"):])
    got = tgate.summarize(bf, q, seq_bf, seq_q, 1024, n, clicks, train_steps)
    assert got == printed
    assert got["first_divergent_click"] == [3, 2, 0]


def test_gate_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tgate.main(["--samples", "1", "--clicks", "1"])


@pytest.mark.parametrize("dim,samples,clicks", [(768, 8, 4), (1024, 4, 3),
                                                (1280, 4, 3)])
def test_int8_within_bounds_of_bf16(dim, samples, clicks):
    """tests/test_quant.py's protocol bounds, port int8 against port bf16
    on the port's seeded random init."""
    mcfg = tgate.protocol_cfg(dim=dim, dtype=torch.bfloat16)
    model = init_vpu(mcfg, torch.Generator().manual_seed(0), device="cpu")
    bf, seq_bf = tgate.run_sessions(model, mcfg, samples, clicks, False,
                                    "cpu")
    q, seq_q = tgate.run_sessions(model, mcfg, samples, clicks, True, "cpu")
    assert bf.shape == q.shape == (samples, clicks)
    delta = np.abs(bf - q)
    assert delta.mean() < 0.005, delta.mean()
    assert delta.max() < 0.02, delta.max()
    for s in range(samples):
        assert seq_bf[s][0] == seq_q[s][0], (s, seq_bf[s][0], seq_q[s][0])
    out = tgate.summarize(bf, q, seq_bf, seq_q, dim, samples, clicks, 0)
    assert out["iou_delta_max"] == round(float(delta.max()), 5)
