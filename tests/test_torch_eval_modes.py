"""The port's evaluation CLI in the modes it gained with the serving
slice, against the JAX package's scripts/evaluate.py on one JAX-format
checkpoint (tiny config, f32, Synthetic, 3 clicks): f-BRS-B, and NoBRS
with --int8, one session at a time and --batched 2.

Tolerances: the same NoC cells; per-click IoU within 1e-3 for f-BRS-B (the
BRS session tolerance of tests/test_torch_brs.py) and 5e-3 for --int8 (the
int8 session noise of tests/test_torch_quant.py)."""
import pickle
import sys

import jax
import numpy as np
import pytest

from pvpuformer_tpu.utils.serialization import save_checkpoint
from pvpuformer_tpu_torch import evaluate as cli
from test_torch_eval import _jax_cli, eval_weights
from test_torch_eval import two_torch_threads  # noqa: F401 (autouse)

CLICKS = 3


def _noc_cells(out: str, mode: str):
    """The results row's NoC cells (not its SPC and Time cells)."""
    row = next(line for line in out.splitlines()
               if line.startswith("|") and f" {mode} " in line)
    return row.split("|")[1:-3]


@pytest.mark.parametrize("mode,extra,tol", [
    ("f-BRS-B", [], 1e-3), ("NoBRS", ["--int8"], 5e-3),
    ("NoBRS", ["--int8", "--batched", "2"], 5e-3)])
def test_cli_modes_match_jax_cli(tmp_path, capsys, monkeypatch, mode, extra,
                                 tol):
    params, jcfg, _ = eval_weights()
    ckpt = tmp_path / "tiny.npz"
    save_checkpoint(ckpt, params, jcfg)
    common = [mode, "--checkpoint", str(ckpt), "--datasets", "Synthetic",
              "--limit", "2", "--n-clicks", str(CLICKS), "--dtype",
              "float32", "--save-ious"] + extra
    monkeypatch.setattr(sys, "argv", ["evaluate.py"] + common + [
        "--logs-path", str(tmp_path / "jax")])
    with jax.default_matmul_precision("highest"):
        _jax_cli().main()
    want = capsys.readouterr().out
    cli.main(common + ["--device", "cpu", "--logs-path",
                       str(tmp_path / "port")])
    got = capsys.readouterr().out
    assert _noc_cells(got, mode) == _noc_cells(want, mode)
    assert ("throughput:" in got) == ("--batched" in extra)
    name = f"Synthetic_cvpr_{mode}_{CLICKS}.pickle"
    res = [pickle.load(open(tmp_path / side / name, "rb"))
           for side in ("port", "jax")]
    assert len(res[0]["all_ious"]) == len(res[1]["all_ious"]) == 2
    for a, b in zip(res[0]["all_ious"], res[1]["all_ious"]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=tol)
