"""The port stands alone: it imports neither JAX nor the JAX package, imports
without nvcc, triton or a GPU, and chip_smoke.py refuses to run (and prints
no result) where there is no CUDA device or no package beside it."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

CHECK = """
import sys
import pvpuformer_tpu_torch.inference.predictor
import pvpuformer_tpu_torch.utils.serialization
import pvpuformer_tpu_torch.ops.edt, pvpuformer_tpu_torch.ops.fused_mlp
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'pvpuformer_tpu', 'triton'))
assert not bad, bad
print('clean')
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    return env


def test_port_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", CHECK], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_cuda_or_package(tmp_path, where):
    import torch
    if where == "repo":
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: chip_smoke.py would run")
        cwd, env = REPO, _env()
    else:
        shutil.copy(REPO / "chip_smoke.py", tmp_path)
        cwd, env = tmp_path, {k: v for k, v in os.environ.items()
                              if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
