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
import pvpuformer_tpu_torch.ops.cc, pvpuformer_tpu_torch.ops.rasterize
import pvpuformer_tpu_torch.engine.prompt_sim
import pvpuformer_tpu_torch.engine.losses, pvpuformer_tpu_torch.engine.metrics
import pvpuformer_tpu_torch.engine.optimizer
import pvpuformer_tpu_torch.engine.train_step
import pvpuformer_tpu_torch.engine.trainer
import pvpuformer_tpu_torch.inference.batched
import pvpuformer_tpu_torch.inference.graphs
import pvpuformer_tpu_torch.inference.clicker
import pvpuformer_tpu_torch.inference.datasets
import pvpuformer_tpu_torch.inference.evaluation
import pvpuformer_tpu_torch.utils.exp, pvpuformer_tpu_torch.evaluate
import pvpuformer_tpu_torch.data, pvpuformer_tpu_torch.data.transforms
import pvpuformer_tpu_torch.data.scribbles, pvpuformer_tpu_torch.data.loader
import pvpuformer_tpu_torch.train, pvpuformer_tpu_torch.utils.torch_ingest
import pvpuformer_tpu_torch.utils.vis
import pvpuformer_tpu_torch.recipes.iSegNet.vpu_base448_cocolvis
import pvpuformer_tpu_torch.recipes.iSegNet.vpu_large448_cocolvis
import pvpuformer_tpu_torch.recipes.iSegNet.vpu_huge448_cocolvis
import pvpuformer_tpu_torch.recipes.iSegNet.vpu_tiny_synthetic
import pvpuformer_tpu_torch.inference.brs
import pvpuformer_tpu_torch.inference.controller
import pvpuformer_tpu_torch.serve, pvpuformer_tpu_torch.demo
import pvpuformer_tpu_torch.demo_widgets
import pvpuformer_tpu_torch.models.registry
import pvpuformer_tpu_torch.models.plainvit
import pvpuformer_tpu_torch.models.zoo.common
import pvpuformer_tpu_torch.models.zoo.hrnet
import pvpuformer_tpu_torch.models.zoo.deeplab
import pvpuformer_tpu_torch.models.zoo.segformer
import pvpuformer_tpu_torch.models.zoo.swin
import pvpuformer_tpu_torch.models.zoo.hrformer
import pvpuformer_tpu_torch.models.zoo.swin_unet
import pvpuformer_tpu_torch.inference.tiled
import pvpuformer_tpu_torch.parallel.dist
import pvpuformer_tpu_torch.parallel.mesh
import pvpuformer_tpu_torch.parallel.tp
import pvpuformer_tpu_torch.native
import pvpuformer_tpu_torch.utils.profiling
import pvpuformer_tpu_torch.inference.sam_compat
import pvpuformer_tpu_torch.gate_int8
import pvpuformer_tpu_torch.models.zoo.clip_text
import pvpuformer_tpu_torch.models.decoder
import pvpuformer_tpu_torch.prepare_data, pvpuformer_tpu_torch.hbm_fit
import pvpuformer_tpu_torch.demo_train_eval_synthetic
import pvpuformer_tpu_torch.bench_loader
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'pvpuformer_tpu', 'triton',
                                    'tkinter', 'demo', 'demo_widgets',
                                    'scripts'))
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


DATA_CHECK = """
import sys
import pvpuformer_tpu_torch.data
from pvpuformer_tpu_torch.data import (CocoLvisDataset, ImageDirTrainDataset,
                                       Loader, SBDTrainDataset, scribbles,
                                       transforms)
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('torch', 'jax', 'jaxlib', 'pvpuformer_tpu'))
assert not bad, bad
print('numpy only')
"""


def test_data_pipeline_imports_no_torch():
    """The data package's workers may fork from a trainer that holds a CUDA
    context: they must not touch torch."""
    out = subprocess.run([sys.executable, "-c", DATA_CHECK], cwd=REPO,
                         env=_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "numpy only"


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
