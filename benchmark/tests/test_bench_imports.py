"""What the benchmark imports: nothing of JAX or the JAX package anywhere
it runs, and nothing of the program in the plain reference. Top-level
module names are compared whole: `pvpuformer_tpu_torch` is the program,
`pvpuformer_tpu` the JAX package."""
from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "pvpuformer_tpu"}


def _fresh(code: str) -> dict:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _top(names) -> set:
    return {n.split(".", 1)[0] for n in names}


def test_a_run_of_each_driver_loads_no_jax_module(tmp_path):
    mods = _fresh(f"""
import sys, json, torch
torch.set_num_threads(2)
sys.path.insert(0, {str(ROOT)!r})
from pathlib import Path
from benchmark.tests.tiny import tiny_root, run_cell
root = tiny_root(Path({str(tmp_path)!r}))
for cell in ("tiny_click", "tiny_noc"):
    res, checks, ctx = run_cell(root, cell, seconds=0.2)
    assert res["correct"], (cell, checks)
import benchmark.control, benchmark.run
print(json.dumps(sorted(sys.modules)))
""")
    assert "pvpuformer_tpu_torch" in _top(mods)      # the program ran
    assert not (_top(mods) & FORBIDDEN), sorted(_top(mods) & FORBIDDEN)


def test_the_reference_imports_nothing_of_the_program():
    mods = _fresh(f"""
import sys, json, torch
sys.path.insert(0, {str(ROOT)!r})
from benchmark.reference import rounds, vpu
from benchmark import check
print(json.dumps(sorted(sys.modules)))
""")
    assert not (_top(mods) & (FORBIDDEN | {"pvpuformer_tpu_torch"}))


def test_no_benchmark_source_names_jax_or_the_jax_package():
    """A static look too: no import statement under benchmark/ names a
    forbidden top-level module, and none under reference/ the program."""
    for path in (ROOT / "benchmark").rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            else:
                continue
            top = _top(names)
            assert not (top & FORBIDDEN), (path, names)
            if path.parent.name == "reference":
                assert "pvpuformer_tpu_torch" not in top, (path, names)
