"""The benchmark of the PyTorch / CUDA port on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Runs one cell of BENCHMARK.json in this process: the program's model with
weights drawn from the seed on the card, the cell's traffic mix through
its driver (benchmark/traffic/<driver>.py), the window, then the
comparison with the plain reference (benchmark/check.py). The last line of
standard output is the result: {"correct", "attempted", "failed",
"metrics", "device"[, "breakdown"], "checks"}; with --trace 0 the metrics
are the cell's end-to-end ones, with --trace 1 its per-layer ones. The
set-up split, the card's clocks and power and the round statistics go to
standard error, and the compared numbers with their limits end it.
Exits 2 without a card (or with fewer than the cell needs), 3 when a JAX
module was loaded.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Any, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import check, harness  # noqa: E402


@dataclasses.dataclass
class RunCtx:
    """One run: its cell, arguments and device, and the device calls a
    driver makes (none on the CPU, where the tests drive the harness)."""
    cell: harness.Cell
    seed: int
    seconds: float
    trace: bool
    device: Any
    clock: harness.Clock
    limits: dict
    root: Path = ROOT
    int8: bool = False
    readings: Optional[list] = None

    def log(self, *parts) -> None:
        harness.log(*parts)

    def sync(self) -> None:
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def peak(self) -> int:
        import torch
        self.sync()
        if self.device.type != "cuda":
            return 0
        return torch.cuda.max_memory_allocated(self.device)

    def empty_cache(self) -> None:
        import torch
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def make_ctx(args, device, root: Path = ROOT, t0: float = T0,
             int8: bool = False) -> RunCtx:
    cell = harness.find_cell(args.workload, root)
    return RunCtx(cell, args.seed, args.seconds, bool(args.trace), device,
                  harness.Clock(t0), check.limits(cell.name, root), root,
                  int8)


def main(argv=None) -> None:
    args = parse(argv)
    cell = harness.find_cell(args.workload, ROOT)
    device = harness.card(cell.chips)
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = make_ctx(args, device)
    ctx.clock.mark("import torch")
    driver = harness.load_driver(cell.mix, ROOT)
    result, checks = driver.run(ctx)
    harness.finish(result, checks)


if __name__ == "__main__":
    main()
