"""output_ms_per_round.<kind> (ms): device ms a replayed round of the
round's output: flip merge, sigmoid, paste-back into the canvas, IoU and
the new state copied into the graph's static state: the elapsed time
from the round's `output` stage mark to the next, event-record nodes of
the captured round (`pvpuformer_tpu_torch/utils/profiling.py`), read
from the replays run while no profiler recorded, since a profiler
stretches the device's clock (`_tracing.stage_ms`)."""
from benchmark.metrics import _tracing


def read(ctx):
    return _tracing.stage_ms("output")
