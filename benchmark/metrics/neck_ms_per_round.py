"""neck_ms_per_round.<kind> (ms): device ms a replayed round of the neck:
PPuE prompt vectors, the DMA two-way transformer and the FPN branches:
the elapsed time from the round's `neck` stage mark to the next, event-
record nodes of the captured round
(`pvpuformer_tpu_torch/utils/profiling.py`), read from the replays run
while no profiler recorded, since a profiler stretches the device's
clock (`_tracing.stage_ms`)."""
from benchmark.metrics import _tracing


def read(ctx):
    return _tracing.stage_ms("neck")
