"""The program's own tracing (`pvpuformer_tpu_torch/utils/profiling.py`),
read after the traced windows; empty where the program has none."""
from __future__ import annotations

from typing import Optional


def summary() -> dict:
    try:
        from pvpuformer_tpu_torch.utils import profiling
    except ImportError:
        return {}
    read = getattr(profiling, "summary", None)
    return read() if read is not None else {}


def stage_ms(stage: str) -> Optional[float]:
    """Device ms a replayed round of the model stage `stage`, over the
    rounds replayed while no profiler recorded whose marks were read: each
    is read, with no wait, at its graph's next replay if the card has
    passed it by then (every round of the click cell, whose IoU read waits
    for the round; the last round of each chunk in the NoC cells, whose
    launches run ahead of the card). None if none was read."""
    s = summary()
    n = s.get("stage_rounds", {}).get("replayed", 0)
    ms = s.get("stage_ms", {}).get("replayed", {}).get(stage)
    return None if not n or ms is None else ms / n
