"""host_ms_per_round.<kind> (ms): the program's own host time a replayed
round, from its spans in calls that ran no eager or captured round and no
profiler, over the rounds those calls ran. One rule in both kinds: the
outermost call (`predictor.round` for click, `batched.evaluate` for NoC)
less its host reads (`predictor.read`, `batched.read`), which wait for
the card, and less the graph launches (`graphs.replay`): the CUDA
driver's cost of a graph of many kernels, which in a batched chunk also
blocks while the stream holds the chunk's earlier rounds. In a batched chunk
the copies and clones around a launch (`graphs.prepare`,
`graphs.finish`) can block the same way and are left in."""
from benchmark.metrics import _tracing

CALLS = ("predictor.round", "batched.evaluate")
WAITS = ("predictor.read", "batched.read", "graphs.replay")


def read(ctx):
    s = _tracing.summary()
    spans = s.get("spans", {}).get("replayed", {})
    n = s.get("rounds", {}).get("replayed", 0)
    for call in CALLS:
        if call in spans and n:
            waited = sum(spans.get(w, {}).get("total_ms", 0.0)
                         for w in WAITS)
            return (spans[call]["total_ms"] - waited) / n
    return None
