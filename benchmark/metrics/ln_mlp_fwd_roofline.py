"""ln_mlp_fwd_roofline.<kind> (%): the roofline time of the backbone's
LayerNorm + fc1 + GELU + fc2 + residual at (M, D, H) over the device time
of the program's two launches per call (csrc/fused_mlp.cu: ln_fc1_gelu,
fc2_residual), the bound scaled by the launches the trace kept."""
from benchmark.metrics import _counts

PATTERNS = ("ln_fc1_gelu", "fc2_residual")


def read(ctx):
    t, n = ctx.trace.kernels(PATTERNS)
    if n == 0 or t <= 0:
        return None
    calls = _counts.ln_mlp_calls(ctx.cfg, ctx.model_batch)
    per_round = sum(_counts.bound(*_counts.ln_mlp(*c))[0] for c in calls)
    made = 2 * len(calls) * len(ctx.traced_rounds)
    return 100.0 * per_round * len(ctx.traced_rounds) * (n / made) / t
