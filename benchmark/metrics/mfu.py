"""mfu.<kind> (%): model FLOPs of the unprofiled window's rounds (the
configuration's shapes at the round's model batch, `_counts.model_flops`)
over the window's wall time at the bf16 tensor-core peak."""
from benchmark.metrics import _counts


def read(ctx):
    if ctx.rounds <= 0 or ctx.window_s <= 0:
        return None
    flops = _counts.model_flops(ctx.cfg, ctx.model_batch) * ctx.rounds
    return 100.0 * flops / (ctx.window_s * _counts.PEAK_BF16)
