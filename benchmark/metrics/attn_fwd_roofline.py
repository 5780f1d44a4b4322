"""attn_fwd_roofline.<kind> (%): the roofline time of the backbone's
attention forward (QK^T, softmax, PV at each block's (BH, N, Dh)) over the
device time of the kernels that did it: the program's fused and flash
entries (csrc/attention.cu) or PyTorch's SDPA kernels, whichever ran. One
launch per block call; the bound is scaled by the launches the trace kept
over the launches the traced rounds made."""
from benchmark.metrics import _counts

PATTERNS = ("attention_fwd", "flash_fwd", "fmha_", "efficient_attention",
            "attention_kernel")
EXCLUDE = ("bwd", "backward")


def read(ctx):
    t, n = ctx.trace.kernels(PATTERNS, EXCLUDE)
    if n == 0 or t <= 0:
        return None
    calls = _counts.attention_calls(ctx.cfg, ctx.model_batch)
    per_round = sum(_counts.bound(*_counts.attention(*c))[0] for c in calls)
    made = len(calls) * len(ctx.traced_rounds)
    return 100.0 * per_round * len(ctx.traced_rounds) * (n / made) / t
