"""minplus_roofline.<kind> (%): the byte bound of the EDT oracle's row pass
(both error masks of every session, canvas rows x canvas width, f32 in and
out) over the device time of the program's min-plus kernel
(csrc/edt_minplus.cu), one launch a round; scaled by the launches kept."""
from benchmark.metrics import _counts

PATTERNS = ("minplus",)


def read(ctx):
    t, n = ctx.trace.kernels(PATTERNS)
    if n == 0 or t <= 0 or not ctx.traced_rounds:
        return None
    total = sum(_counts.bound(*_counts.minplus(2 * b * h, w))[0]
                for h, w, b in ctx.traced_rounds)
    return 100.0 * total * (n / len(ctx.traced_rounds)) / t
