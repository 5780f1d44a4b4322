"""plain_ms_per_round.<kind> (ms): device time per traced round of the
plain glue (elementwise, reductions, gathers, copies and sets of
ops/resize.py, distmaps.py, ppue.py, ops/edt.py pass 1, two_way.py, fpn.py,
seg_head.py): every device activity but the hand-written kernels and the
library products."""

NOT_PLAIN = ("attention", "fmha_", "flash_", "ln_fc1_gelu", "fc2_residual",
             "fc2_partial", "minplus", "flood_kernel", "gemm", "nvjet",
             "xmma", "cutlass", "conv", "sm90_", "sm80_")


def read(ctx):
    if not ctx.traced_rounds or not ctx.trace.device:
        return None
    t = sum((b - a) * 1e-6 for name, a, b in ctx.trace.device
            if not any(p in name for p in NOT_PLAIN))
    return 1e3 * t / len(ctx.traced_rounds)
