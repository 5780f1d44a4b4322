"""device_idle.<kind> (%): the share of the host-clock time of the traced
work, run unprofiled, in which no kernel, copy or set ran on the card:
1 - (union of the device intervals in a trace of the device's activity
alone) / (the same rounds or calls timed on the host without the
profiler). Tracing stretches the host's part of each round (CUPTI's
records of every launch), so the traced window itself (`window_s`) would
overstate the idle share where the host paces the rounds."""


def read(ctx):
    tr = ctx.trace
    if ctx.plain_s <= 0 or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s / ctx.plain_s)
