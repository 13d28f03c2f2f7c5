"""Share of the traced window (first job's start to last job's end) in
which no kernel, copy or fill ran on the device."""
from perfbench import trace


def read(ctx):
    if not ctx.tl.jobs:
        return None
    lo, hi = ctx.tl.window
    return 1.0 - trace.busy_ns(ctx.tl, lo, hi) / (hi - lo)
