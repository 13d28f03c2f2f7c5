"""Host time a job spends outside the device: each job's wall (its
``job`` range in the profiler's trace) minus the device's busy time inside
it, averaged over the traced jobs, in ms."""
from perfbench import trace


def read(ctx):
    if not ctx.tl.jobs:
        return None
    busy = trace.busy_in_jobs(ctx.tl)
    walls = [e - s for s, e in ctx.tl.jobs]
    return sum(w - b for w, b in zip(walls, busy)) / len(walls) / 1e6
