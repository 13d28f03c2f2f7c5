"""``sim_scan`` launches a job makes: the program's own launch counter
(``kernels/sim_scan/sim_scan.py:COUNTER.launches``, which the driver's
``counters`` reads) over the traced jobs, divided by their number.  A
count, exactly repeatable."""


def read(ctx):
    n = ctx.counters.get("sim_scan.launches")
    if n is None or not ctx.n_jobs:
        return None
    return n / ctx.n_jobs
