"""Device time of one ``sim_scan`` step in each job's longest launch: the
profiler's time of the longest ``sim_scan_kernel`` launch inside each
traced job, divided by the steps it replayed (the driver's
``steps_per_launch``, the trace length), averaged over the jobs, in us.

The longest launch is the one a faster step shortens most: the widest
replay (design-sweep's 800 lanes) or a cached group (the FTS lookup on
every step).  Taking it alone keeps a cacheless or narrow launch of the
same job from diluting the reading."""
import bisect

KERNEL = "sim_scan_kernel"


def read(ctx):
    T = getattr(ctx.job, "steps_per_launch", None)
    kernels = [(s, e) for name, s, e in ctx.tl.device if KERNEL in name]
    if not kernels or not T:
        return None
    starts = [s for s, _ in kernels]
    longest = []
    for lo, hi in ctx.tl.jobs:
        inside = kernels[bisect.bisect_left(starts, lo):
                         bisect.bisect_left(starts, hi)]
        if inside:
            longest.append(max(e - s for s, e in inside))
    if not longest:
        return None
    return sum(longest) / len(longest) / T / 1e3
