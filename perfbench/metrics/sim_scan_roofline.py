"""``sim_scan``'s share of its roofline, in %: the least time the bytes
of the traced jobs' replays need at the H100's HBM peak (the driver's
``bytes_per_job``: ``roofline.state_bytes`` over every lane at its own
tag-store size), over the profiler's time of every ``sim_scan_kernel``
launch.  The simulator does no floating-point work, so the byte bound is
the roofline."""
from perfbench import roofline

KERNEL = "sim_scan_kernel"


def read(ctx):
    per_job = getattr(ctx.job, "bytes_per_job", None)
    ns = sum(e - s for name, s, e in ctx.tl.device if KERNEL in name)
    if not ns or not ctx.n_jobs or per_job is None:
        return None
    least = roofline.least_seconds(per_job * ctx.n_jobs)
    return 100.0 * least / (ns * 1e-9)
