"""Device-idle ms a traced job under the program spans ``sweep.to_host``
(the counters copied to the host) and ``sweep.results`` (the ``RunResult``s),
by ``perfbench/spans.py``'s rule."""
from perfbench import spans


def read(ctx):
    return spans.idle_ms_per_job(ctx, "results")
