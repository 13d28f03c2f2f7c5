"""Device-idle ms a traced job under the program spans ``sweep.stack``
(scheduling, no-op padding, stacking the workloads), ``replay.init``
(``sim_init``) and ``replay.prepare`` (lane layout, trace upload, state
clone), by ``perfbench/spans.py``'s rule."""
from perfbench import spans


def read(ctx):
    return spans.idle_ms_per_job(ctx, "layout")
