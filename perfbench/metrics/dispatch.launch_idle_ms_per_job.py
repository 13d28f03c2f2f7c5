"""Device-idle ms a traced job under the program span ``replay.run``
(``sim_scan``'s argument packing and launch), by ``perfbench/spans.py``'s
rule."""
from perfbench import spans


def read(ctx):
    return spans.idle_ms_per_job(ctx, "launch")
