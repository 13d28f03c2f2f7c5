"""Device-idle ms a traced job under the program span ``sweep.params``
(the config points' ``cfg.params`` and ``stack_params``): the share of
``dispatch.host_ms_per_job`` spent there, by ``perfbench/spans.py``'s rule."""
from perfbench import spans


def read(ctx):
    return spans.idle_ms_per_job(ctx, "params")
