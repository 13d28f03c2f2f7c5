"""Device-idle ms a traced job under no phase's program span: under only
``sweep`` or ``sweep.group``, or under no span (before the job's root span
opens, after it closes).  With the other four ``*_idle_ms_per_job`` it adds
up to ``dispatch.host_ms_per_job``."""
from perfbench import spans


def read(ctx):
    return spans.idle_ms_per_job(ctx, spans.UNSPANNED)
