"""Bytes copied from the host to the device a traced job: the program's
``h2d_bytes`` counter (the ``nbytes`` of each tensor that arrives), summed over
the traced jobs' spans and divided by the jobs."""
from perfbench import spans


def read(ctx):
    return spans.count_per_job(ctx, "h2d_bytes")
