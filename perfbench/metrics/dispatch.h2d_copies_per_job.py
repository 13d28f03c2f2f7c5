"""Copies from the host to the device a traced job makes: the program's
``h2d_copies`` counter, counted at each copy site and kept in the E records
of the traced jobs' spans, summed over them and divided by the jobs."""
from perfbench import spans


def read(ctx):
    return spans.count_per_job(ctx, "h2d_copies")
