"""Process start to the first timed job: imports, the kernels' build and
load, the traces, the warm-up jobs."""


def read(ctx):
    return ctx.setup_s
