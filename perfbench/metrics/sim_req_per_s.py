"""Requests simulated per second of the window: over every job completed
in it, the real (non-padding) requests of its traces times the config
points it ran, divided by the window's wall time (its start to the end of
its last job), on the host's clock."""


def read(ctx):
    if not ctx.n_jobs or ctx.window_s <= 0:
        return None
    return ctx.requests / ctx.window_s
