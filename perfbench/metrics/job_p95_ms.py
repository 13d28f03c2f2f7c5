"""95th percentile of the wall time of every job in the window (from the
call to its results on the host), in ms, on the host's clock."""
import numpy as np


def read(ctx):
    if not ctx.walls_s:
        return None
    return float(np.percentile(np.asarray(ctx.walls_s) * 1e3, 95))
