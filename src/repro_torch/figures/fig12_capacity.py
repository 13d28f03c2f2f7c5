"""Figure 12: in-DRAM cache capacity sweep (fast subarrays 1..16).

The capacity grid of each workload is one ``simulator.sweep`` call.  The
capacity (``n_slots``) is a traced parameter under the padded FTS model
(DESIGN.md §3), so every FIGCache point shares one static group: two
replays a workload (base + figcache_fast).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import simulator
from repro_torch.core.timing import paper_config
from repro_torch.device import resolve_device
from repro_torch.figures import common

POINTS = [(1, 4), (2, 8), (4, 16), (8, 32), (16, 64)]


def configs(sizes: common.Sizes = common.FULL):
    # quick traces under-fill the cache (capacity never binds); shrink the
    # rows 4x at the quick sizes so the sweep still sees eviction pressure
    # and all five points stay distinct
    scale = 4 if sizes.quick else 1
    return [paper_config("base")] + [
        paper_config("figcache_fast", cache_rows=max(1, cr // scale))
        for _, cr in POINTS]


def collect(device=None, sizes: common.Sizes = common.FULL):
    """``{workload index: [RunResult per config]}``."""
    return common.sweep_grid(configs(sizes), sizes, resolve_device(device),
                             per_channel=sizes.long_8core)


def summarize(res):
    rows = []
    summary = {}
    sp = {n_fs: [] for n_fs, _ in POINTS}
    for r in res.values():
        base = r[0]
        for (n_fs, _), x in zip(POINTS, r[1:]):
            sp[n_fs].append(simulator.speedup(x, base))
    for n_fs, cache_rows in POINTS:
        summary[f"FS={n_fs}"] = round(float(np.mean(sp[n_fs])), 4)
        rows.append({"fast_subarrays": n_fs, "cache_rows": cache_rows,
                     "wspeedup": summary[f"FS={n_fs}"]})
    # paper: diminishing returns past 2 fast subarrays
    return rows, summary


def run(device=None, sizes: common.Sizes = common.FULL):
    return summarize(collect(device, sizes))
