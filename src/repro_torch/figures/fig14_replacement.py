"""Figure 14: replacement policy sweep (RowBenefit vs SegmentBenefit, LRU
and Random), on the longer traces with a small cache so that eviction
pressure is real.

The policy is a static branch, so the grid is five static groups (base
and one per policy): five replays a workload.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import simulator
from repro_torch.core.timing import paper_config
from repro_torch.device import resolve_device
from repro_torch.figures import common

POLICIES = ("row_benefit", "segment_benefit", "lru", "random")


def configs(sizes: common.Sizes = common.FULL):
    return [paper_config("base")] + [
        paper_config("figcache_fast", policy=pol, cache_rows=4)
        for pol in POLICIES]   # cache_rows=4: real eviction pressure


def collect(device=None, sizes: common.Sizes = common.FULL):
    """``{workload index: [RunResult per config]}``."""
    return common.sweep_grid(configs(sizes), sizes, resolve_device(device),
                             per_channel=sizes.long_8core)


def summarize(res):
    rows = []
    summary = {}
    sp = {pol: [] for pol in POLICIES}
    for r in res.values():
        base = r[0]
        for pol, x in zip(POLICIES, r[1:]):
            sp[pol].append(simulator.speedup(x, base))
    for pol in POLICIES:
        summary[pol] = round(float(np.mean(sp[pol])), 4)
        rows.append({"policy": pol, "wspeedup": summary[pol]})
    return rows, summary


def run(device=None, sizes: common.Sizes = common.FULL):
    return summarize(collect(device, sizes))
