"""Figure 15: insertion-threshold sweep (1, insert on any miss, is best).

The insertion threshold is a traced parameter (DESIGN.md §3), so all four
thresholds share one static group: two replays a workload.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import simulator
from repro_torch.core.timing import paper_config
from repro_torch.device import resolve_device
from repro_torch.figures import common

THRESHOLDS = (1, 2, 4, 8)


def configs(sizes: common.Sizes = common.FULL):
    return [paper_config("base")] + [
        paper_config("figcache_fast", insert_threshold=th)
        for th in THRESHOLDS]


def collect(device=None, sizes: common.Sizes = common.FULL):
    """``{workload index: [RunResult per config]}``."""
    return common.sweep_grid(configs(sizes), sizes, resolve_device(device))


def summarize(res):
    rows = []
    summary = {}
    sp = {th: [] for th in THRESHOLDS}
    for r in res.values():
        base = r[0]
        for th, x in zip(THRESHOLDS, r[1:]):
            sp[th].append(simulator.speedup(x, base))
    for th in THRESHOLDS:
        summary[f"th={th}"] = round(float(np.mean(sp[th])), 4)
        rows.append({"threshold": th, "wspeedup": summary[f"th={th}"]})
    return rows, summary


def run(device=None, sizes: common.Sizes = common.FULL):
    return summarize(collect(device, sizes))
