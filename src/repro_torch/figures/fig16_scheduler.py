"""Figure 16 (beyond the paper): controller-policy sensitivity of FIGCache.

Each grid point runs Base and FIGCache-Fast under the same
``timing.SchedConfig`` (FCFS, FR-FCFS at queue depths 8 / 16 / 32, and
FR-FCFS with write-drain batching) and reports the weighted speedup of
FIGCache over Base under that controller, with Base's row-buffer hit rate
(the controller's own contribution).

Scheduling is a host-side trace permutation (DESIGN.md §10), done once a
controller; ``simulator.sweep`` groups by (static structure, controller),
so the grid is ten replays a workload.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import simulator
from repro_torch.core.timing import SchedConfig, paper_config
from repro_torch.device import resolve_device
from repro_torch.figures import common

SCHEDS = [
    ("fcfs", SchedConfig()),
    ("frfcfs_qd8", SchedConfig("frfcfs", queue_depth=8)),
    ("frfcfs_qd16", SchedConfig("frfcfs", queue_depth=16)),
    ("frfcfs_qd32", SchedConfig("frfcfs", queue_depth=32)),
    ("frfcfs_qd16_drain", SchedConfig("frfcfs", queue_depth=16,
                                      write_drain=True, drain_batch=16)),
]


def configs(sizes: common.Sizes = common.FULL):
    cfgs = []
    for _, sc in SCHEDS:
        cfgs.append(paper_config("base", sched=sc))
        cfgs.append(paper_config("figcache_fast", sched=sc))
    return cfgs


def collect(device=None, sizes: common.Sizes = common.FULL):
    """``{workload index: [RunResult per config]}``."""
    return common.sweep_grid(configs(sizes), sizes, resolve_device(device),
                             per_channel=sizes.long_8core)


def summarize(res):
    rows, summary = [], {}
    sp = {name: [] for name, _ in SCHEDS}
    base_rh = {name: [] for name, _ in SCHEDS}
    for r in res.values():
        for k, (name, _) in enumerate(SCHEDS):
            base, fig = r[2 * k], r[2 * k + 1]
            sp[name].append(simulator.speedup(fig, base))
            base_rh[name].append(base.row_hit_rate)
    for name, sc in SCHEDS:
        summary[name] = round(float(np.mean(sp[name])), 4)
        rows.append({
            "sched": name,
            "policy": sc.policy,
            "queue_depth": sc.queue_depth,
            "write_drain": sc.write_drain,
            "figcache_wspeedup": summary[name],
            "base_row_hit": round(float(np.mean(base_rh[name])), 4),
        })
    # expected: FIGCache's edge narrows (but persists) as the controller
    # recovers more row locality on its own
    return rows, summary


def run(device=None, sizes: common.Sizes = common.FULL):
    return summarize(collect(device, sizes))
