"""Figure 9: in-DRAM cache hit rates (LISA-VILLA vs FIGCache-Slow/Fast).

Reads the stacked-trace batch of fig 8 (``common.eight_core_batch``,
cached: no replay after fig 8).
"""
from __future__ import annotations

import numpy as np

from repro_torch.figures import common
from repro_torch.figures.fig08_eight_core import collect


def summarize(batch):
    by = {}
    rows = []
    for frac, idxs in common.WL_IDX.items():
        for i in idxs:
            res = batch[i]
            for m in ("lisa_villa", "figcache_slow", "figcache_fast"):
                by.setdefault((frac, m), []).append(res[m].cache_hit_rate)
                rows.append({"intensity": frac, "workload": i, "mechanism": m,
                             "cache_hit": round(res[m].cache_hit_rate, 4)})
    summary = {f"{frac}%/{m}": round(float(np.mean(v)), 4)
               for (frac, m), v in by.items()}
    return rows, summary


def run(device=None, sizes: common.Sizes = common.FULL):
    return summarize(collect(device, sizes))
