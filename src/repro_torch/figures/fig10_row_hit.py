"""Figure 10: DRAM row-buffer hit rate (the co-location effect).

Reads the stacked-trace batch of fig 8 (cached).
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
            for m in ("base", "lisa_villa", "figcache_slow", "figcache_fast"):
                by.setdefault((frac, m), []).append(res[m].row_hit_rate)
                rows.append({"intensity": frac, "workload": i, "mechanism": m,
                             "row_hit": round(res[m].row_hit_rate, 4)})
    summary = {f"{frac}%/{m}": round(float(np.mean(v)), 4)
               for (frac, m), v in by.items()}
    # paper: FIGCache ~+18pp over LISA-VILLA; LISA == base
    return rows, summary


def run(device=None, sizes: common.Sizes = common.FULL):
    return summarize(collect(device, sizes))
