"""Figure 11: system energy (and DRAM energy) normalized to Base.

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
            b = res["base"]
            for m in ("figcache_slow", "figcache_fast", "lisa_villa"):
                r = res[m]
                by.setdefault((frac, m), []).append(
                    (r.system_energy_nj / b.system_energy_nj,
                     r.dram_energy_nj / b.dram_energy_nj))
                rows.append({
                    "intensity": frac, "workload": i, "mechanism": m,
                    "system_ratio": round(r.system_energy_nj /
                                          b.system_energy_nj, 4),
                    "dram_ratio": round(r.dram_energy_nj /
                                        b.dram_energy_nj, 4),
                    **{k: round(v / 1e6, 3)
                       for k, v in r.energy_parts.items()}})
    summary = {}
    for (frac, m), v in by.items():
        summary[f"{frac}%/{m}/system"] = round(
            float(np.mean([x[0] for x in v])), 4)
        summary[f"{frac}%/{m}/dram"] = round(
            float(np.mean([x[1] for x in v])), 4)
    # paper: DRAM -7.8% (fast, 8-core avg)
    return rows, summary


def run(device=None, sizes: common.Sizes = common.FULL):
    return summarize(collect(device, sizes))
