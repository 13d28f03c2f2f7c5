"""Figure 8: 8-core weighted speedup by intensity class.

All eight multiprogrammed workload traces are stacked (W x 4 channels run
as one 32-channel batch), so the whole workloads x mechanisms grid costs
one replay per static structure (``simulator.run_eight_core_batch``).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import simulator
from repro_torch.device import resolve_device
from repro_torch.figures import common


def collect(device=None, sizes: common.Sizes = common.FULL):
    """``{workload index: {mechanism: RunResult}}`` over ``ALL_WL``, the
    batch figs 9-11 share."""
    return common.eight_core_batch(common.ALL_WL, sizes,
                                   resolve_device(device))


def summarize(batch):
    by = {}
    rows = []
    for frac, idxs in common.WL_IDX.items():
        for i in idxs:
            s = simulator.speedup_summary(batch[i])
            for m, v in s.items():
                if m != "base":
                    by.setdefault((frac, m), []).append(v)
                    rows.append({"intensity": frac, "workload": i,
                                 "mechanism": m, "wspeedup": round(v, 4)})
    summary = {f"{frac}%/{m}": round(float(np.mean(v)), 4)
               for (frac, m), v in by.items()}
    overall = {}
    for (frac, m), v in by.items():
        overall.setdefault(m, []).extend(v)
    summary.update({f"avg/{m}": round(float(np.mean(v)), 4)
                    for m, v in overall.items()})
    # paper: fast avg 1.163 (3.9/12.9/21.8/27.1 by class); slow 1.124;
    # fast - lisa ~ +4.6pp
    return rows, summary


def run(device=None, sizes: common.Sizes = common.FULL):
    return summarize(collect(device, sizes))
