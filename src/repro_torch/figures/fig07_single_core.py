"""Figure 7: single-core speedups over Base, by memory intensity.

All six app traces are stacked along the (independent) channel axis, so
the whole apps x mechanisms cross product runs as one replay per static
structure (``simulator.run_single_core_batch``).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import simulator, traces
from repro_torch.device import resolve_device
from repro_torch.figures import common

APPS = ["mcf", "libquantum", "lbm", "gcc", "sjeng", "tpch2"]


def collect(device=None, sizes: common.Sizes = common.FULL):
    """``{app: {mechanism: RunResult}}``."""
    return common.single_core_batch(tuple(APPS), sizes,
                                    resolve_device(device))


def summarize(batch):
    rows = []
    per_mech = {}
    for app in APPS:
        s = simulator.speedup_summary(batch[app])
        cls = "intensive" if app in traces.INTENSIVE else "non-intensive"
        for m, v in s.items():
            if m == "base":
                continue
            per_mech.setdefault((cls, m), []).append(v)
            rows.append({"app": app, "class": cls, "mechanism": m,
                         "speedup": round(v, 4)})
    summary = {f"{c}/{m}": round(float(np.mean(v)), 4)
               for (c, m), v in per_mech.items()}
    # paper: +16.1% intensive / +1.5% non-intensive for FIGCache-Fast
    return rows, summary


def run(device=None, sizes: common.Sizes = common.FULL):
    return summarize(collect(device, sizes))
