"""Scenario sensitivity (beyond the paper): caching benefit by access
pattern.

Sweeps the mechanism set across every device-generated scenario family
(DESIGN.md §11) in one ``simulator.sweep_traces`` call: the specs are
generated on the device by one ``workload.generate_many``, stacked along
the channel axis, and each mechanism is one replay for the whole workload
axis.
"""
from __future__ import annotations

from repro_torch.core import simulator
from repro_torch.device import resolve_device
from repro_torch.figures import common

MECHS = ("base", "lisa_villa", "figcache_fast", "figcache_ideal", "lldram")


def collect(device=None, sizes: common.Sizes = common.FULL):
    """``{family: [RunResult per mechanism of MECHS]}``."""
    specs = common.scenario_specs(sizes)
    res = simulator.sweep_traces(list(specs.values()),
                                 simulator.mech_grid(MECHS, None),
                                 device=resolve_device(device))
    return dict(zip(specs, res))


def summarize(res):
    rows, summary = [], {}
    for fam, per_cfg in res.items():
        s = simulator.speedup_summary(dict(zip(MECHS, per_cfg)))
        for m, v in s.items():
            if m == "base":
                continue
            rows.append({"family": fam, "mechanism": m,
                         "speedup": round(v, 4)})
            summary[f"{fam}/{m}"] = round(v, 4)
    return rows, summary


def run(device=None, sizes: common.Sizes = common.FULL):
    return summarize(collect(device, sizes))
