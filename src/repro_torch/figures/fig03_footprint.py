"""Figure 3 (motivation): how much of an activated row is actually touched.

Workloads touch only a small fraction of each activated row before it is
evicted from the row buffer (paper §3), the waste FIGCache's
segment-granularity caching recovers.  This module measures that on the
repo's own workloads: the per-visit segment-footprint CDF
(``workload.characterize``, on the host) of the numpy oracle mix and of
every device-generated scenario family (DESIGN.md §11).

Headline: ``<name>/visit_leq2``, the fraction of row activations that
touch at most 2 of the row's 8 segments.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.core import workload
from repro_torch.device import resolve_device
from repro_torch.figures import common


def collect(device=None, sizes: common.Sizes = common.FULL
            ) -> Dict[str, dict]:
    """``{workload name: characterize(trace)}``: the oracle mix of
    workload 15 and each scenario family generated on ``device``."""
    dev = resolve_device(device)
    cases = {"oracle": common.eight_trace(common.WL_IDX[100][0], sizes,
                                          dev)[0]}
    for fam, spec in common.scenario_specs(sizes).items():
        cases[fam] = common.scenario_trace(spec, sizes, dev)
    return {name: workload.characterize(tr) for name, tr in cases.items()}


def summarize(profiles: Dict[str, dict]):
    rows, summary = [], {}
    for name, prof in profiles.items():
        s = workload.summarize(prof)
        cdf = prof["visit_footprint_cdf"]
        rows.append({"workload": name, **s,
                     "cdf": [round(float(x), 4) for x in cdf]})
        summary[f"{name}/visit_leq2"] = s["visit_leq2seg"]
        summary[f"{name}/footprint"] = s["visit_footprint"]
        summary[f"{name}/row_hit_potential"] = s["row_hit_potential"]
    return rows, summary


def run(device=None, sizes: common.Sizes = common.FULL):
    return summarize(collect(device, sizes))
