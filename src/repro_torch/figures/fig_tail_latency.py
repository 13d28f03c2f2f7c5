"""Tail latency (beyond the paper): FIGCache against Base at p99 / p999
per scenario family.

Replays every device-generated scenario family (DESIGN.md §11) under
``base`` and ``figcache_fast`` with the §16 latency histograms on,
streamed in segments of ``CHUNK`` requests (one replay a segment), and
reports p50 / p90 / p99 / p999 per (family, mechanism) and FIGCache's
tail reduction over Base; the headline is ``<family>/p99_gain`` (> 1:
FIGCache shortens the tail).

Percentiles come from the run-cumulative read + write histogram summed
over channels and cores (``WindowCollector.cumulative``), so they cover
every retired request; each estimate's bucket bracket rides along as
``<q>_bracket_ns``.  The SLO count is the exact in-replay counter
(``MechConfig.slo_ns``).
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.core import streaming
from repro_torch.core.timing import paper_config
from repro_torch.device import resolve_device
from repro_torch.figures import common
from repro_torch.obs import latency
from repro_torch.obs.telemetry import WindowCollector

MECHS = ("base", "figcache_fast")
PERIOD = 64       # telemetry window period (real requests)
SLO_NS = 150      # exact in-replay violation threshold (ns)
CHUNK = 1024      # stream segment length (the series is chunk-invariant)


def config(mech: str):
    return paper_config(mech, telemetry=PERIOD, slo_ns=SLO_NS)


def cumulative(trace, mech: str, device) -> Dict[str, object]:
    """One (family trace, mechanism) streamed replay -> its cumulative
    planes (``hist`` (C, 2, n_cores, buckets), ``slo`` (C, n_cores))."""
    col = WindowCollector()
    streaming.simulate_stream(streaming.iter_chunks(trace, CHUNK),
                              config(mech), telemetry=col, device=device)
    return col.cumulative()


def collect(device=None, sizes: common.Sizes = common.FULL):
    """``{family: {mechanism: cumulative planes}}``."""
    dev = resolve_device(device)
    out = {}
    for fam, spec in common.scenario_specs(sizes).items():
        tr = common.scenario_trace(spec, sizes, dev)
        out[fam] = {m: cumulative(tr, m, dev) for m in MECHS}
    return out


def tail_metrics(cum) -> Dict[str, object]:
    hist = cum["hist"].sum(axis=tuple(range(cum["hist"].ndim - 1)))
    pct = latency.percentiles(hist)
    reqs = int(hist.sum())
    viol = int(cum["slo"].sum())
    out = {"requests": reqs, "slo_violations": viol,
           "slo_rate": round(viol / reqs, 6) if reqs else 0.0}
    for q, p in pct.items():
        out[f"{q}_ns"] = round(p.value, 1)
        out[f"{q}_bracket_ns"] = (int(p.lo), int(p.hi))
    return out


def summarize(cums):
    rows, summary = [], {}
    gains = []
    for fam, per_mech in cums.items():
        by_mech = {m: tail_metrics(per_mech[m]) for m in MECHS}
        for m, d in by_mech.items():
            rows.append({"family": fam, "mechanism": m, **d})
        base, fig = by_mech["base"], by_mech["figcache_fast"]
        for q in ("p99", "p999"):
            g = base[f"{q}_ns"] / max(fig[f"{q}_ns"], 1e-9)
            summary[f"{fam}/{q}_gain"] = round(g, 4)
            if q == "p99":
                gains.append(g)
        summary[f"{fam}/base_p99_ns"] = base["p99_ns"]
        summary[f"{fam}/figcache_p99_ns"] = fig["p99_ns"]
        summary[f"{fam}/figcache_slo_rate"] = fig["slo_rate"]
    summary["p99_gain_mean"] = round(float(np.mean(gains)), 4)
    return rows, summary


def run(device=None, sizes: common.Sizes = common.FULL):
    return summarize(collect(device, sizes))
