"""Latency-distribution extraction from the §16 histogram planes, PyTorch
port of ``repro.obs.latency`` (numpy only).

The in-replay side (``dram._telemetry_step``, and the ``sim_scan`` kernel
on the card) buckets every real request's exact latency by bit length:
bucket 0 holds ``lat_ns == 0``, bucket ``b >= 1`` holds ``lat_ns`` in
``[2**(b-1), 2**b - 1]``.  This module is the host-side mirror: bucket
bounds, percentile extraction with an EXPLICIT resolution bound, CDF
export, per-window tail series and SLO summaries.

Percentiles are exact at bucket granularity: for mass ``N`` and quantile
``q``, the nearest-rank order statistic (rank ``ceil(q * N)``) provably
lies inside one bucket ``[lo, hi]`` — the returned ``Percentile`` carries
that bracket, and the point estimate interpolates linearly within it.
The resolution bound is therefore the bucket width (a factor of 2 in
latency), never a statistical guess: any exact-sort oracle over the same
latencies lands inside the same bracket (``tests/test_torch_obs.py``
pins this).  Over-SLO request counts do NOT come from buckets at all —
they are counted per request in the replay against
``MechParams.slo_ns``.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Sequence, Tuple

import numpy as np

from repro_torch.core.dram import HIST_BUCKETS

__all__ = ["QS", "Percentile", "bucket_bounds", "bucket_index",
           "percentile", "percentiles", "tail_series", "core_tails",
           "cdf", "cdf_csv", "slo_summary"]

# the report quantiles: p50 / p90 / p99 / p999
QS: Tuple[float, ...] = (0.5, 0.9, 0.99, 0.999)


def _qname(q: float) -> str:
    return "p" + format(100 * q, "g").replace(".", "")


def bucket_bounds(n: int = HIST_BUCKETS) -> Tuple[np.ndarray, np.ndarray]:
    """Inclusive ``[lo, hi]`` latency bounds (ns) of each log2 bucket."""
    b = np.arange(n)
    lo = np.where(b == 0, 0, 1 << np.maximum(b - 1, 0)).astype(np.int64)
    hi = np.where(b == 0, 0, (1 << b) - 1).astype(np.int64)
    return lo, hi


def bucket_index(lat_ns) -> np.ndarray:
    """Host mirror of ``dram.hist_bucket``: bit length, clipped."""
    lat = np.maximum(np.asarray(lat_ns, np.int64), 0)
    bits = np.where(lat > 0, np.floor(np.log2(np.maximum(lat, 1))) + 1, 0)
    return np.minimum(bits.astype(np.int64), HIST_BUCKETS - 1)


class Percentile(NamedTuple):
    """One extracted percentile: interpolated point estimate plus the
    EXACT bucket bracket the true order statistic lies in.  ``hi - lo``
    is the declared resolution; ``value`` is always inside ``[lo, hi]``.
    NaN/zeros when the histogram is empty."""
    q: float
    value: float
    lo: int
    hi: int


def percentile(hist, q: float) -> Percentile:
    """Extract one quantile from a 1-D bucket histogram.

    Nearest-rank semantics: the target is the ``ceil(q * N)``-th smallest
    latency (1-based), located exactly by the bucket CDF; the point
    estimate places it uniformly within its bucket."""
    h = np.asarray(hist, np.int64)
    assert h.ndim == 1, h.shape
    n = int(h.sum())
    if n == 0:
        return Percentile(q, float("nan"), 0, 0)
    lo, hi = bucket_bounds(h.shape[0])
    cum = np.cumsum(h)
    k = min(max(int(np.ceil(q * n)), 1), n)       # 1-based target rank
    b = int(np.searchsorted(cum, k, side="left"))
    prev = int(cum[b - 1]) if b else 0
    frac = (k - prev - 0.5) / int(h[b])           # mid-rank within bucket
    val = float(lo[b]) + frac * float(hi[b] - lo[b])
    return Percentile(q, val, int(lo[b]), int(hi[b]))


def percentiles(hist, qs: Sequence[float] = QS) -> Dict[str, Percentile]:
    """``{"p50": Percentile, "p90": ..., ...}`` for one histogram."""
    return {_qname(q): percentile(hist, q) for q in qs}


def tail_series(series: Dict[str, np.ndarray],
                qs: Sequence[float] = QS) -> Dict[str, np.ndarray]:
    """Per-window percentile series from a collector's ``w_hist`` rows.

    Returns float arrays keyed ``p50_ns``/... (NaN for empty windows),
    aligned with the collector's other per-window series."""
    wh = np.asarray(series["w_hist"], np.int64)
    out = {}
    for q in qs:
        out[_qname(q) + "_ns"] = np.array(
            [percentile(row, q).value for row in wh], np.float64)
    return out


def core_tails(hist, qs: Sequence[float] = QS) -> Dict[str, np.ndarray]:
    """Per-core percentile estimates from the cumulative ``(2, n_cores,
    HIST_BUCKETS)`` plane pair (reads + writes combined)."""
    h = np.asarray(hist, np.int64).sum(axis=0)
    return {_qname(q) + "_ns": np.array(
        [percentile(row, q).value for row in h], np.float64) for q in qs}


def cdf(hist) -> Tuple[np.ndarray, np.ndarray]:
    """(upper bucket edge, cumulative fraction) of a 1-D histogram."""
    h = np.asarray(hist, np.int64)
    _, hi = bucket_bounds(h.shape[0])
    n = max(int(h.sum()), 1)
    return hi, np.cumsum(h) / n


def cdf_csv(hists: Dict[str, np.ndarray]) -> str:
    """CSV of one CDF column per named histogram (shared bucket edges)."""
    names = list(hists)
    edges = None
    cols = {}
    for name in names:
        e, c = cdf(hists[name])
        edges, cols[name] = e, c
    lines = ["lat_ns_hi," + ",".join(names)]
    for i, e in enumerate(edges):
        lines.append(f"{int(e)}," +
                     ",".join(f"{cols[n][i]:.6g}" for n in names))
    return "\n".join(lines) + "\n"


def slo_summary(series: Dict[str, np.ndarray],
                slo_ns: int) -> Dict[str, float]:
    """Exact over-SLO accounting from the per-window ``w_slo`` counts.

    ``violations`` sums the in-scan per-request comparisons (never a
    bucket estimate); ``rate`` is NaN when no requests were seen."""
    reqs = int(np.asarray(series["w_reqs"], np.int64).sum())
    viol = int(np.asarray(series["w_slo"], np.int64).sum())
    return {"slo_ns": float(slo_ns), "requests": float(reqs),
            "violations": float(viol),
            "rate": viol / reqs if reqs else float("nan")}
