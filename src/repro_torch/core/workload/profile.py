"""Trace characterization: the stats workloads are *about* (paper §3, §7).
PyTorch port of ``repro.core.workload.profile``: the same numpy, over host
copies of the port's traces (numpy or tensor leaves on any device).

``characterize`` reduces a ``dram.Trace`` to the access-pattern statistics
the mechanisms are sensitive to — the same quantities the paper uses to
motivate fine-grained caching (§3: only a small fraction of an activated
row is touched) and to classify workloads (§7, Table 2):

 * **per-visit segment footprint** — of each row activation window (a
   maximal run of same-row requests on one bank), how many of the row's
   segments were touched; its CDF is the Fig.-3-style motivational stat;
 * **lifetime footprint** — unique segments each (bank, row) ever touches;
 * **row-visit run length** and **row-hit potential** — the fraction of
   requests an FR-FCFS row buffer could serve open (``(len-1)/len`` summed
   over runs);
 * **reuse distance** — request-distance between consecutive touches of
   the same (bank, row), log2-bucketed (temporal reuse, not stack
   distance — cheap and monotone in it);
 * **bank-level parallelism** — mean distinct banks per 32-request window;
 * **write fraction / per-channel balance / arrival intensity.**

Everything is plain numpy over host copies: characterization is an
offline validation/figure tool, not a hot path.  No-op padding requests
(``t_issue >= dram.NOOP_ISSUE``) are dropped before any statistic.

Used by ``tests/test_torch_workload.py`` to pin every generator family to
its target stats (and the device zipf_reuse port to the numpy oracle).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from repro_torch.core import dram
from repro_torch.core.dram import host_array
from repro_torch.core.timing import GEOM, TICKS_PER_NS

BLP_WINDOW = 32          # requests per bank-level-parallelism window
REUSE_BUCKETS = 20       # log2 buckets of the reuse-distance histogram


def _channels(trace: dram.Trace):
    """Host views per channel, no-op padding dropped."""
    t = host_array(trace.t_issue)
    leaves = [host_array(x) for x in
              (trace.t_issue, trace.bank, trace.row, trace.col,
               trace.is_write, trace.core)]
    if t.ndim == 1:
        leaves = [x[None] for x in leaves]
    out = []
    for c in range(leaves[0].shape[0]):
        real = leaves[0][c] < dram.NOOP_ISSUE
        out.append(tuple(x[c][real] for x in leaves))
    return out


def _run_ids(x: np.ndarray) -> np.ndarray:
    """0-based id of each element's maximal equal-value run."""
    if x.size == 0:
        return np.zeros(0, np.int64)
    return np.concatenate([[0], np.cumsum(x[1:] != x[:-1])])


def _uniques_per_group(group: np.ndarray, value: np.ndarray) -> np.ndarray:
    """Count of distinct ``value`` entries within each ``group`` id
    (groups need not be contiguous).  Vectorized via unique pairs."""
    if group.size == 0:
        return np.zeros(0, np.int64)
    pairs = np.unique(np.stack([group, value], axis=1), axis=0)
    return np.bincount(pairs[:, 0], minlength=int(group.max()) + 1)


def characterize(trace: dram.Trace, seg_blocks: int = 16,
                 apps: Optional[Sequence] = None,
                 geom=GEOM) -> Dict[str, object]:
    """Reduce a trace ((T,) or (C, T) leaves) to its access-pattern stats.

    ``seg_blocks`` sets the footprint granularity (16 blocks = the default
    FIGCache segment, 1/8 row).  ``apps`` (AppParams per core) adds the
    model-side MPKI so intensity is reported in the paper's unit.
    """
    spr = geom.row_blocks // seg_blocks
    chans = _channels(trace)
    n_total = sum(c[0].size for c in chans)
    run_lens, visit_fp, life_fp = [], [], []
    reuse_hist = np.zeros(REUSE_BUCKETS, np.int64)
    row_hits = 0
    blp_counts, writes = [], 0
    gaps = []

    for (t, bank, row, col, wr, core) in chans:
        writes += int(wr.sum())
        if t.size > 1:
            gaps.append(np.diff(np.sort(t.astype(np.int64))))
        if t.size >= BLP_WINDOW:
            win = bank[: t.size - t.size % BLP_WINDOW].reshape(-1, BLP_WINDOW)
            sw = np.sort(win, axis=1)
            blp_counts.append(1 + (sw[:, 1:] != sw[:, :-1]).sum(axis=1))
        for b in range(geom.n_banks):
            m = bank == b
            if not m.any():
                continue
            rows_b, segs_b = row[m], col[m] // seg_blocks
            # row visits: maximal same-row runs in this bank's service order
            rid = _run_ids(rows_b)
            lens = np.bincount(rid)
            run_lens.append(lens)
            row_hits += int((lens - 1).sum())
            visit_fp.append(_uniques_per_group(rid, segs_b))
            life_fp.append(_uniques_per_group(
                np.unique(rows_b, return_inverse=True)[1], segs_b))
            # reuse distance: request-gap between touches of the same row
            order = np.argsort(rows_b, kind="stable")
            rs, pos = rows_b[order], np.arange(rows_b.size)[order]
            same = rs[1:] == rs[:-1]
            d = (pos[1:] - pos[:-1])[same]
            if d.size:
                b_idx = np.minimum(np.log2(d).astype(np.int64),
                                   REUSE_BUCKETS - 1)
                reuse_hist += np.bincount(b_idx, minlength=REUSE_BUCKETS)

    run_lens = np.concatenate(run_lens) if run_lens else np.zeros(1, int)
    visit_fp = np.concatenate(visit_fp) if visit_fp else np.zeros(1, int)
    life_fp = np.concatenate(life_fp) if life_fp else np.zeros(1, int)

    def cdf(counts: np.ndarray) -> np.ndarray:
        """P[footprint <= k segments], k = 1..spr."""
        hist = np.bincount(np.clip(counts, 1, spr), minlength=spr + 1)[1:]
        tot = max(hist.sum(), 1)
        return np.cumsum(hist) / tot

    gaps = np.concatenate(gaps) if gaps else np.zeros(1, int)
    out: Dict[str, object] = {
        "n_reqs": int(n_total),
        "write_frac": writes / max(n_total, 1),
        "row_hit_potential": row_hits / max(n_total, 1),
        "visit_len_mean": float(run_lens.mean()),
        "visit_footprint_mean": float(visit_fp.mean()) / spr,
        "visit_footprint_cdf": cdf(visit_fp),
        "life_footprint_mean": float(life_fp.mean()) / spr,
        "life_footprint_cdf": cdf(life_fp),
        "reuse_dist_hist": reuse_hist,
        "blp_mean": float(np.concatenate(blp_counts).mean())
        if blp_counts else 1.0,
        "interarrival_ns_mean": float(gaps.mean()) / TICKS_PER_NS,
        "segs_per_row": spr,
    }
    if apps is not None:
        out["mpki_mean"] = float(np.mean([a.mpki for a in apps]))
    return out


def summarize(prof: Dict[str, object]) -> Dict[str, float]:
    """The headline scalars of a profile (what benchmarks tabulate)."""
    cdf = prof["visit_footprint_cdf"]
    return {
        "row_hit_potential": round(float(prof["row_hit_potential"]), 3),
        "visit_footprint": round(float(prof["visit_footprint_mean"]), 3),
        "visit_leq2seg": round(float(cdf[min(1, len(cdf) - 1)]), 3),
        "life_footprint": round(float(prof["life_footprint_mean"]), 3),
        "blp": round(float(prof["blp_mean"]), 2),
        "write_frac": round(float(prof["write_frac"]), 3),
    }
