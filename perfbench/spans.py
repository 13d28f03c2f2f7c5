"""The program's own spans in a ``--trace 1`` window, and each traced job's
device-idle time put down to them.

The program (``repro_torch.obs.trace``) records spans and counters in
its process-wide ``PROGRAM`` recorder while the profiler is on, stamped
by ``time.time_ns()``, the clock of the profiler's trace and of the
jobs' ranges.  Nothing here imports the program: the records are read
from the module the driver's job loaded, and a program without the
recorder gives none, so every reader returns ``None``.

A span's ``B`` record holds its ``id``, its ``parent`` and its ``job``
(the id of its root span), its ``E`` record the amounts counted while it
was the innermost open span.  A root span belongs to the traced job whose
range holds it; a job's spans are those whose ``job`` is that root's id.

The attribution rule: a job's device-idle time is its range minus the
union of the device's operations (``trace.merged(tl.device, ...)``),
the quantity ``dispatch.host_ms_per_job`` reads.  Each idle nanosecond
goes to the innermost of the job's spans open at that moment, and to no
span before the root opens or after it closes.  ``PHASES`` groups span
names; whatever no phase names (the ``sweep`` root, ``sweep.group``, no
span at all) is ``unspanned``, so the phases of a job add up to its idle
time exactly.
"""
from __future__ import annotations

import bisect
import sys
from collections import defaultdict
from typing import Dict, List, Optional

from perfbench import trace

PHASES = {
    "params": ("sweep.params",),
    "layout": ("sweep.stack", "replay.init", "replay.prepare"),
    "launch": ("replay.run",),
    "results": ("sweep.to_host", "sweep.results"),
}
UNSPANNED = "unspanned"
_PHASE_OF = {name: phase for phase, names in PHASES.items()
             for name in names}


def records() -> list:
    """The program recorder's records, ``[]`` where the program has none."""
    mod = sys.modules.get("repro_torch.obs.trace")
    rec = getattr(mod, "PROGRAM", None)
    return list(rec.events) if rec is not None else []


def job_spans(tl: trace.Timeline, recs: list) -> List[list]:
    """Per traced job of ``tl``, the spans of the roots it holds, each
    ``(name, start, end, depth, counts)``; jobs without a root get ``[]``."""
    opened, spans, depth = {}, {}, {}
    for r in recs:
        a = r["args"]
        if r["ph"] == "B":
            opened[a["id"]] = r
            up = 0 if a["parent"] is None else depth.get(a["parent"], -1) + 1
            depth[a["id"]] = up if up > 0 or a["parent"] is None else -1
        elif r["ph"] == "E" and a.get("id") in opened:
            spans[a["id"]] = (opened.pop(a["id"]), r)
    per_root = defaultdict(list)
    for i, (b, e) in spans.items():
        if depth[i] < 0:                    # its parent fell off the tail
            continue
        counts = {k: v for k, v in e["args"].items()
                  if k not in ("id", "raised")}
        per_root[b["args"]["job"]].append(
            (b["name"], b["ts"], e["ts"], depth[i], counts))
    starts = [lo for lo, _ in tl.jobs]
    out: List[list] = [[] for _ in tl.jobs]
    for root, group in per_root.items():
        if root not in spans or depth[root] != 0:
            continue
        _, s, e, _, _ = next(x for x in group if x[3] == 0)
        j = bisect.bisect_right(starts, s) - 1
        if j >= 0 and e <= tl.jobs[j][1]:
            out[j].extend(group)
    return out


def _innermost(spans: list, lo: int, hi: int) -> List[tuple]:
    """``[lo, hi)`` cut into ``(start, end, name)`` pieces, each named by
    the innermost span open over it (``None``: no span)."""
    edges = sorted({lo, hi} | {t for _, s, e, _, _ in spans for t in (s, e)
                               if lo < t < hi})
    opens = sorted(spans, key=lambda x: (x[1], x[3]))
    out, live, k = [], [], 0
    for a, b in zip(edges, edges[1:]):
        while k < len(opens) and opens[k][1] <= a:
            live.append(opens[k])
            k += 1
        live = [x for x in live if x[2] > a]
        top = max(live, key=lambda x: x[3]) if live else None
        out.append((a, b, top[0] if top else None))
    return out


def split_ns(tl: trace.Timeline, recs: list) -> Optional[Dict[str, int]]:
    """Device-idle ns of the traced jobs, summed over them, per phase of
    ``PHASES`` and ``unspanned``; ``None`` without program spans."""
    per_job = job_spans(tl, recs)
    if not tl.jobs or not any(per_job):
        return None
    out = dict.fromkeys(list(PHASES) + [UNSPANNED], 0)
    for (lo, hi), spans in zip(tl.jobs, per_job):
        busy = trace.merged(tl.device, lo, hi)
        idle = [(s, e) for s, e in zip([lo] + [e for _, e in busy],
                                       [s for s, _ in busy] + [hi]) if e > s]
        pieces = _innermost(spans, lo, hi)
        i = 0
        for s, e in idle:
            while i < len(pieces) and pieces[i][1] <= s:
                i += 1
            j = i
            while j < len(pieces) and pieces[j][0] < e:
                a, b, name = pieces[j]
                n = min(b, e) - max(a, s)
                if n > 0:
                    out[_PHASE_OF.get(name, UNSPANNED)] += n
                j += 1
    return out


def counts(tl: trace.Timeline, recs: list) -> Optional[Dict[str, int]]:
    """The amounts counted in the traced jobs' spans, summed; ``None``
    without program spans."""
    per_job = job_spans(tl, recs)
    if not any(per_job):
        return None
    out: Dict[str, int] = defaultdict(int)
    for spans in per_job:
        for *_, c in spans:
            for k, v in c.items():
                out[k] += v
    return dict(out)


def _cached(ctx, key, fn):
    """``fn(ctx.tl, records())``, once a run: the readers share it."""
    memo = ctx.__dict__.setdefault("_program_spans", {})
    if key not in memo:
        memo[key] = fn(ctx.tl, records()) if ctx.tl and ctx.tl.jobs \
            else None
    return memo[key]


def idle_ms_per_job(ctx, phase: str) -> Optional[float]:
    """A phase's device-idle ms a traced job (``None`` without spans)."""
    split = _cached(ctx, "idle", split_ns)
    if split is None:
        return None
    return split[phase] / len(ctx.tl.jobs) / 1e6


def count_per_job(ctx, name: str) -> Optional[float]:
    """A counter's sum over the traced jobs' spans, a job (``None``
    without spans)."""
    got = _cached(ctx, "counts", counts)
    if got is None:
        return None
    return got.get(name, 0) / len(ctx.tl.jobs)
