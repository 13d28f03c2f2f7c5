"""The profiler's trace of a ``--trace 1`` window.

The first ``TRACE_SECONDS`` of the window run under the PyTorch profiler
(Kineto), with the CUDA activity on a CUDA device (the device's kernels,
copies and fills, and the host's CUDA runtime calls) and the CPU
activity (the host's operators) on the CPU.  The host's operators are
left out on the card: at a window's millions of them, recording them
doubles a job's host time and reading them back takes minutes.
``start`` / ``stop`` drive the profiler through
``torch.autograd.profiler``'s enable and disable calls, which
``torch.profiler.profile`` wraps, and keep Kineto's raw events.  Kineto
stamps events in Unix-epoch nanoseconds, so the jobs' ranges are taken
on the host by ``time.time_ns()``.  ``busy_ns`` is the union of device
operations over an interval; the breakdown names the device operations
that took most time and the longest idle gaps by the host call running
at their middle.
"""
from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict
from typing import List, Tuple

TRACE_SECONDS = 10.0

Span = Tuple[str, int, int]          # name, start ns, end ns


@dataclasses.dataclass
class Timeline:
    jobs: List[Tuple[int, int]]
    device: List[Span]
    host: List[Span]

    @property
    def window(self) -> Tuple[int, int]:
        return self.jobs[0][0], self.jobs[-1][1]


def start(cuda: bool) -> None:
    from torch.autograd import profiler as P
    acts = {P.ProfilerActivity.CUDA if cuda else P.ProfilerActivity.CPU}
    cfg = P.ProfilerConfig(P.ProfilerState.KINETO, False, False, False,
                           False, False, P._ExperimentalConfig())
    P._prepare_profiler(cfg, acts)
    P._enable_profiler(cfg, acts)


def stop():
    """Stop the profiler; its raw result, for ``read``."""
    from torch.autograd import profiler as P
    return P._disable_profiler()


def read(result, jobs: List[Tuple[int, int]]) -> Timeline:
    """The device operations and host calls of a profiler ``result``,
    beside the traced jobs' ``(start, end)`` ns."""
    device, host = [], []
    for ev in result.events():
        start = ev.start_ns()
        span = (ev.name(), start, start + ev.duration_ns())
        if "CUDA" in str(ev.device_type()):     # kernels, copies, fills
            device.append(span)
        elif not ev.is_user_annotation():       # host operators or calls
            host.append(span)
    jobs = sorted(jobs)
    device.sort(key=lambda s: s[1])
    host.sort(key=lambda s: s[1])
    return Timeline(jobs, device, host)


def merged(spans: List[Span], lo: int, hi: int) -> List[Tuple[int, int]]:
    """The union of ``spans`` clipped to ``[lo, hi)``, as sorted disjoint
    intervals."""
    out: List[List[int]] = []
    for _, s, e in spans:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_ns(tl: Timeline, lo: int, hi: int) -> int:
    return sum(e - s for s, e in merged(tl.device, lo, hi))


def busy_in_jobs(tl: Timeline) -> List[int]:
    """Device-busy ns inside each job's range."""
    iv = merged(tl.device, *tl.window)
    starts = [s for s, _ in iv]
    out = []
    for lo, hi in tl.jobs:
        n = 0
        for s, e in iv[max(0, bisect.bisect_right(starts, lo) - 1):]:
            if s >= hi:
                break
            n += max(0, min(e, hi) - max(s, lo))
        out.append(n)
    return out


def breakdown(tl: Timeline, top: int = 10) -> dict:
    """``device_ops``: [name, seconds] of the device operations that took
    most time; ``idle_gaps``: [name, seconds] of the idle time between
    them inside the window, by the innermost host call running at each
    gap's middle (``"host: no traced call"`` where none was)."""
    per_op = defaultdict(int)
    for name, s, e in tl.device:
        per_op[name] += e - s
    lo, hi = tl.window
    iv = merged(tl.device, lo, hi)
    edges = [lo] + [x for s, e in iv for x in (s, e)] + [hi]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                   for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:1000]
    starts = [s for _, s, _ in tl.host]
    per_gap = defaultdict(int)
    for length, start in gaps:
        mid = start + length // 2
        name = "host: no traced call"
        j = bisect.bisect_right(starts, mid) - 1
        for _ in range(256):            # the innermost op started last
            if j < 0:
                break
            op, s, e = tl.host[j]
            if e >= mid:
                name = op
                break
            j -= 1
        per_gap[name] += length

    def rank(d):
        return [[k, v * 1e-9] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"device_ops": rank(per_op), "idle_gaps": rank(per_gap)}
