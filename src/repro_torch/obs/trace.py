"""Structured span/event log (DESIGN.md §15), PyTorch port of
``repro.obs.trace`` (plain Python, no import of the JAX package).

A flat JSONL stream of Chrome-trace-shaped records: ``ph="B"``/``"E"``
bracket a span, ``ph="i"`` is an instant event, ``ph="C"`` a counter
sample.  Timestamps come from an injected clock (the JAX package's
orchestrator passes its deterministic logical clock; without one a plain
event counter is used), so the same run produces a byte-identical log
every time (``tests/test_torch_obs.py`` pins this); no wall clock ever
enters a record.  Records are appended and flushed one write per event,
so a killed process still leaves every span it opened on disk.

``chrome_trace`` / ``chrome_from_jsonl`` re-shape the log into the Chrome
trace-event JSON format (a ``{"traceEvents": [...]}`` object) loadable in
Perfetto or chrome://tracing; ``telemetry_counter_events`` renders a
``WindowCollector`` series as counter tracks beside the spans.

``PROGRAM`` is the program recorder: one in-memory ``Tracer`` per process
that the port's hot paths (``simulator.sweep`` / ``sweep_traces`` and the
replay under them) write spans and counters to through ``span(name)`` and
``count(**amounts)``.  Its clock is ``time.time_ns()``, the Unix-epoch
nanoseconds Kineto stamps its events in, so the spans lie on the
profiler's device trace.  It records only while a torch profiler session
is on in the process (``recording()``); otherwise ``span`` returns a
shared no-op context and ``count`` returns at once, one check of the
profiler's state each.  A span's ``B`` record carries its own ``id``, its
``parent``'s id (``None`` at the root) and its ``job``, the id of the
outermost span open on its thread; its ``E`` record carries its ``id`` and
the amounts ``count`` added while it was the innermost open span (counted
where the work happens, never derived from shapes afterwards).  It keeps
a bounded tail of ``PROGRAM_MAXLEN`` records (2**20, some 100 jobs of 100
records each in a 10 s traced window, many times over), the oldest
dropped first.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import torch

__all__ = ["Tracer", "chrome_trace", "chrome_from_jsonl", "read_jsonl",
           "counter_events", "telemetry_counter_events", "PROGRAM", "span",
           "count", "recording"]


def _encode(rec: Dict[str, Any]) -> str:
    # sorted keys + no whitespace variance == byte-determinism
    return json.dumps(rec, sort_keys=True, separators=(",", ":"))


class Tracer:
    """Append-only span/event recorder.

    ``clock`` is any zero-arg callable yielding monotonically
    non-decreasing numbers (a deterministic logical clock keeps the log
    byte-identical across runs).  Without a clock a plain event counter
    is used (still deterministic, just unitless).
    ``path=None`` keeps records in memory only (``.events``); ``maxlen``
    keeps only the newest ``maxlen`` of them.
    """

    def __init__(self, path: Optional[str] = None,
                 clock: Optional[Callable[[], float]] = None,
                 pid: int = 0, maxlen: Optional[int] = None) -> None:
        self.events: List[Dict[str, Any]] = [] if maxlen is None else \
            collections.deque(maxlen=maxlen)
        self.pid = pid
        self._clock = clock or (lambda c=itertools.count(1): float(next(c)))
        if path and os.path.dirname(path):
            os.makedirs(os.path.dirname(path), exist_ok=True)
        self._f = open(path, "a", encoding="utf-8") if path else None

    def _emit(self, ph: str, name: str, attrs: Dict[str, Any],
              tid: int = 0) -> None:
        rec = {"name": name, "ph": ph, "ts": self._clock(),
               "pid": self.pid, "tid": tid, "args": attrs}
        self.events.append(rec)
        if self._f is not None:
            self._f.write(_encode(rec) + "\n")
            self._f.flush()  # survive a kill mid-span

    def event(self, name: str, **attrs: Any) -> None:
        """One instant event (retry, straggler re-issue, quarantine...)."""
        self._emit("i", name, attrs)

    def counter(self, name: str, **values: Any) -> None:
        """One Chrome counter sample (``ph="C"``): ``values`` are the
        numeric series of the named counter track — Perfetto renders each
        key as a line on that track."""
        self._emit("C", name, {k: float(v) for k, v in values.items()})

    def begin(self, name: str, **attrs: Any) -> None:
        self._emit("B", name, attrs)

    def end(self, name: str, **attrs: Any) -> None:
        self._emit("E", name, attrs)

    @contextlib.contextmanager
    def span(self, name: str, **attrs: Any):
        """Bracket a scope with B/E records.  The E record is emitted on
        the success path only — a span left open in the log IS the signal
        that the process died (or raised) inside it."""
        self.begin(name, **attrs)
        yield self
        self.end(name)

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


PROGRAM_MAXLEN = 1 << 20
PROGRAM = Tracer(clock=time.time_ns, maxlen=PROGRAM_MAXLEN)
recording = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()
_ids = itertools.count(1)
_open = threading.local()        # this thread's open program spans


def _stack() -> List["_Span"]:
    stack = getattr(_open, "spans", None)
    if stack is None:
        stack = _open.spans = []
    return stack


class _Span:
    """One program span: ``B`` on entry, ``E`` (with its counts) on exit,
    raised or not, so every ``B`` has its ``E``."""
    __slots__ = ("name", "id", "counts", "tid")

    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self) -> "_Span":
        stack = _stack()
        self.id = next(_ids)
        self.counts: Dict[str, int] = {}
        self.tid = threading.get_ident()
        PROGRAM._emit("B", self.name, {
            "id": self.id, "parent": stack[-1].id if stack else None,
            "job": stack[0].id if stack else self.id}, self.tid)
        stack.append(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        _stack().pop()
        args = {"id": self.id, **self.counts}
        if exc_type is not None:
            args["raised"] = exc_type.__name__
        PROGRAM._emit("E", self.name, args, self.tid)
        return False


def span(name: str):
    """A program span named ``name`` (a context manager), recorded in
    ``PROGRAM`` while the profiler is on; a shared no-op otherwise."""
    return _Span(name) if recording() else _OFF


def count(**amounts: int) -> None:
    """Add ``amounts`` to the innermost open program span's counts (its
    ``E`` record), or record them as a ``C`` record named ``count`` where
    no span is open; nothing while the profiler is off."""
    if not recording():
        return
    stack = _stack()
    if not stack:
        PROGRAM._emit("C", "count", dict(amounts), threading.get_ident())
        return
    counts = stack[-1].counts
    for k, v in amounts.items():
        counts[k] = counts.get(k, 0) + v


def read_jsonl(path: str) -> List[Dict[str, Any]]:
    out = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


# per-window telemetry series exported as Perfetto counter tracks (each
# name becomes one track; requests-retired is the time axis)
_TEL_TRACKS = {
    "telemetry/hit_rate": ("hit_rate", "row_hit_rate"),
    "telemetry/latency_ns": ("avg_lat_ns", "p50_ns", "p99_ns"),
    "telemetry/occupancy": ("w_ins", "w_reloc_blocks", "w_reqs"),
    "telemetry/slo": ("slo_rate",),
}


def telemetry_counter_events(series: Dict[str, Any], period: int,
                             pid: int = 0) -> List[Dict[str, Any]]:
    """Render a ``WindowCollector`` series as ``ph="C"`` counter events.

    One sample per closed window per track in ``_TEL_TRACKS``, timestamped
    by requests retired (``win_idx * period`` — the chunk-invariant window
    clock, so the same series always produces the same events).  Feed the
    result through ``chrome_trace`` (alone or appended to a span log) and
    the hit-rate/latency/occupancy tracks render in Perfetto alongside the
    orchestrator's spans.  NaN samples (empty windows) are skipped — the
    Chrome format has no representation for them."""
    out: List[Dict[str, Any]] = []
    n = len(series["win_idx"])
    for i in range(n):
        ts = float(series["win_idx"][i]) * period
        for track, keys in _TEL_TRACKS.items():
            args = {}
            for k in keys:
                v = float(series[k][i])
                if v == v:                  # drop NaN samples
                    args[k] = v
            if args:
                out.append({"name": track, "ph": "C", "ts": ts,
                            "pid": pid, "tid": 0, "args": args})
    return out


def counter_events(tracer: Tracer, series: Dict[str, Any],
                   period: int) -> int:
    """Append a telemetry series to a live ``Tracer`` as counter records
    (JSONL-persisted like every other record).  Returns the event count."""
    recs = telemetry_counter_events(series, period, pid=tracer.pid)
    for r in recs:
        tracer.events.append(r)
        if tracer._f is not None:
            tracer._f.write(_encode(r) + "\n")
            tracer._f.flush()
    return len(recs)


def chrome_trace(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Re-shape recorded events into the Chrome trace-event format.

    Spans the process never closed (it died inside them) get a synthetic
    ``E`` at the last seen timestamp so viewers render them instead of
    dropping them.  Instant events gain the required thread scope;
    counter samples (``ph="C"``) pass through with their numeric args.
    """
    out: List[Dict[str, Any]] = []
    open_stack: List[Dict[str, Any]] = []
    last_ts = 0.0
    for e in events:
        rec = {"name": e["name"], "ph": e["ph"], "ts": float(e["ts"]),
               "pid": int(e.get("pid", 0)), "tid": int(e.get("tid", 0)),
               "args": e.get("args", {})}
        last_ts = max(last_ts, rec["ts"])
        if rec["ph"] == "i":
            rec["s"] = "t"  # thread-scoped instant
        elif rec["ph"] == "B":
            open_stack.append(rec)
        elif rec["ph"] == "E" and open_stack:
            open_stack.pop()
        out.append(rec)
    for rec in reversed(open_stack):   # LIFO: close inner spans first
        out.append({"name": rec["name"], "ph": "E", "ts": last_ts,
                    "pid": rec["pid"], "tid": rec["tid"],
                    "args": {"synthetic_close": True}})
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def chrome_from_jsonl(src: str, dst: str) -> int:
    """Convert a span JSONL file to a Perfetto-loadable trace file.

    Returns the number of trace events written."""
    doc = chrome_trace(read_jsonl(src))
    with open(dst, "w", encoding="utf-8") as f:
        json.dump(doc, f, sort_keys=True, separators=(",", ":"))
    return len(doc["traceEvents"])
