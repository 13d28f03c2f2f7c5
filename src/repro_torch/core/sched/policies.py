"""Memory-controller scheduling policies as trace-preprocessing passes.

The simulator's seed contract was "the trace order IS the schedule"
(DESIGN.md §7).  This module adds the controller the paper actually
evaluates under (§7, FR-FCFS): a ``timing.SchedConfig`` names a scheduling
discipline and ``schedule`` realizes it as a **per-channel service-order
permutation** computed on the host *before* the compiled scan runs.
Arrival times (``t_issue``) are untouched — only the order in which the
controller serves requests changes — so a scheduled trace has exactly the
shape and dtype of its input and replays through the very same compiled
scan (one compilation serves a whole policy grid; DESIGN.md §10).

Model, per channel:

 * **Per-bank request queues** are implied by the window walk: the
   controller looks at the next ``queue_depth`` pending requests in arrival
   order (the transaction queue) — within that window each bank's requests
   appear in per-bank FIFO order, which is exactly a per-bank queue of
   depth <= queue_depth.
 * **FCFS** serves the window head, i.e. the identity permutation.
 * **FR-FCFS** serves the oldest *row hit* in the window — a request whose
   row matches the last row the controller scheduled to that bank — and
   falls back to the window head when there is none.  A **starvation cap**
   bounds unfairness: once the oldest pending request has been bypassed
   ``starve_cap`` times it is served unconditionally (``starve_cap=0``
   therefore degenerates to FCFS, a tested identity).
 * **Write-drain batching** composes in front as posted writes: writes are
   parked in a write queue while reads flow past, and once the queue holds
   ``drain_batch`` entries it drains as one batch sorted by (bank, row) —
   the row-locality batching real controllers drain writes for.  Deferred
   writes keep their arrival ``t_issue``, so their measured latency
   honestly includes the drain delay.  (Same-address read-after-write
   ordering is not preserved; the simulator carries no data values, so
   only latency statistics are affected — documented in DESIGN.md §10.)

No-op padding requests (``dram.NOOP_ISSUE``) are never reordered: the real
prefix is scheduled and the no-ops are re-appended, preserving the
"padding is a suffix" invariant of ``simulator.sweep_traces``.

Everything here is numpy/Python — traces are built once and cached by the
benchmark layer, and the pass is O(T * queue_depth).

PyTorch port of ``repro.core.sched.policies``: the same host-side code,
kept as its own copy so the port imports nothing of the JAX package.
Trace leaves may be numpy arrays or tensors (on any device); every
output is numpy.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.dram import NOOP_ISSUE, Trace, host_array
from repro_torch.core.timing import (GEOM, SCHED_FCFS, TICKS_PER_NS,
                                     DRAMGeometry, SchedConfig)

__all__ = ["SchedConfig", "SCHED_FCFS", "schedule", "frfcfs_perm",
           "write_drain_perm", "StreamScheduler"]


def write_drain_perm(bank: Sequence[int], row: Sequence[int],
                     is_write: Sequence[bool], order: Sequence[int],
                     drain_batch: int) -> List[int]:
    """Posted-write pre-pass: reads keep ``order``; writes queue up and
    drain as (bank, row)-sorted batches of ``drain_batch``.  Returns the
    new service order (a permutation of ``order``)."""
    out: List[int] = []
    wq: List[int] = []

    def drain():
        # sort stably by (bank, row): the drained batch sweeps each bank's
        # rows once instead of ping-ponging the row buffers
        wq.sort(key=lambda j: (bank[j], row[j]))
        out.extend(wq)
        wq.clear()

    for i in order:
        if is_write[i]:
            wq.append(i)
            if len(wq) >= drain_batch:
                drain()
        else:
            out.append(i)
    if wq:
        drain()
    return out


def frfcfs_perm(bank: Sequence[int], row: Sequence[int],
                t_issue: Sequence[int], order: Sequence[int],
                queue_depth: int, starve_cap: int, n_banks: int,
                arrival_window: int) -> List[int]:
    """FR-FCFS window walk over ``order``: serve the oldest row hit within
    the ``queue_depth`` transaction queue, head-of-queue after
    ``starve_cap`` bypasses of the oldest pending request.  A candidate
    may bypass only if it was issued within ``arrival_window`` ticks of
    the oldest pending request — the queue holds *arrived* requests, not
    the issue-future.  Returns the service order."""
    order = list(order)
    n = len(order)
    win = order[:queue_depth]          # the transaction-queue window
    nxt = min(queue_depth, n)          # next arrival to refill the window
    last_row = [-1] * n_banks          # last row scheduled per bank
    out: List[int] = []
    bypass = 0
    for _ in range(n):
        pick = 0
        if bypass < starve_cap and win:
            horizon = t_issue[win[0]] + arrival_window
            for k, i in enumerate(win):
                if t_issue[i] > horizon:
                    continue           # not plausibly arrived yet
                if row[i] == last_row[bank[i]]:
                    pick = k
                    break
        i = win.pop(pick)
        bypass = 0 if pick == 0 else bypass + 1
        out.append(i)
        last_row[bank[i]] = row[i]
        if nxt < n:
            win.append(order[nxt])
            nxt += 1
    return out


def _schedule_channel(t: np.ndarray, bank: np.ndarray, row: np.ndarray,
                      is_write: np.ndarray, sc: SchedConfig,
                      n_banks: int) -> np.ndarray:
    """Service-order permutation for one channel's arrays."""
    real = np.flatnonzero(t < NOOP_ISSUE)
    bl, rl, wl = bank.tolist(), row.tolist(), is_write.tolist()
    order: List[int] = real.tolist()
    if sc.write_drain:
        order = write_drain_perm(bl, rl, wl, order, sc.drain_batch)
    if sc.policy == "frfcfs":
        order = frfcfs_perm(bl, rl, t.tolist(), order, sc.queue_depth,
                            sc.starve_cap, n_banks,
                            sc.arrival_window_ns * TICKS_PER_NS)
    noops = np.flatnonzero(t >= NOOP_ISSUE)
    return np.concatenate([np.asarray(order, np.int64), noops]) \
        if noops.size else np.asarray(order, np.int64)


def schedule(trace: Trace, sc: Optional[SchedConfig],
             geom: DRAMGeometry = GEOM) -> Trace:
    """Reorder a (T,) or (C, T) trace into the service order ``sc``'s
    controller would issue.  FCFS (or ``sc=None``) returns the trace
    object untouched — the existing zero-controller behavior."""
    if sc is None or sc.is_identity:
        return trace
    t = host_array(trace.t_issue)
    leaves = {name: host_array(x)
              for name, x in trace._asdict().items()}
    if t.ndim == 1:
        perm = _schedule_channel(t, leaves["bank"], leaves["row"],
                                 leaves["is_write"], sc, geom.n_banks)
        return Trace(**{k: v[perm] for k, v in leaves.items()})
    chans = []
    for c in range(t.shape[0]):
        perm = _schedule_channel(t[c], leaves["bank"][c], leaves["row"][c],
                                 leaves["is_write"][c], sc, geom.n_banks)
        chans.append({k: v[c][perm] for k, v in leaves.items()})
    return Trace(**{k: np.stack([ch[k] for ch in chans])
                    for k in leaves})


class StreamScheduler:
    """The carried scheduler window of a chunked replay (DESIGN.md §13).

    ``schedule`` needs the whole trace in hand; a streamed replay only
    ever holds one chunk.  This class re-expresses the same two passes —
    posted-write drain in front of the FR-FCFS window walk — as an
    incremental pipeline whose carried state (write queue, transaction-
    queue window, per-bank last-scheduled row, starvation counter)
    survives chunk boundaries.  Both walks decide from a *bounded* window
    (``drain_batch`` writes / ``queue_depth`` requests), so emitting a
    pick only once the window is provably identical to the monolithic
    walk's — full, or flushing at end of stream — reproduces the
    monolithic permutation **exactly**; ``tests/test_streaming.py`` pins
    ``feed``+``flush`` against ``schedule`` bitwise.

    One instance schedules ONE channel.  ``feed`` takes (T,) trace leaves
    (chunk-interior no-ops are dropped — they are padding, not requests;
    the streaming layer re-packs emitted requests into fixed-shape
    segments and re-pads itself) and returns whatever requests became
    committable; ``flush`` drains the carried windows at end of stream.
    """

    def __init__(self, sc: Optional[SchedConfig],
                 geom: DRAMGeometry = GEOM):
        self.sc = sc
        self.identity = sc is None or sc.is_identity
        self.n_banks = geom.n_banks
        self.wq: List[tuple] = []      # posted writes awaiting a drain
        self.win: List[tuple] = []     # FR-FCFS transaction-queue window
        self.last_row = [-1] * geom.n_banks
        self.bypass = 0

    @staticmethod
    def _records(trace: Trace) -> List[tuple]:
        t = host_array(trace.t_issue)
        keep = np.flatnonzero(t < NOOP_ISSUE)
        cols = [host_array(x)[keep].tolist()
                for x in (t, trace.bank, trace.row, trace.col,
                          trace.is_write, trace.core)]
        return list(zip(*cols)) if keep.size else []

    @staticmethod
    def _emit(records: List[tuple]) -> Trace:
        if not records:
            z = np.zeros(0, np.int32)
            return Trace(z, z, z, z, np.zeros(0, bool), z)
        a = list(zip(*records))
        return Trace(t_issue=np.asarray(a[0], np.int32),
                     bank=np.asarray(a[1], np.int32),
                     row=np.asarray(a[2], np.int32),
                     col=np.asarray(a[3], np.int32),
                     is_write=np.asarray(a[4], bool),
                     core=np.asarray(a[5], np.int32))

    def _drain_writes(self) -> List[tuple]:
        # (bank, row)-sorted batch: same key as write_drain_perm's drain
        self.wq.sort(key=lambda r: (r[1], r[2]))
        out, self.wq = self.wq, []
        return out

    def _stage_drain(self, records: List[tuple]) -> List[tuple]:
        if not (self.sc and self.sc.write_drain):
            return records
        out: List[tuple] = []
        for r in records:
            if r[4]:
                self.wq.append(r)
                if len(self.wq) >= self.sc.drain_batch:
                    out.extend(self._drain_writes())
            else:
                out.append(r)
        return out

    def _frfcfs_step(self) -> tuple:
        """One pick of the monolithic window walk (``frfcfs_perm``) from
        the carried window — callable only when the window state equals
        the monolithic walk's (full window, or end-of-stream)."""
        sc, win = self.sc, self.win
        pick = 0
        if self.bypass < sc.starve_cap and win:
            horizon = win[0][0] + sc.arrival_window_ns * TICKS_PER_NS
            for k, r in enumerate(win):
                if r[0] > horizon:
                    continue
                if r[2] == self.last_row[r[1]]:
                    pick = k
                    break
        r = win.pop(pick)
        self.bypass = 0 if pick == 0 else self.bypass + 1
        self.last_row[r[1]] = r[2]
        return r

    def _stage_frfcfs(self, records: List[tuple],
                      flush: bool) -> List[tuple]:
        if not (self.sc and self.sc.policy == "frfcfs"):
            return records
        out: List[tuple] = []
        qd = self.sc.queue_depth
        for r in records:
            self.win.append(r)
            # the monolithic walk always decides from a full qd window
            # while input remains (pick + immediate refill), so a pick is
            # committed exactly when the carried window reaches qd
            if len(self.win) >= qd:
                out.append(self._frfcfs_step())
        if flush:
            # end of stream: the monolithic walk's window dwindles qd-1..1
            while self.win:
                out.append(self._frfcfs_step())
        return out

    def feed(self, trace: Trace) -> Trace:
        """Schedule one chunk's worth of requests; returns the requests
        whose service position is now decided (possibly spanning earlier
        chunks, possibly empty while windows fill)."""
        records = self._records(trace)
        if self.identity:
            return self._emit(records)
        return self._emit(self._stage_frfcfs(self._stage_drain(records),
                                             flush=False))

    def flush(self) -> Trace:
        """End of stream: drain the write queue and the FR-FCFS window."""
        if self.identity:
            return self._emit([])
        tail: List[tuple] = self._drain_writes() if (
            self.sc and self.sc.write_drain) else []
        return self._emit(self._stage_frfcfs(tail, flush=True))
