"""Vectorized, cycle-approximate DRAM bank/row-buffer/FIGCache simulator,
PyTorch port of ``repro.core.dram`` (the fused scan body).

The JAX package runs a ``lax.scan`` over a per-channel request trace and
``vmap``s it over channels and config points.  The port writes those axes
out: every run carries ``N = P x C`` *lanes* (lane ``p * C + c`` is config
point ``p`` on channel ``c``) and an eager Python loop takes one step per
request, each step a handful of tensor ops over all lanes.  The trace moves
to the device once, laid out ``(T, N)`` so step ``t`` reads one contiguous
row per field.

Per-lane state (``BankState``): open row + busy-until time per bank, a
banked FTS (``core/fts.py``), the MSHR ring per core and the channel's data
bus.  All of it is int32 (bool for flags) and updated in place by the step:
``resume`` clones its input state once, so callers' tensors never change.

Where the replay runs follows the state's device, with no fallback:

* on a CUDA device ``_advance`` replays the whole trace in ONE launch of
  ``kernels/sim_scan``, the hand-written CUDA kernel, which runs this
  module's step per request with the fused FTS lookup inlined
  (``fts_lookup_warp``), whatever ``StaticConfig.fts_kernel`` says;
* on the CPU it runs the eager loop (``_advance_eager``), one ``step`` per
  request: the kernel's plain version.  There ``fts_kernel=True`` routes
  the tag compare + victim argmin through ``kernels/fts_lookup``'s plain
  version and the default takes the inline torch lookup; both give the
  same counters bit for bit.

``_advance_eager`` also runs on a CUDA device (each cached step then
launches the ``fts_lookup`` kernel): ``chip_smoke.py`` and the ``cuda``
tests hold the replay kernel against it.  A step reads nothing back to the
host — branches are ``torch.where`` — so on a CUDA device the loop only
enqueues work.

A chunked replay is ``sim_init`` -> ``resume`` per segment -> ``finalize``
(``core/streaming.py``), one ``sim_scan`` launch per segment on the card.

Telemetry windows (DESIGN.md §15/§16, ``static.telemetry`` = the window
period in real requests): ``SimState.tel`` carries the open window and the
cumulative latency-histogram planes across segments; ``resume_tel`` /
``sweep_resume_tel`` also return the segment's closed windows as a
``TelemetryFrame`` ring of ``W = min(T, T // period + 2) + 1`` rows.  Both
routes run the same arithmetic: the eager loop's ``_telemetry_step`` and
the ``sim_scan`` kernel's telemetry instantiation.

``variant="dense"`` selects the pre-aggregate reference body
(``_make_step_dense``, DESIGN.md §9): whole-bank FTS gathers per lane,
inserts through ``fts.insert(..., recompute=True)`` and whole-row write
backs.  It is the oracle the fused body is pinned against, bitwise on real
requests; like the JAX package's it does NOT understand no-op padding and
refuses telemetry.  It has no kernel: ``_advance`` runs it through the
eager loop on every device, as the JAX package runs it as a plain scan.

Every replay is counted in ``REPLAYS`` (the counterpart of the JAX
package's ``JIT_TRACE_LOG``), which keeps the tags of the last few:
``sim_scan`` for a kernel launch, ``eager`` for the loop.
``analysis/contracts.py`` budgets them.

Timestamps are int32 ticks (1/8 ns).  Latency accumulators are int32 ns.
"""
from __future__ import annotations

import collections
from typing import Deque, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import fts as fts_lib
from repro_torch.core.timing import (DDR4, GEOM, DRAMGeometry, DRAMTimings,
                                     MechConfig, MechParams, StaticConfig)
from repro_torch.device import resolve_device
from repro_torch.kernels.fts_lookup.ops import fts_lookup_op
from repro_torch.kernels.sim_scan.sim_scan import ring_rows, sim_scan
from repro_torch.obs import trace as obs_trace

I32 = torch.int32


class Trace(NamedTuple):
    """Per-channel request stream in service order.

    Leaves are numpy arrays or tensors shaped (T,) for one channel or
    (C, T) for several; the entry points move them to the device."""
    t_issue: object   # int32 ticks
    bank: object      # int32 [0, n_banks)
    row: object       # int32 [0, n_rows)
    col: object       # int32 [0, row_blocks) — cache-block column
    is_write: object  # bool
    core: object      # int32 [0, n_cores)


N_MSHR = 8  # outstanding misses per core (paper Table 1) — closed-loop throttle

# Ragged-workload padding sentinel: a request with ``t_issue >= NOOP_ISSUE``
# is a no-op — it touches no bank/bus/MSHR/FTS state and no counter.
NOOP_ISSUE = int(fts_lib.BIG)

# Saturation ceiling of the per-core latency-sum counter (cap + the
# per-step bound of simulated time == INT32_MAX, so the add never wraps).
LAT_SUM_CAP = (1 << 30) - 1

# Log2 latency-histogram buckets (DESIGN.md §16): bucket 0 holds
# lat_ns == 0, bucket b >= 1 holds [2**(b-1), 2**b - 1] (the bit length of
# the latency, clipped into the last bucket).  ``obs/latency.py`` holds the
# host-side mirror.
HIST_BUCKETS = 28

_TRACE_DTYPES = (I32, I32, I32, I32, torch.bool, I32)

VARIANTS = ("fused", "dense")

class _Replays:
    """Replays this process made (``count``) and the tags of the last
    ``maxlen``, each "<route>/<variant>/<mechanism>/<policy>/<T>x<lanes>"
    with route ``sim_scan`` (one kernel launch) or ``eager`` (the step
    loop).  JAX's log grows only when something compiles; this runs on
    every replay, so it keeps a count and a bounded tail, not a list."""

    def __init__(self, maxlen: int = 64):
        self.count = 0
        self.last: Deque[str] = collections.deque(maxlen=maxlen)

    def log(self, tag: str):
        self.count += 1
        self.last.append(tag)

    def mark(self):
        return self.count, tuple(self.last)

    def restore(self, mark):
        self.count = mark[0]
        self.last.clear()
        self.last.extend(mark[1])


REPLAYS = _Replays()


def replay_count() -> int:
    return REPLAYS.count


def host_array(x) -> np.ndarray:
    """A trace or state leaf as a numpy array on the host (a tensor on any
    device is copied back; numpy leaves pass through)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def noop_pad(trace: Trace, length: int) -> Trace:
    """Right-pad a (T,)/(C, T) trace to ``length`` requests with no-ops
    (``t_issue = NOOP_ISSUE``, neutral fields elsewhere).  Works on numpy
    and torch leaves alike."""
    cur = trace.t_issue.shape[-1]
    if cur > length:
        raise ValueError(f"trace of {cur} requests is longer than {length}")
    if cur == length:
        return trace

    def pad(x, fill):
        shape = tuple(x.shape[:-1]) + (length - cur,)
        if isinstance(x, torch.Tensor):
            return torch.cat([x, torch.full(shape, fill, dtype=x.dtype,
                                            device=x.device)], dim=-1)
        x = np.asarray(x)
        return np.concatenate([x, np.full(shape, fill, dtype=x.dtype)],
                              axis=-1)

    return Trace(t_issue=pad(trace.t_issue, NOOP_ISSUE),
                 bank=pad(trace.bank, 0), row=pad(trace.row, 0),
                 col=pad(trace.col, 0), is_write=pad(trace.is_write, False),
                 core=pad(trace.core, 0))


class BankState(NamedTuple):
    open_row: torch.Tensor   # (N, n_banks) int32; -1 closed; cache rows >= n_rows
    busy: torch.Tensor       # (N, n_banks) int32 ticks
    fts: fts_lib.FTS         # leaves (N, n_banks, ...)
    mshr_ring: torch.Tensor  # (N, n_cores, N_MSHR) int32 — completion times
    mshr_idx: torch.Tensor   # (N, n_cores) int32 — ring cursor
    bus_free: torch.Tensor   # (N,) int32 — channel data bus free time


class Counters(NamedTuple):
    acts_slow: torch.Tensor
    acts_fast: torch.Tensor
    reads: torch.Tensor
    writes: torch.Tensor
    reloc_blocks: torch.Tensor    # blocks moved into the cache
    wb_blocks: torch.Tensor       # dirty writeback blocks
    row_hits: torch.Tensor
    cache_hits: torch.Tensor
    insertions: torch.Tensor
    lat_sum_ns: torch.Tensor      # (..., n_cores)
    req_cnt: torch.Tensor         # (..., n_cores)
    t_end: torch.Tensor           # ticks


class TelemetryWindows(NamedTuple):
    """Per-window deltas of the interesting counters (DESIGN.md §15).
    ``win_idx`` is the ordinal of the accumulating window: window ``w``
    covers real requests ``[w * period, (w + 1) * period)``.  Lane layout:
    the 12 scalar fields ``(N,)``, ``w_bank_issues`` ``(N, n_banks)`` and
    ``w_hist`` ``(N, HIST_BUCKETS)`` (frames add a window axis after N).
    Every lane clamps at ``LAT_SUM_CAP`` like ``Counters.lat_sum_ns``."""
    win_idx: torch.Tensor
    w_reqs: torch.Tensor
    w_reads: torch.Tensor
    w_writes: torch.Tensor
    w_row_hits: torch.Tensor
    w_cache_hits: torch.Tensor
    w_ins: torch.Tensor
    w_reloc_blocks: torch.Tensor
    w_lat_ns: torch.Tensor      # summed request latency (ns, clamped)
    w_bus_wait: torch.Tensor    # ticks bursts waited on the busy data bus
    w_mshr_wait: torch.Tensor   # ticks requests stalled on a full MSHR
    w_slo: torch.Tensor         # requests over MechParams.slo_ns
    w_bank_issues: torch.Tensor
    w_hist: torch.Tensor


class TelemetryFrame(NamedTuple):
    """One segment's closed windows, oldest first: ``win`` leaves carry a
    window axis of ``W = min(T, T // period + 2) + 1`` rows; rows at or
    past the closed count are ``valid=False`` filler that hosts mask out.
    The open window stays in ``SimState.tel``."""
    valid: torch.Tensor
    win: TelemetryWindows


class TelemetryState(NamedTuple):
    """The cross-segment telemetry cursor (``SimState.tel``): the open
    window and the run-cumulative §16 planes, ``hist`` ``(N, 2, n_cores,
    HIST_BUCKETS)`` (plane 0 reads, plane 1 writes) and ``slo``
    ``(N, n_cores)`` (requests over ``slo_ns``, counted exactly)."""
    win: TelemetryWindows
    hist: torch.Tensor
    slo: torch.Tensor


# the scalar accumulators, in their packed-lane order
_TEL_PLANES = ("w_bank_issues", "w_hist")
_TEL_SCALARS = tuple(f for f in TelemetryWindows._fields
                     if f not in _TEL_PLANES)


class TelScan(NamedTuple):
    """The packed in-replay telemetry carry of N lanes, and the
    ``sim_scan`` kernel's telemetry arguments in this order: the open
    window (``scalars`` (N, 12) in ``_TEL_SCALARS`` order, ``bank_issues``,
    ``hist_win``), the cumulative planes, the segment's ring of closed
    windows (``buf_*`` (N, W, ...), row 0 seeded with the entering window)
    and the closed count ``n`` (N,)."""
    scalars: torch.Tensor
    bank_issues: torch.Tensor
    hist_win: torch.Tensor
    hist: torch.Tensor
    slo: torch.Tensor
    buf_scalars: torch.Tensor
    buf_banks: torch.Tensor
    buf_hist: torch.Tensor
    n: torch.Tensor


class SimState(NamedTuple):
    """The full carried state of a replay, every leaf with a leading lane
    axis ``(N, ...)``.  ``tel`` is the telemetry cursor, ``None`` unless
    ``static.telemetry`` is set."""
    bank: BankState
    cnt: Counters
    tel: Optional[TelemetryState] = None


def _map(fn, tree):
    """``tree`` (nested NamedTuples of tensors, ``None`` subtrees kept)
    with ``fn`` applied to every tensor leaf."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if hasattr(tree, "_fields"):
        return type(tree)(*[_map(fn, x) for x in tree])
    return type(tree)(_map(fn, x) for x in tree)


def init_telemetry(geom: DRAMGeometry = GEOM, lanes: int = 1,
                   device=None) -> TelemetryState:
    dev = resolve_device(device)

    def z(*shape):
        return torch.zeros((lanes,) + shape, dtype=I32, device=dev)

    win = TelemetryWindows(*[z() for _ in _TEL_SCALARS], z(geom.n_banks),
                           z(HIST_BUCKETS))
    return TelemetryState(win, z(2, geom.n_cores, HIST_BUCKETS),
                          z(geom.n_cores))


def _tel_open(tel: TelemetryState, T: int, period: int) -> TelScan:
    """Pack a (freshly cloned) cursor for a T-step segment."""
    win = tel.win
    scalars = torch.stack([getattr(win, f) for f in _TEL_SCALARS], dim=-1)
    N, W = scalars.shape[0], ring_rows(T, period)

    def ring(row):
        buf = row.new_zeros((N, W) + tuple(row.shape[1:]))
        buf[:, 0] = row
        return buf

    return TelScan(scalars, win.w_bank_issues.contiguous(),
                   win.w_hist.contiguous(), tel.hist.contiguous(),
                   tel.slo.contiguous(), ring(scalars),
                   ring(win.w_bank_issues), ring(win.w_hist),
                   torch.zeros((N,), dtype=I32, device=scalars.device))


def _tel_unpack(scalars, banks, hist) -> TelemetryWindows:
    return TelemetryWindows(*scalars.unbind(-1), banks, hist)


def _tel_close(sc: TelScan):
    """(the carried cursor, the segment's frame), lane layout."""
    W = sc.buf_scalars.shape[1]
    valid = torch.arange(W, device=sc.n.device) < sc.n[:, None]
    return (TelemetryState(_tel_unpack(sc.scalars, sc.bank_issues,
                                       sc.hist_win), sc.hist, sc.slo),
            TelemetryFrame(valid, _tel_unpack(sc.buf_scalars, sc.buf_banks,
                                              sc.buf_hist)))


def hist_bucket(lat_ns: torch.Tensor) -> torch.Tensor:
    """The §16 bucket of an int32 latency: its bit length (``32 - clz``)
    clipped into the last bucket, counted in int32 as the number of
    shifts ``k < HIST_BUCKETS - 1`` that leave a nonzero value."""
    ks = torch.arange(HIST_BUCKETS - 1, dtype=I32, device=lat_ns.device)
    x = lat_ns.clamp(min=0)[..., None]
    return (torch.bitwise_right_shift(x, ks) != 0).sum(-1, dtype=I32)


def _telemetry_step(tel: TelScan, period: int, *, lanes, real, bank, core,
                    is_write, row_hit, hit, n_ins, moved, lat_ns, bus_wait,
                    mshr_wait, slo_ns, step_id) -> TelScan:
    """Advance every lane's window accumulators by one (possibly no-op)
    request, as the JAX package's ``_telemetry_step``: a real request at a
    window boundary closes the window, the lanes reset (``win_idx`` to the
    new ordinal), the deltas fold in and the lane vector clamps at
    ``LAT_SUM_CAP``; the planes take scatter-adds; every step writes the
    post-update window to the live ring row ``n``.  No-ops change
    nothing but the clamp."""
    vec = tel.scalars
    r32 = real.to(I32)
    bucket = hist_bucket(lat_ns).long()
    over = real & (slo_ns > 0) & (lat_ns > slo_ns)
    w = vec[:, 0] + 1                      # lane 0 == win_idx
    crossed = real & (step_id >= w * period)
    n = tel.n + crossed.to(I32)
    reset = torch.zeros_like(vec)
    reset[:, 0] = w
    zero = torch.zeros_like(r32)
    delta = torch.stack([
        zero, r32, (~is_write & real).to(I32), (is_write & real).to(I32),
        (row_hit & real).to(I32), hit.to(I32), n_ins, moved,
        torch.where(real, lat_ns, 0), torch.where(real, bus_wait, 0),
        torch.where(real, mshr_wait, 0), over.to(I32)], dim=1)
    vec = (torch.where(crossed[:, None], reset, vec) + delta).clamp_(
        max=LAT_SUM_CAP)
    banks = torch.where(crossed[:, None], 0, tel.bank_issues)
    banks[lanes, bank] += r32
    hist_w = torch.where(crossed[:, None], 0, tel.hist_win)
    hist_w[lanes, bucket] += r32
    tel.hist[lanes, is_write.long(), core, bucket] += r32
    tel.slo[lanes, core] += over.to(I32)
    nl = n.long()
    tel.buf_scalars[lanes, nl] = vec
    tel.buf_banks[lanes, nl] = banks
    tel.buf_hist[lanes, nl] = hist_w
    return tel._replace(scalars=vec, bank_issues=banks, hist_win=hist_w,
                        n=n)


def _lanes_of(x: torch.Tensor, lanes: int) -> torch.Tensor:
    return x.expand((lanes,) + tuple(x.shape)).clone()


def init_state(static: StaticConfig, geom: DRAMGeometry = GEOM,
               lanes: int = 1, device=None) -> BankState:
    """Initial per-bank state of ``lanes`` independent lanes.  FTS arrays
    are allocated at the padded maximum; slots beyond a lane's ``n_slots``
    stay invalid forever."""
    dev = resolve_device(device)
    max_slots = static.max_slots if static.has_cache else 1
    max_segs = static.max_segs_per_row if static.has_cache else 1
    one = fts_lib.init(max_slots, max_segs, device=dev)
    fts = fts_lib.FTS(*[_lanes_of(a.expand((geom.n_banks,) + tuple(a.shape)),
                                  lanes) for a in one])
    return BankState(
        open_row=torch.full((lanes, geom.n_banks), -1, dtype=I32, device=dev),
        busy=torch.zeros((lanes, geom.n_banks), dtype=I32, device=dev),
        fts=fts,
        mshr_ring=torch.zeros((lanes, geom.n_cores, N_MSHR), dtype=I32,
                              device=dev),
        mshr_idx=torch.zeros((lanes, geom.n_cores), dtype=I32, device=dev),
        bus_free=torch.zeros((lanes,), dtype=I32, device=dev),
    )


def init_counters(geom: DRAMGeometry = GEOM, lanes: int = 1,
                  device=None) -> Counters:
    dev = resolve_device(device)

    def z(*shape):
        return torch.zeros((lanes,) + shape, dtype=I32, device=dev)

    return Counters(z(), z(), z(), z(), z(), z(), z(), z(), z(),
                    z(geom.n_cores), z(geom.n_cores), z())


def _floordiv(a, b):
    """Floor division, as ``//`` on jnp int arrays (``-1 // 512 == -1``)."""
    return torch.div(a, b, rounding_mode="floor")


def _lisa_hops(row: torch.Tensor, geom: DRAMGeometry) -> torch.Tensor:
    """Distance (in subarrays) to the nearest interleaved fast subarray.

    LISA-VILLA interleaves 16 fast subarrays among 64 slow ones (1 per 4).
    Floor semantics matter: an invalid victim's tag is -1, and its hop
    count must be that of subarray -1, as in the JAX package."""
    sub = _floordiv(row, geom.rows_per_subarray)
    m = torch.remainder(sub, 4)
    return torch.minimum(m, 4 - m)


class Decision(NamedTuple):
    """The bank-local half of one fused step, every leaf ``(N,)``: the FTS
    write-back, the row-buffer outcome and the relocation cost.  No-op-safe:
    for a padding request every write value equals the old state and every
    counter delta is zero."""
    write: Optional[fts_lib.SlotWrite]  # None for cache-less mechanisms
    hit: torch.Tensor          # cache hit (cacheable & real)
    row_hit: torch.Tensor      # open-row hit on the (possibly cached) target
    served_fast: torch.Tensor  # served from fast-subarray timings
    pre_act: torch.Tensor      # ACT(+PRE) latency before the CAS
    reloc_cost: torch.Tensor   # insertion relocation ticks (0 if no insert)
    new_open: torch.Tensor     # row left open in the bank afterwards
    moved: torch.Tensor        # blocks relocated into the cache
    wb: torch.Tensor           # dirty-victim writeback blocks
    n_ins: torch.Tensor        # 1 if an insertion happened


class _Consts:
    """Per-(device, lanes) index tensors a step reuses instead of
    re-allocating them every request."""

    def __init__(self, n: int, device, max_slots: int, max_segs: int):
        self.lanes = torch.arange(n, device=device)
        self.lanes2 = self.lanes[:, None]
        self.slots = torch.arange(max_slots, dtype=I32, device=device)
        self.segs = torch.arange(max_segs, dtype=I32, device=device)
        self.zeros = torch.zeros((n,), dtype=I32, device=device)
        self.false = torch.zeros((n,), dtype=torch.bool, device=device)


def make_decision_fn(static: StaticConfig, geom: DRAMGeometry = GEOM):
    """Build the per-request decision function of the fused hot loop.

    ``decide(params, state, req, step_id, consts) -> Decision`` reads only
    each lane's own bank.  ``step_id (N,)`` is the number of real requests
    retired before this one, which feeds LRU stamps and the Random victim
    hash; ``consts`` is the step's ``_Consts``."""
    cache_base = geom.n_rows                      # id-space for cache rows
    reserved_sub = geom.n_subarrays - 1           # figcache_slow region
    lisa = static.mechanism == "lisa_villa"
    slow_cache = static.mechanism == "figcache_slow"
    lldram = static.mechanism == "lldram"
    max_slots = static.max_slots if static.has_cache else 1
    row_benefit = static.policy == "row_benefit"

    def decide(params: MechParams, state: BankState, req: Trace, step_id,
               k: _Consts) -> Decision:
        p = params
        spr = p.segs_per_row
        lanes = k.lanes
        b = req.bank.long()
        f = state.fts
        real = req.t_issue < NOOP_ISSUE
        open_b = state.open_row[lanes, b]

        if static.has_cache:
            # ---- cache lookup + victim candidate (one pass over the bank)
            seg = req.row * spr + _floordiv(req.col, p.seg_blocks)
            if slow_cache:   # never cache the subarray hosting reserved rows
                cacheable = _floordiv(req.row, geom.rows_per_subarray) \
                    != reserved_sub
            else:
                cacheable = True
            if static.fts_kernel or f.tags.is_cuda:
                # fused pass: tag compare + the policy's masked victim
                # argmin in one visit of the bank row.  Relies on the
                # in-scan invariant "invalid => tag == -1"
                if row_benefit:
                    score, limit = f.row_sum, _floordiv(p.n_slots + spr - 1,
                                                        spr)
                elif static.policy == "segment_benefit":
                    score, limit = f.benefit, p.n_slots
                elif static.policy == "lru":
                    score, limit = f.last_use, p.n_slots
                else:                       # random: no argmin needed
                    score, limit = f.tags, k.zeros
                hit_raw, slot, cand = fts_lookup_op(f.tags, score, req.bank,
                                                    seg, limit)
            else:
                # tag-only compare: invalid slots always hold tags == -1
                # and segment ids are >= 0, so the valid bitmap is redundant
                m = f.tags[lanes, b] == seg[:, None]
                hit_raw = m.any(dim=-1)
                slot = torch.argmax(m.to(I32), dim=-1).to(I32)
                if row_benefit:
                    cand = fts_lib.masked_argmin(
                        f.row_sum[lanes, b],
                        k.slots * spr[:, None] < p.n_slots[:, None])
                elif static.policy in ("segment_benefit", "lru"):
                    arr = f.benefit if static.policy == "segment_benefit" \
                        else f.last_use
                    cand = fts_lib.masked_argmin(
                        arr[lanes, b], k.slots < p.n_slots[:, None])
                else:
                    cand = k.zeros
            hit = hit_raw & cacheable & real

            # ---- replacement decision from carried aggregates ------------
            evict_row_b = f.evict_row[lanes, b]
            evict_mask_b = f.evict_mask[lanes, b]
            if row_benefit:
                row_sel, mask_sel = fts_lib.pick_victim_row(
                    None, evict_row_b, evict_mask_b, spr, p.n_slots,
                    new_row=cand)
                bidx = ((row_sel * spr)[:, None] + k.segs).clamp(
                    0, max_slots - 1)
                victim_slot, mask_new = fts_lib.pick_victim_in_row(
                    f.benefit[k.lanes2, b[:, None], bidx.long()], mask_sel,
                    row_sel, spr)
            elif static.policy == "random":
                victim_slot = fts_lib.random_victim(step_id, p.n_slots)
            else:
                victim_slot = cand
            n_valid_b = f.n_valid[lanes, b]
            has_free = n_valid_b < p.n_slots
            free_slot = f.free_list[lanes, b,
                                    n_valid_b.clamp(max=max_slots - 1).long()]

            # ---- insertion policy (consecutive-miss tracker) -------------
            tr_idx = torch.remainder(seg, f.miss_tags.shape[-1])
            tl = tr_idx.long()
            miss_tag_old = f.miss_tags[lanes, b, tl]
            miss_cnt_old = f.miss_cnt[lanes, b, tl]
            cnt_new = torch.where(miss_tag_old == seg, miss_cnt_old + 1, 1)
            want = (p.insert_threshold <= 1) | (cnt_new >= p.insert_threshold)
            # the tracker advances on actual (cacheable) misses only
            advance = real & cacheable & ~hit_raw
            do_ins = ~hit & cacheable & want & real

            # ---- per-(bank, slot) state update ---------------------------
            # exactly one slot w is written per lane (hit slot or landing
            # slot); when nothing happens the write stores back old values
            ins_slot = torch.where(has_free, free_slot, victim_slot)
            w = torch.where(hit, slot, ins_slot)
            wl = w.long()
            old_tag = f.tags[lanes, b, wl]
            old_valid = f.valid[lanes, b, wl]
            old_dirty = f.dirty[lanes, b, wl]
            old_benefit = f.benefit[lanes, b, wl]
            old_last = f.last_use[lanes, b, wl]
            ev_dirty = do_ins & ~has_free & old_valid & old_dirty
            b_touch = torch.minimum(old_benefit + 1, p.benefit_max)
            new_benefit = torch.where(do_ins, 1,
                                      torch.where(hit, b_touch, old_benefit))
            if row_benefit:
                use_victim = do_ins & ~has_free
                new_evict_row = torch.where(use_victim, row_sel, evict_row_b)
                new_evict_mask = torch.where(use_victim[:, None], mask_new,
                                             evict_mask_b)
            else:
                new_evict_row, new_evict_mask = evict_row_b, evict_mask_b
            write = fts_lib.SlotWrite(
                w=w,
                tag=torch.where(do_ins, seg, old_tag),
                valid=old_valid | do_ins,
                dirty=torch.where(do_ins, req.is_write,
                                  old_dirty | (hit & req.is_write)),
                benefit=new_benefit,
                last_use=torch.where(hit | do_ins, step_id, old_last),
                row_delta=new_benefit - old_benefit,
                evict_row=new_evict_row,
                evict_mask=new_evict_mask,
                tr_idx=tr_idx,
                miss_tag=torch.where(advance, seg, miss_tag_old),
                miss_cnt=torch.where(advance, cnt_new, miss_cnt_old),
                n_valid_inc=(do_ins & has_free).to(I32),
            )
            # kernel path: slot == max_slots on a miss; read only under hit
            target_row = torch.where(hit, cache_base + _floordiv(slot, spr),
                                     req.row)
            served_fast = hit & static.fast_cache
        else:
            write = None
            hit = k.false
            target_row = req.row
            served_fast = ~k.false if lldram else k.false

        # ---- service latency (bank-local half) ----------------------------
        rcd = torch.where(served_fast, p.rcd_fast, p.rcd)
        rp = torch.where(served_fast, p.rp_fast, p.rp)
        row_hit = open_b == target_row
        closed = open_b < 0
        pre_act = torch.where(row_hit, 0, rcd + torch.where(closed, 0, rp))

        # ---- relocation cost (miss-path insertion) ------------------------
        if static.has_cache:
            if static.free_reloc:
                reloc_cost = k.zeros
            elif lisa:
                # whole-row relocation, distance-dependent (src row is open)
                reloc_cost = _lisa_hops(req.row, geom) * p.lisa_hop \
                    + p.rcd_fast
                wb_hops = _lisa_hops(old_tag, geom)
                reloc_cost = reloc_cost + torch.where(
                    ev_dirty, wb_hops * p.lisa_hop + p.rcd, 0)
            else:
                # FIGARO: seg_blocks RELOCs through the GRB; the source row
                # is open serving the miss and the destination ACT overlaps
                reloc_cost = p.seg_blocks * p.reloc
                # dirty-victim writeback needs the victim's home row opened
                reloc_cost = reloc_cost + torch.where(
                    ev_dirty, p.seg_blocks * p.reloc + p.rcd, 0)
            reloc_cost = torch.where(do_ins, reloc_cost, 0)
            # after insertion the destination cache row is left open
            new_open = torch.where(
                do_ins, cache_base + _floordiv(ins_slot, spr), target_row)
            moved = torch.where(do_ins, p.seg_blocks, 0)
            wb = torch.where(do_ins & ev_dirty, p.seg_blocks, 0)
            n_ins = do_ins.to(I32)
        else:
            reloc_cost = moved = wb = n_ins = k.zeros
            new_open = target_row

        return Decision(write=write, hit=hit, row_hit=row_hit,
                        served_fast=served_fast, pre_act=pre_act,
                        reloc_cost=reloc_cost, new_open=new_open,
                        moved=moved, wb=wb, n_ins=n_ins)

    return decide


def _check_variant(variant: str):
    if variant not in VARIANTS:
        raise ValueError(f"unknown scan variant {variant!r}; expected one "
                         f"of {VARIANTS}")


def _consts_cache(static: StaticConfig):
    """``consts(req) -> _Consts`` for the device and lane count of ``req``,
    made once per (device, lanes)."""
    max_slots = static.max_slots if static.has_cache else 1
    max_segs = static.max_segs_per_row if static.has_cache else 1
    cache: Dict[tuple, _Consts] = {}

    def consts(req: Trace) -> _Consts:
        key = (req.bank.device, req.bank.shape[0])
        k = cache.get(key)
        if k is None:
            k = cache[key] = _Consts(key[1], key[0], max_slots, max_segs)
        return k

    return consts


def make_step(static: StaticConfig, geom: DRAMGeometry = GEOM,
              variant: str = "fused"):
    """Build the step function for one static structure.

    ``step(params, carry, req) -> carry`` with ``params`` leaves ``(N,)``,
    ``carry = (BankState, Counters, TelScan or None)`` and ``req`` a
    ``Trace`` of ``(N,)`` rows.  The bank state is updated in place; the
    counters are rebuilt (their per-core planes updated in place); with
    ``static.telemetry`` the windows advance after the counters, as in the
    JAX package's step.  ``variant="dense"`` returns the reference body
    (``_make_step_dense``)."""
    _check_variant(variant)
    if variant == "dense":
        return _make_step_dense(static, geom)
    decide = make_decision_fn(static, geom)
    consts = _consts_cache(static)

    def step(params: MechParams, carry, req: Trace):
        state, cnt, tel = carry
        p = params
        k = consts(req)
        lanes = k.lanes
        b = req.bank.long()
        core = req.core.long()
        real = req.t_issue < NOOP_ISSUE
        step_id = cnt.reads + cnt.writes
        dec = decide(params, state, req, step_id, k)

        # ---- channel-shared timing: MSHR closed loop + data bus -----------
        # a core may not have more than N_MSHR requests in flight — it
        # stalls until the request N_MSHR-ago completed
        mshr_slot = state.mshr_idx[lanes, core]
        ms = mshr_slot.long()
        mshr_free = state.mshr_ring[lanes, core, ms]
        t_ready = torch.maximum(req.t_issue, mshr_free)
        busy_b = state.busy[lanes, b]
        open_b = state.open_row[lanes, b]
        t0 = torch.maximum(t_ready, busy_b)
        # the 64 B burst serializes on the shared channel data bus
        done = torch.maximum(t0 + dec.pre_act + p.cas, state.bus_free) + p.bl
        # bank occupancy: column accesses pipeline at tCCD; an ACT(+PRE)
        # occupies the bank for its own duration before the CAS can pipeline
        serv_end = t0 + dec.pre_act + p.ccd

        if dec.write is not None:
            fts_lib.apply_write(state.fts, req.bank, p.segs_per_row,
                                dec.write, lanes)
        state.open_row[lanes, b] = torch.where(real, dec.new_open, open_b)
        state.busy[lanes, b] = torch.where(real, serv_end + dec.reloc_cost,
                                           busy_b)
        state.mshr_ring[lanes, core, ms] = torch.where(real, done, mshr_free)
        state.mshr_idx[lanes, core] = torch.where(
            real, torch.remainder(mshr_slot + 1, N_MSHR), mshr_slot)
        state = state._replace(
            bus_free=torch.where(real, done, state.bus_free))

        # ---- counters ------------------------------------------------------
        act = ((~dec.row_hit) & real).to(I32)
        lat_ns = _floordiv(done - t_ready, 8)
        cnt.lat_sum_ns[lanes, core] += torch.where(real, lat_ns, 0)
        cnt.lat_sum_ns.clamp_(max=LAT_SUM_CAP)
        cnt.req_cnt[lanes, core] += real.to(I32)
        cnt = cnt._replace(
            acts_slow=cnt.acts_slow + act * ~dec.served_fast,
            acts_fast=cnt.acts_fast + act * dec.served_fast,
            reads=cnt.reads + (~req.is_write & real).to(I32),
            writes=cnt.writes + (req.is_write & real).to(I32),
            reloc_blocks=cnt.reloc_blocks + dec.moved,
            wb_blocks=cnt.wb_blocks + dec.wb,
            row_hits=cnt.row_hits + (dec.row_hit & real).to(I32),
            cache_hits=cnt.cache_hits + dec.hit.to(I32),
            insertions=cnt.insertions + dec.n_ins,
            # the request is not retired until its burst clears the shared
            # data bus, which can outlast the bank's own serv_end+reloc
            t_end=torch.maximum(cnt.t_end, torch.where(
                real, torch.maximum(done, serv_end + dec.reloc_cost), 0)),
        )

        # ---- telemetry windows (DESIGN.md §15/§16) ------------------------
        if static.telemetry:
            tel = _telemetry_step(
                tel, static.telemetry, lanes=lanes, real=real, bank=b,
                core=core, is_write=req.is_write, row_hit=dec.row_hit,
                hit=dec.hit, n_ins=dec.n_ins, moved=dec.moved, lat_ns=lat_ns,
                bus_wait=done - (t0 + dec.pre_act + p.cas + p.bl),
                mshr_wait=t_ready - req.t_issue, slo_ns=p.slo_ns,
                step_id=step_id)
        return state, cnt, tel

    return step


def _make_step_dense(static: StaticConfig, geom: DRAMGeometry = GEOM):
    """The pre-aggregate step (DESIGN.md §9 "dense"), the port of the JAX
    package's ``_make_step_dense``: each lane gathers its whole bank's FTS
    row, looks up, advances the miss tracker, inserts with
    ``fts.insert(..., recompute=True)`` (full free-slot argmin and
    segment-summed row benefits), touches, selects among the three stores
    and writes the bank row back whole.  Bitwise-identical to the fused
    body on real requests; it does NOT understand no-op padding (a padding
    request is simulated like any other).  Kept as the equivalence
    reference.  Raises ``ValueError`` with telemetry, which it predates."""
    if static.telemetry:
        raise ValueError(
            "telemetry windows require the fused scan body; the dense "
            "reference predates them (set telemetry=0 or variant='fused')")
    cache_base = geom.n_rows                      # id-space for cache rows
    reserved_sub = geom.n_subarrays - 1           # figcache_slow region
    lisa = static.mechanism == "lisa_villa"
    slow_cache = static.mechanism == "figcache_slow"
    lldram = static.mechanism == "lldram"
    consts = _consts_cache(static)

    def step(params: MechParams, carry, req: Trace):
        state, cnt, tel = carry
        p = params
        spr = p.segs_per_row
        k = consts(req)
        lanes = k.lanes
        b = req.bank.long()
        core = req.core.long()
        fts_b = fts_lib.FTS(*[a[lanes, b] for a in state.fts])
        # closed loop: a core may not have more than N_MSHR requests in
        # flight — it stalls until the request N_MSHR-ago completed
        mshr_slot = state.mshr_idx[lanes, core]
        ms = mshr_slot.long()
        mshr_free = state.mshr_ring[lanes, core, ms]
        t_ready = torch.maximum(req.t_issue, mshr_free)
        t0 = torch.maximum(t_ready, state.busy[lanes, b])
        open_b = state.open_row[lanes, b]
        step_id = cnt.reads + cnt.writes

        # ---- cache lookup -------------------------------------------------
        if static.has_cache:
            seg = req.row * spr + _floordiv(req.col, p.seg_blocks)
            if slow_cache:   # never cache the subarray hosting reserved rows
                cacheable = _floordiv(req.row, geom.rows_per_subarray) \
                    != reserved_sub
            else:
                cacheable = ~k.false
            hit, slot = fts_lib.lookup(fts_b, seg)
            hit = hit & cacheable
            target_row = torch.where(hit, cache_base + _floordiv(slot, spr),
                                     req.row)
        else:
            hit = k.false
            target_row = req.row

        # ---- service latency ---------------------------------------------
        served_fast = (hit & static.fast_cache) | lldram
        rcd = torch.where(served_fast, p.rcd_fast, p.rcd)
        rp = torch.where(served_fast, p.rp_fast, p.rp)
        row_hit = open_b == target_row
        closed = open_b < 0
        pre_act = torch.where(row_hit, 0, rcd + torch.where(closed, 0, rp))
        done = torch.maximum(t0 + pre_act + p.cas, state.bus_free) + p.bl
        serv_end = t0 + pre_act + p.ccd

        # ---- miss path: insert-any-miss (+ optional threshold) ------------
        if static.has_cache:
            # the tracker advances on actual (cacheable) misses only; the
            # hit path is built from the pre-tracker ``fts_b``
            want, fts_miss = fts_lib.should_insert(fts_b, seg,
                                                   p.insert_threshold)
            fts_miss = fts_lib.select(cacheable, fts_miss, fts_b)
            do_ins = ~hit & cacheable & want
            ins = fts_lib.insert(fts_miss, seg, req.is_write, step_id,
                                 policy=static.policy, segs_per_row=spr,
                                 n_slots=p.n_slots, recompute=True)
            if static.free_reloc:
                reloc_cost = k.zeros
            elif lisa:
                # whole-row relocation, distance-dependent (src row is open)
                reloc_cost = _lisa_hops(req.row, geom) * p.lisa_hop \
                    + p.rcd_fast
                wb_hops = _lisa_hops(ins.evicted_tag, geom)
                reloc_cost = reloc_cost + torch.where(
                    ins.evicted_dirty, wb_hops * p.lisa_hop + p.rcd, 0)
            else:
                # FIGARO: seg_blocks RELOCs through the GRB, plus the dirty
                # victim's writeback with its home row opened
                reloc_cost = p.seg_blocks * p.reloc + torch.where(
                    ins.evicted_dirty, p.seg_blocks * p.reloc + p.rcd, 0)
            reloc_cost = torch.where(do_ins, reloc_cost, 0)
            # after insertion the destination cache row is left open
            new_open = torch.where(
                do_ins, cache_base + _floordiv(ins.slot, spr), target_row)
            touched = fts_lib.touch(fts_b, slot, req.is_write, step_id,
                                    p.benefit_max, spr)
            fts_new = fts_lib.select(hit, touched, fts_lib.select(
                do_ins, ins.fts, fts_miss))
            for full, one in zip(state.fts, fts_new):
                full[lanes, b] = one
            moved = torch.where(do_ins, p.seg_blocks, 0)
            wb = torch.where(do_ins & ins.evicted_dirty, p.seg_blocks, 0)
            n_ins = do_ins.to(I32)
        else:
            reloc_cost = moved = wb = n_ins = k.zeros
            new_open = target_row

        state.open_row[lanes, b] = new_open
        state.busy[lanes, b] = serv_end + reloc_cost
        state.mshr_ring[lanes, core, ms] = done
        state.mshr_idx[lanes, core] = torch.remainder(mshr_slot + 1, N_MSHR)
        state = state._replace(bus_free=done)

        # ---- counters ------------------------------------------------------
        act = (~row_hit).to(I32)
        cnt.lat_sum_ns[lanes, core] += _floordiv(done - t_ready, 8)
        cnt.lat_sum_ns.clamp_(max=LAT_SUM_CAP)
        cnt.req_cnt[lanes, core] += 1
        cnt = cnt._replace(
            acts_slow=cnt.acts_slow + act * ~served_fast,
            acts_fast=cnt.acts_fast + act * served_fast,
            reads=cnt.reads + (~req.is_write).to(I32),
            writes=cnt.writes + req.is_write.to(I32),
            reloc_blocks=cnt.reloc_blocks + moved,
            wb_blocks=cnt.wb_blocks + wb,
            row_hits=cnt.row_hits + row_hit.to(I32),
            cache_hits=cnt.cache_hits + hit.to(I32),
            insertions=cnt.insertions + n_ins,
            t_end=torch.maximum(cnt.t_end, torch.maximum(
                done, serv_end + reloc_cost)),
        )
        return state, cnt, tel

    return step


# ---------------------------------------------------------------------------
# layout helpers: JAX-shaped inputs/outputs <-> the port's lane axis

def _lane_trace(trace: Trace, repeats: int, device) -> Trace:
    """(T,)/(C, T) leaves -> contiguous (T, repeats * C) device tensors;
    column ``p * C + c`` is channel ``c``.  Each leaf that comes from the
    host is one copy to the device, counted (``h2d_copies`` /
    ``h2d_bytes``) on every device alike."""
    out = []
    copies = nbytes = 0
    for x, dt in zip(trace, _TRACE_DTYPES):
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(np.asarray(x)))
        host = x.device.type == "cpu"
        x = x.to(device=device, dtype=dt)
        if host:
            copies, nbytes = copies + 1, nbytes + x.nbytes
        x = x[None] if x.dim() == 1 else x
        out.append(x.t().repeat(1, repeats).contiguous())
    obs_trace.count(h2d_copies=copies, h2d_bytes=nbytes)
    return Trace(*out)


def _lane_params(params: MechParams, channels: int, device) -> MechParams:
    """0-d or (P,) leaves -> contiguous (P * channels,) int32 leaves."""
    out = []
    for x in params:
        x = torch.as_tensor(x).to(device=device, dtype=I32).reshape(-1)
        out.append(x.repeat_interleave(channels).contiguous())
    return MechParams(*out)


def _unlane(tree, dims: tuple):
    """Lane-layout counters, cursor or frames (N, ...) -> the JAX
    package's layout ``dims + (...)``."""
    return _map(lambda x: x.reshape(dims + tuple(x.shape[1:])), tree)


def _n_params(params: MechParams) -> Optional[int]:
    x = torch.as_tensor(params[0])
    return None if x.dim() == 0 else int(x.shape[0])


def _check_state(state: SimState, lanes: int):
    got = state.cnt.reads.shape[0]
    if got != lanes:
        raise ValueError(f"state has {got} lanes; this trace and params "
                         f"batch need {lanes}")


def _prepare(trace: Trace, params: MechParams, state: SimState, dev):
    """The trace and params in lane layout on ``dev`` and a clone of
    ``state`` there, over ``P x C`` lanes."""
    C = 1 if np.ndim(trace.t_issue) == 1 else int(trace.t_issue.shape[0])
    P = _n_params(params) or 1
    _check_state(state, P * C)
    with obs_trace.span("replay.prepare"):
        return (_lane_trace(trace, P, dev), _lane_params(params, C, dev),
                clone_state(state, dev))


def clone_state(state: SimState, device) -> SimState:
    """A copy of ``state`` on ``device`` that a replay may update in place."""
    return _map(lambda x: x.to(device).clone(), state)


def _open(static: StaticConfig, st: SimState, T: int) -> Optional[TelScan]:
    """The packed telemetry carry of a T-step segment (None without
    telemetry).  A telemetry replay needs the cursor ``sim_init`` makes."""
    if not static.telemetry:
        return None
    if st.tel is None:
        raise ValueError("a telemetry replay needs SimState.tel: make the "
                         "state with sim_init of the telemetry config")
    return _tel_open(st.tel, T, static.telemetry)


def _close(st: SimState, tel: Optional[TelScan], with_frames: bool):
    if tel is not None:
        cursor, frames = _tel_close(tel)
        st = st._replace(tel=cursor)
    else:
        frames = None
    return (st, frames) if with_frames else st


def _advance_eager(trace: Trace, static: StaticConfig, params: MechParams,
                   state: SimState, variant: str = "fused",
                   device=None, with_frames: bool = False):
    """Clone ``state`` to ``device`` and run every request of ``trace``
    (leaves (T,)/(C, T)) through the eager step, one request at a time:
    the CPU path, and the replay kernel's plain version on the card.
    Returns the new ``SimState``, or ``(SimState, frames)`` in lane layout
    (``None`` without telemetry) with ``with_frames``."""
    dev = resolve_device(device)
    step = make_step(static, variant=variant)
    tr, lp, st = _prepare(trace, params, state, dev)
    T = tr.t_issue.shape[0]
    carry = (st.bank, st.cnt, _open(static, st, T))
    with obs_trace.span("replay.run"):
        for t in range(T):
            carry = step(lp, carry, Trace(*(f[t] for f in tr)))
    return _close(SimState(carry[0], carry[1], st.tel), carry[2],
                  with_frames)


def _advance(trace: Trace, static: StaticConfig, params: MechParams,
             state: SimState, variant: str, device,
             with_frames: bool = False):
    """Clone ``state`` to ``device`` and replay ``trace`` over it: one
    ``sim_scan`` launch on a CUDA device (its telemetry instantiation when
    ``static.telemetry`` is set), the eager loop on the CPU and for the
    ``dense`` body on every device.  Counts the replay in ``REPLAYS``;
    returns as ``_advance_eager`` does."""
    _check_variant(variant)
    dev = resolve_device(device)
    route = "sim_scan" if dev.type == "cuda" and variant == "fused" \
        else "eager"
    REPLAYS.log(f"{route}/{variant}/{static.mechanism}/{static.policy}/"
                f"{np.shape(trace.t_issue)[-1]}x{state.cnt.reads.shape[0]}")
    if route == "eager":
        return _advance_eager(trace, static, params, state, variant, dev,
                              with_frames)
    tr, lp, st = _prepare(trace, params, state, dev)
    tel = _open(static, st, tr.t_issue.shape[0])
    with obs_trace.span("replay.run"):
        sim_scan(tr, lp, st.bank, st.cnt, static, GEOM, tel)
    return _close(st, tel, with_frames)


def sim_init(static: StaticConfig, geom: DRAMGeometry = GEOM,
             channels: int | None = None, batch: int | None = None,
             device=None) -> SimState:
    """Fresh replay state with ``(batch or 1) * (channels or 1)`` lanes,
    lane ``p * C + c`` for params point ``p`` on channel ``c``."""
    lanes = (batch or 1) * (channels or 1)
    with obs_trace.span("replay.init"):
        return SimState(bank=init_state(static, geom, lanes, device),
                        cnt=init_counters(geom, lanes, device),
                        tel=init_telemetry(geom, lanes, device)
                        if static.telemetry else None)


def finalize(state: SimState) -> Counters:
    """End a replay: the final ``Counters``, in lane layout ``(N, ...)``."""
    return state.cnt


def resume(trace: Trace, static: StaticConfig, params: MechParams,
           state: SimState, variant: str = "fused",
           device=None) -> SimState:
    """One segment of a chunked replay: advance ``state`` over ``trace``
    ((T,) or (C, T) leaves).  ``params`` leaves are 0-d (one config) or
    ``(P,)``; ``state`` must then hold ``P * C`` lanes.  The input state is
    not modified."""
    return _advance(trace, static, params, state, variant, device)


def _lead(trace: Trace, params: MechParams) -> tuple:
    """The JAX package's lead axes of a segment: ``(P,)`` for batched
    params, then ``(C,)`` for a multi-channel trace."""
    P = _n_params(params)
    C = int(trace.t_issue.shape[0]) if np.ndim(trace.t_issue) == 2 else None
    return tuple(d for d in (P, C) if d is not None)


def resume_tel(trace: Trace, static: StaticConfig, params: MechParams,
               state: SimState, variant: str = "fused", device=None):
    """Telemetry segment: like ``resume`` but returns ``(SimState,
    TelemetryFrame)``, the frame's leaves ``(W, ...)``, ``(C, W, ...)``,
    ``(P, W, ...)`` or ``(P, C, W, ...)`` as the JAX package lays them out
    (the state stays in lane layout).  Requires ``static.telemetry > 0``."""
    if static.telemetry <= 0:
        raise ValueError("resume_tel needs StaticConfig.telemetry > 0 "
                         "(the window period in real requests)")
    st, frames = _advance(trace, static, params, state, variant, device,
                          with_frames=True)
    return st, _unlane(frames, _lead(trace, params))


def sweep_resume_tel(trace: Trace, static: StaticConfig,
                     params_batch: MechParams, state: SimState,
                     variant: str = "fused", device=None):
    """Batched telemetry segment: ``resume_tel`` over params leaves
    ``(P,)``, frame leaves ``(P, [C,] W, ...)``."""
    if static.telemetry <= 0:
        raise ValueError("sweep_resume_tel needs StaticConfig.telemetry > 0 "
                         "(the window period in real requests)")
    if _n_params(params_batch) is None:
        raise ValueError("sweep_resume_tel needs params leaves with a (P,) "
                         "axis")
    return resume_tel(trace, static, params_batch, state, variant, device)


def simulate(trace: Trace, static: StaticConfig, params: MechParams,
             variant: str = "fused", device=None) -> Counters:
    """One params point over a (T,) or (C, T) trace; counters shaped like
    the JAX package's (scalars, or a leading (C,) axis)."""
    multi = np.ndim(trace.t_issue) == 2
    C = int(trace.t_issue.shape[0]) if multi else None
    state = sim_init(static, channels=C, device=device)
    cnt = finalize(_advance(trace, static, params, state, variant, device))
    return _unlane(cnt, (C,) if multi else ())


def run_sweep(trace: Trace, static: StaticConfig, params_batch: MechParams,
              variant: str = "fused", device=None) -> Counters:
    """A whole config grid sharing one static structure in one replay:
    ``params_batch`` leaves are ``(P,)``; counters come back ``(P, ...)``
    or ``(P, C, ...)`` for multi-channel traces, bitwise-equal to running
    each point through ``run_channel``."""
    multi = np.ndim(trace.t_issue) == 2
    C = int(trace.t_issue.shape[0]) if multi else None
    P = _n_params(params_batch)
    if P is None:
        raise ValueError("run_sweep needs params leaves with a (P,) axis")
    state = sim_init(static, channels=C, batch=P, device=device)
    cnt = finalize(_advance(trace, static, params_batch, state, variant,
                            device))
    return _unlane(cnt, (P, C) if multi else (P,))


def run_channel(trace: Trace, cfg: MechConfig, t: DRAMTimings = DDR4,
                device=None) -> Counters:
    """Simulate one channel's request stream ((T,) trace leaves)."""
    return simulate(trace, cfg.static, cfg.params(t, device), device=device)


def run_channels(traces: Trace, cfg: MechConfig, t: DRAMTimings = DDR4,
                 device=None) -> Counters:
    """Simulate C independent channels: traces leaves shaped (C, T)."""
    return simulate(traces, cfg.static, cfg.params(t, device), device=device)


def run_channel_exact(trace: Trace, cfg: MechConfig, t: DRAMTimings = DDR4,
                      device=None) -> Counters:
    """Unpadded reference run: FTS allocated at exactly ``cfg.n_slots``
    (``max == actual``).  Handles (T,) and (C, T) traces alike."""
    return simulate(trace, cfg.exact_static, cfg.params(t, device),
                    device=device)
