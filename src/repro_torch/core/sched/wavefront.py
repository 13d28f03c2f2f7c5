"""Bank-wavefront execution of the DRAM simulator, PyTorch port of
``repro.core.sched.wavefront`` (DESIGN.md §10).

Requests to *distinct banks* are independent in the bank-local half of the
model (FTS decision, row-buffer outcome, relocation cost) and couple only
through the thin channel-shared state (data bus, MSHR rings):

 * ``form_waves`` — the host-side **compile pass** (numpy, a copy of the
   JAX package's): groups a (scheduled) trace into *waves*, maximal
   order-preserving runs of requests to distinct banks, padded to a fixed
   width ``W`` with no-op requests that take the wave's **unused** banks
   (every wave's bank column holds ``W`` distinct banks, so scatters are
   deterministic and no-op lanes write their own untouched bank back).
   ``linearize_waves``, ``wave_stats`` and ``pad_waves`` go with it.
 * ``make_wave_step`` — one eager step consumes a whole wave: the serial
   step's own ``dram.make_decision_fn`` over the ``W`` requests of every
   lane, each reading a view of its own bank, and the channel-shared half
   (bus serialization, MSHR closed loop) resolved by the **in-wave ordered
   prefix** in closed form (per-core prefix counts locate each lane's
   pre-wave MSHR slot, a ``cummax`` unrolls the bus recurrence).

The serial scan on ``linearize_waves(wtrace)`` is the wave scan's bitwise
oracle (JAX package, ``tests/test_sched.py``).  So where a wave replay
runs follows the state's device, as ``dram._advance`` does, with no
fallback:

* on a CUDA device ``resume_waves`` and the entry points built on it
  replay the linearized trace through ``dram.resume``: ONE ``sim_scan``
  launch per call;
* on the CPU they run the eager wave step, one step per wave: the wave
  route's plain version.

Telemetry windows are refused under wavefront execution, as in the JAX
package.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from repro_torch.core import dram
from repro_torch.core import fts as fts_lib
from repro_torch.core.dram import host_array
from repro_torch.core.timing import (DDR4, GEOM, DRAMGeometry, DRAMTimings,
                                     MechConfig, MechParams, StaticConfig)
from repro_torch.device import resolve_device

__all__ = ["form_waves", "linearize_waves", "wave_stats", "make_wave_step",
           "pad_waves", "resume_waves", "simulate_waves", "run_sweep_waves",
           "run_channel_waves"]

I32 = torch.int32

# Default wave width: half the banks.  Wider waves raise the padded-lane
# gather/scatter cost faster than occupancy (workload windows rarely hold
# more than ~7 distinct banks); 8 is the measured sweet spot on the paper
# workloads.  ``form_waves(width=...)`` overrides per call.
DEFAULT_WIDTH = 8


def _form_channel(t: np.ndarray, bank: np.ndarray, core: np.ndarray,
                  width: int, n_banks: int,
                  lookahead: int) -> List[List[int]]:
    """Greedy wave formation for one channel.  No-op requests are dropped
    (inert by the DESIGN.md §9 contract).

    ``lookahead = 0`` is strictly order-preserving: a wave closes when it
    is full or when its next request's bank repeats, so the linearized
    wave order IS the input order (the FCFS-bitwise case).

    ``lookahead > 0`` models the controller's bank-level parallelism: the
    oldest request of any bank not yet in the wave may be pulled forward
    past blocked (same-bank) requests, from a transaction-queue window of
    ``lookahead`` pending requests.  Per-bank FIFO order is preserved by
    construction (the window is walked oldest-first), so the linearized
    wave order is a bounded reordering — exactly what a controller that
    issues to ready banks out of order produces.  The serial oracle for a
    lookahead trace is the linearized order (``linearize_waves``).

    Waves additionally take at most ``dram.N_MSHR`` requests per core —
    a core cannot have more in flight anyway — which lets the wave step
    resolve every MSHR read from pre-wave state.
    """
    idxs = np.flatnonzero(t < dram.NOOP_ISSUE).tolist()
    bl, cl = bank.tolist(), core.tolist()
    waves: List[List[int]] = []
    cur: List[int] = []
    used = [False] * n_banks
    core_cnt: dict = {}
    if lookahead <= 0:
        for i in idxs:
            b = bl[i]
            if used[b] or len(cur) == width \
                    or core_cnt.get(cl[i], 0) >= dram.N_MSHR:
                waves.append(cur)
                cur = []
                used = [False] * n_banks
                core_cnt = {}
            cur.append(i)
            used[b] = True
            core_cnt[cl[i]] = core_cnt.get(cl[i], 0) + 1
        if cur:
            waves.append(cur)
        return waves
    win = idxs[:lookahead]
    nxt = min(lookahead, len(idxs))
    while win:
        pick = None
        if len(cur) < width:
            blocked = list(used)
            for k, i in enumerate(win):
                b = bl[i]
                if blocked[b]:
                    continue
                if core_cnt.get(cl[i], 0) >= dram.N_MSHR:
                    # the skipped lane's bank must block for the rest of
                    # the wave, or a younger same-bank request would be
                    # pulled past it (per-bank FIFO is the contract)
                    blocked[b] = True
                    continue
                pick = k
                break
        if pick is None:               # wave full or every window bank busy
            waves.append(cur)
            cur = []
            used = [False] * n_banks
            core_cnt = {}
            continue
        i = win.pop(pick)
        cur.append(i)
        used[bl[i]] = True
        core_cnt[cl[i]] = core_cnt.get(cl[i], 0) + 1
        if nxt < len(idxs):
            win.append(idxs[nxt])
            nxt += 1
    if cur:
        waves.append(cur)
    return waves


def _emit_channel(leaves: dict, waves: List[List[int]], n_waves: int,
                  width: int, n_banks: int) -> dict:
    """Materialize one channel's (n_waves, width) wave-major arrays.
    Padding lanes take the wave's unused banks (distinct from every real
    lane's bank), ``t_issue = NOOP_ISSUE`` and neutral fields."""
    out = {
        "t_issue": np.full((n_waves, width), dram.NOOP_ISSUE, np.int32),
        "bank": np.zeros((n_waves, width), np.int32),
        "row": np.zeros((n_waves, width), np.int32),
        "col": np.zeros((n_waves, width), np.int32),
        "is_write": np.zeros((n_waves, width), bool),
        "core": np.zeros((n_waves, width), np.int32),
    }
    # all-noop filler waves (ragged channel counts) use banks 0..width-1
    out["bank"][:] = np.arange(width, dtype=np.int32)
    for w, members in enumerate(waves):
        k = len(members)
        for name in out:
            out[name][w, :k] = leaves[name][members]
        used = set(leaves["bank"][members].tolist())
        pads = [b for b in range(n_banks) if b not in used][:width - k]
        out["bank"][w, k:] = np.asarray(pads, np.int32)
    return out


def form_waves(trace: dram.Trace, width: int | None = None,
               lookahead: int = 0,
               geom: DRAMGeometry = GEOM) -> dram.Trace:
    """Compile a (T,) / (C, T) trace into wave-major (n_waves, W) /
    (C, n_waves, W) leaves for the wave scan.

    ``width`` defaults to ``DEFAULT_WIDTH`` (a wave can never hold two
    requests to one bank, so ``geom.n_banks`` caps it); any ``width <=
    geom.n_banks`` is valid and trades wave occupancy against per-step
    padding work.  ``lookahead = 0`` preserves the input service order
    exactly (bitwise FCFS oracle); ``lookahead > 0`` pulls requests of
    idle banks forward from a bounded transaction-queue window (bank-level
    parallelism — see ``_form_channel``), with the linearized wave order
    (``linearize_waves``) as the serial oracle.  Channels are formed
    independently and padded to a shared wave count with all-no-op waves.
    """
    W = min(DEFAULT_WIDTH, geom.n_banks) if width is None else width
    assert 1 <= W <= geom.n_banks, (W, geom.n_banks)
    t = host_array(trace.t_issue)
    leaves = {name: host_array(x) for name, x in trace._asdict().items()}
    if t.ndim == 1:
        waves = _form_channel(t, leaves["bank"], leaves["core"], W,
                              geom.n_banks, lookahead)
        out = _emit_channel(leaves, waves, max(len(waves), 1), W,
                            geom.n_banks)
        return dram.Trace(**out)
    per_chan = [_form_channel(t[c], leaves["bank"][c], leaves["core"][c],
                              W, geom.n_banks, lookahead)
                for c in range(t.shape[0])]
    n_waves = max(1, max(len(w) for w in per_chan))
    chans = [_emit_channel({k: v[c] for k, v in leaves.items()},
                           per_chan[c], n_waves, W, geom.n_banks)
             for c in range(t.shape[0])]
    return dram.Trace(**{k: np.stack([ch[k] for ch in chans])
                         for k in chans[0]})


def linearize_waves(wtrace: dram.Trace) -> dram.Trace:
    """Flatten a wave-compiled trace back into the serial service order the
    wave scan implements (wave-major, pads dropped; multi-channel outputs
    are right-padded with no-ops to the longest channel).  The serial scan
    on this trace is the bitwise oracle of the wave scan on ``wtrace`` —
    for ``lookahead = 0`` formations it equals the input order."""
    t = host_array(wtrace.t_issue)
    leaves = {name: host_array(x) for name, x in wtrace._asdict().items()}
    if t.ndim == 2:
        flat = {k: v.reshape(-1) for k, v in leaves.items()}
        keep = np.flatnonzero(flat["t_issue"] < dram.NOOP_ISSUE)
        return dram.Trace(**{k: v[keep] for k, v in flat.items()})
    chans = [linearize_waves(dram.Trace(
        **{k: v[c] for k, v in leaves.items()})) for c in range(t.shape[0])]
    t_max = max(c.t_issue.shape[0] for c in chans)
    chans = [dram.noop_pad(c, t_max) for c in chans]
    return dram.Trace(*[np.stack([getattr(c, f) for c in chans])
                        for f in dram.Trace._fields])


def wave_stats(wtrace: dram.Trace) -> dict:
    """Occupancy of a wave-compiled trace: how many scan steps it saved."""
    t = host_array(wtrace.t_issue)
    real = int((t < dram.NOOP_ISSUE).sum())
    n_waves = int(np.prod(t.shape[:-1]))
    return {
        "n_requests": real,
        "n_waves": n_waves,
        "width": int(t.shape[-1]),
        "mean_fill": round(real / max(n_waves, 1), 2),
    }


def _bank_view(state: dram.BankState, rows: torch.Tensor,
               has_cache: bool) -> dram.BankState:
    """What ``decide`` reads of lane ``i``'s bank ``bank[i, w]``, as a
    state of ``N * W`` lanes with one bank each (the bank-0 view);
    ``rows`` holds ``i * n_banks + bank[i, w]``, flattened."""
    def one(x):
        rest = tuple(x.shape[2:])
        return x.reshape((-1,) + rest).index_select(0, rows).reshape(
            (-1, 1) + rest)
    fts = fts_lib.FTS(*[one(x) for x in state.fts]) if has_cache else None
    return dram.BankState(open_row=one(state.open_row), busy=None, fts=fts,
                          mshr_ring=None, mshr_idx=None, bus_free=None)


class _WaveConsts:
    """Per-(device, N, W) index tensors a wave step reuses."""

    def __init__(self, n: int, w: int, device, max_slots: int,
                 max_segs: int):
        self.lane = torch.arange(n, device=device)[:, None]
        self.lane_flat = torch.arange(n, device=device).repeat_interleave(w)
        pos = torch.arange(w, device=device)
        self.earlier = pos[:, None] > pos[None, :]       # [w, v]: v before w
        self.bank0 = torch.zeros(n * w, dtype=I32, device=device)
        self.inner = dram._Consts(n * w, device, max_slots, max_segs)


def make_wave_step(static: StaticConfig, geom: DRAMGeometry = GEOM):
    """Build the eager wave step: ``step(params, carry, wave) -> carry``
    with ``params`` leaves ``(N,)``, ``carry = (BankState, Counters)`` over
    N lanes (``dram.make_step``'s carry, updated in place) and ``wave``
    leaves ``(N, W)``: each lane's W distinct-bank requests in service
    order."""
    # the JAX wave body always takes the inline lookup (the fused op's bank
    # selection does not vmap); both give the same counters bit for bit
    static = dataclasses.replace(static, fts_kernel=False)
    decide = dram.make_decision_fn(static, geom)
    has_cache = static.has_cache
    max_slots = static.max_slots if has_cache else 1
    max_segs = static.max_segs_per_row if has_cache else 1
    consts = {}

    def step(params: MechParams, carry, wave: dram.Trace):
        state, cnt = carry
        p = params
        n, W = wave.bank.shape
        key = (wave.bank.device, n, W)
        k = consts.get(key)
        if k is None:
            k = consts[key] = _WaveConsts(n, W, wave.bank.device, max_slots,
                                          max_segs)
        lane = k.lane
        b = wave.bank.long()
        core = wave.core.long()
        real = wave.t_issue < dram.NOOP_ISSUE
        reali = real.to(I32)
        # step_id = retired-real count before each lane (serial semantics)
        k_inc = torch.cumsum(reali, dim=1, dtype=I32)
        step_ids = (cnt.reads + cnt.writes)[:, None] + k_inc - reali

        # ---- bank-local half: the serial decision fn over N * W lanes -----
        view = _bank_view(state, (lane * geom.n_banks + b).reshape(-1),
                          has_cache)
        req = dram.Trace(*(x.reshape(-1) for x in wave))._replace(
            bank=k.bank0)
        pw = MechParams(*(x.repeat_interleave(W) for x in p))
        dec = decide(pw, view, req, step_ids.reshape(-1), k.inner)

        def lanes_w(x):
            return x.reshape(n, W)

        pre_act, reloc_cost = lanes_w(dec.pre_act), lanes_w(dec.reloc_cost)

        # ---- channel-shared half: the in-wave ordered prefix, closed form.
        #  * MSHR — wave formation caps same-core lanes at N_MSHR, so every
        #    lane's ring read refers to PRE-wave state: its slot is the
        #    pre-wave cursor advanced by the count of earlier same-core
        #    real lanes (m), never a slot written in this wave.
        #  * bus — each real lane applies done = max(a, bus) + bl; unrolling
        #    the composition gives done_i = max(bus0, max_{real j<=i}(a_j +
        #    (1 - K_j) * bl)) + K_i * bl with K = cumsum(real), a cummax.
        m = (k.earlier & (core[:, :, None] == core[:, None, :])
             & real[:, None, :]).sum(dim=-1, dtype=I32)
        mshr_slot = torch.remainder(state.mshr_idx[lane, core] + m,
                                    dram.N_MSHR)
        mshr_free = state.mshr_ring[lane, core, mshr_slot.long()]
        t_ready = torch.maximum(wave.t_issue, mshr_free)
        # distinct banks per wave: every lane's bank busy is pre-wave
        busy_b = state.busy[lane, b]
        t0 = torch.maximum(t_ready, busy_b)
        a = t0 + pre_act + p.cas[:, None]
        bl = p.bl[:, None]
        g = torch.where(real, a + (1 - k_inc) * bl, -fts_lib.BIG)
        done = torch.maximum(state.bus_free[:, None],
                             torch.cummax(g, dim=1).values) + k_inc * bl
        serv_end = t0 + pre_act + p.ccd[:, None]
        busy_new = serv_end + reloc_cost
        lat_ns = dram._floordiv(done - t_ready, 8)

        # ---- scatters: every wave has W *distinct* banks, and only real
        # lanes write the MSHR rings (a pad may name a real lane's slot)
        if has_cache:
            fts_lib.apply_write(state.fts, wave.bank.reshape(-1),
                                pw.segs_per_row, dec.write, k.lane_flat)
        state.open_row[lane, b] = torch.where(real, lanes_w(dec.new_open),
                                              state.open_row[lane, b])
        state.busy[lane, b] = torch.where(real, busy_new, busy_b)
        sel = real.nonzero(as_tuple=True)
        state.mshr_ring[sel[0], core[sel], mshr_slot[sel].long()] = done[sel]
        state.mshr_idx.scatter_add_(1, core, reali)
        state.mshr_idx.remainder_(dram.N_MSHR)
        state = state._replace(bus_free=torch.maximum(
            state.bus_free, g.max(dim=1).values) + k_inc[:, -1] * p.bl)

        def isum(x):
            return x.sum(dim=1, dtype=I32)

        row_hit, fast = lanes_w(dec.row_hit), lanes_w(dec.served_fast)
        act = ~row_hit & real
        cnt = dram.Counters(
            acts_slow=cnt.acts_slow + isum(act & ~fast),
            acts_fast=cnt.acts_fast + isum(act & fast),
            reads=cnt.reads + isum(~wave.is_write & real),
            writes=cnt.writes + isum(wave.is_write & real),
            reloc_blocks=cnt.reloc_blocks + isum(lanes_w(dec.moved)),
            wb_blocks=cnt.wb_blocks + isum(lanes_w(dec.wb)),
            row_hits=cnt.row_hits + isum(row_hit & real),
            cache_hits=cnt.cache_hits + isum(lanes_w(dec.hit)),
            insertions=cnt.insertions + isum(lanes_w(dec.n_ins)),
            # one clamp per wave, as the JAX wave body saturates
            lat_sum_ns=cnt.lat_sum_ns.scatter_add(
                1, core, torch.where(real, lat_ns, 0)).clamp_(
                    max=dram.LAT_SUM_CAP),
            req_cnt=cnt.req_cnt.scatter_add(1, core, reali),
            t_end=torch.maximum(cnt.t_end, torch.where(
                real, torch.maximum(done, busy_new), 0).max(dim=1).values),
        )
        return state, cnt

    return step


def pad_waves(wtrace: dram.Trace, n_waves: int) -> dram.Trace:
    """Right-pad a wave-compiled (n, W) / (C, n, W) trace to ``n_waves``
    waves with all-no-op filler waves (banks 0..W-1, inert by the §9
    contract).  Chunked wavefront replay pads every chunk's wave count to
    a shared bucket so all chunks reuse one compiled wave scan
    (``core/streaming.py``)."""
    t = host_array(wtrace.t_issue)
    cur, W = t.shape[-2], t.shape[-1]
    assert cur <= n_waves, (cur, n_waves)
    if cur == n_waves:
        return wtrace
    lead = t.shape[:-2]
    fill = {
        "t_issue": np.full(lead + (n_waves - cur, W), dram.NOOP_ISSUE,
                           np.int32),
        "bank": np.broadcast_to(np.arange(W, dtype=np.int32),
                                lead + (n_waves - cur, W)).copy(),
        "row": np.zeros(lead + (n_waves - cur, W), np.int32),
        "col": np.zeros(lead + (n_waves - cur, W), np.int32),
        "is_write": np.zeros(lead + (n_waves - cur, W), bool),
        "core": np.zeros(lead + (n_waves - cur, W), np.int32),
    }
    return dram.Trace(**{
        k: np.concatenate([host_array(v), fill[k]], axis=-2)
        for k, v in wtrace._asdict().items()})



def _lane_waves(wtrace: dram.Trace, repeats: int, device) -> dram.Trace:
    """(n_waves, W)/(C, n_waves, W) leaves -> contiguous (n_waves,
    repeats * C, W) tensors on ``device``; lane ``p * C + c`` is channel
    ``c``, as ``dram._lane_trace`` lays lanes out."""
    out = []
    for x, dt in zip(wtrace, dram._TRACE_DTYPES):
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(np.asarray(x)))
        x = x.to(device=device, dtype=dt)
        x = x[None] if x.dim() == 2 else x
        out.append(x.transpose(0, 1).repeat(1, repeats, 1).contiguous())
    return dram.Trace(*out)


def _advance_waves_eager(wtrace: dram.Trace, static: StaticConfig,
                         params: MechParams, state: dram.SimState,
                         device) -> dram.SimState:
    """Clone ``state`` to ``device`` and run every wave of ``wtrace``
    through the eager wave step: the CPU path, and the wave route's plain
    version on the card."""
    dev = resolve_device(device)
    C = 1 if wtrace.t_issue.ndim == 2 else int(wtrace.t_issue.shape[0])
    P = dram._n_params(params) or 1
    dram._check_state(state, P * C)
    wt = _lane_waves(wtrace, P, dev)
    lp = dram._lane_params(params, C, dev)
    step = make_wave_step(static)
    carry = tuple(dram.clone_state(state, dev))[:2]
    for i in range(wt.t_issue.shape[0]):
        carry = step(lp, carry, dram.Trace(*(f[i] for f in wt)))
    return dram.SimState(*carry)


def resume_waves(wtrace: dram.Trace, static: StaticConfig,
                 params: MechParams, state: dram.SimState,
                 device=None) -> dram.SimState:
    """Advance a ``dram.SimState`` over one wave-compiled chunk ((n, W) or
    (C, n, W) leaves).  The wave step's carry IS ``dram.SimState``, so a
    wavefront replay chunks exactly like the serial one: ``dram.sim_init``
    -> ``resume_waves`` per chunk -> ``dram.finalize``.  On a CUDA device
    one ``sim_scan`` launch replays ``linearize_waves(wtrace)``; on the CPU
    the eager wave step runs.  The input state is not modified."""
    if static.telemetry:
        # the wave route carries (bank, cnt) only; refuse rather than lie
        raise ValueError("telemetry windows are not supported under "
                         "wavefront execution (set telemetry=0)")
    dev = resolve_device(device)
    if dev.type == "cuda":
        return dram.resume(linearize_waves(wtrace), static, params, state,
                           device=dev)
    return _advance_waves_eager(wtrace, static, params, state, dev)


def _channels(wtrace: dram.Trace):
    return int(wtrace.t_issue.shape[0]) if wtrace.t_issue.ndim == 3 else None


def simulate_waves(wtrace: dram.Trace, static: StaticConfig,
                   params: MechParams, device=None) -> dram.Counters:
    """One params point over a wave-compiled trace ((n, W) or (C, n, W)
    leaves); counters shaped like ``dram.simulate``'s."""
    C = _channels(wtrace)
    state = dram.sim_init(static, channels=C, device=device)
    cnt = dram.finalize(resume_waves(wtrace, static, params, state, device))
    return dram._unlane(cnt, () if C is None else (C,))


def run_sweep_waves(wtrace: dram.Trace, static: StaticConfig,
                    params_batch: MechParams, device=None) -> dram.Counters:
    """Wavefront counterpart of ``dram.run_sweep``: a stacked params batch
    (leaves ``(P,)``) over one wave-compiled trace.  Counters are
    bitwise-equal to ``dram.run_sweep`` on the trace the waves were formed
    from."""
    C = _channels(wtrace)
    P = dram._n_params(params_batch)
    if P is None:
        raise ValueError("run_sweep_waves needs params leaves with a (P,) "
                         "axis")
    state = dram.sim_init(static, channels=C, batch=P, device=device)
    cnt = dram.finalize(resume_waves(wtrace, static, params_batch, state,
                                     device))
    return dram._unlane(cnt, (P,) if C is None else (P, C))


def run_channel_waves(trace: dram.Trace, cfg: MechConfig,
                      t: DRAMTimings = DDR4, width: int | None = None,
                      device=None) -> dram.Counters:
    """Form waves for ``trace`` and simulate one config — the wavefront
    analogue of ``dram.run_channel`` / ``run_channels``."""
    return simulate_waves(form_waves(trace, width=width), cfg.static,
                          cfg.params(t, device), device=device)
