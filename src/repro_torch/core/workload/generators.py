"""Device trace synthesis: every request of a workload batch in parallel.
PyTorch port of ``repro.core.workload.generators`` (DESIGN.md §11).

Each scenario family is written so that a whole trace materializes from
tensor ops over the request index, on the CUDA device by default:

 * **counter-based draws** — every random number is a pure function of
   (seed, core, tag, request or id index) through ``rng.threefry2x32``,
   the same hash and key tree as the JAX package's ``jax.random``, so the
   uniforms are bitwise the JAX package's;
 * **prefix structure** — what the numpy model carries as mutable state
   (visit boundaries, per-context counters, arrival clocks) becomes integer
   ``cumsum`` / ``cummax`` (exact) and the f32 ``rng.cumsum_f32`` (XLA's
   CPU addition order);
 * **channel assembly** — per-core streams hash to channels and banks,
   sort by (channel, arrival) and truncate; an under-filled channel is
   completed with no-op requests (``dram.NOOP_ISSUE``).

Transcendentals (``log1p``, ``log``, ``exp``, ``pow``) are the JAX
package's own f32 routines (``xla_math``: XLA's inline polynomials with
its fused multiply-adds, and glibc's ``powf``), in torch ops that give one
value per input on every device and at every position in a batch.  The
``u * (n ** s - 1) + 1`` of the Zipf inversion is one ``fmaf``, as XLA
contracts it.  Every field of every family is bitwise the JAX package's
(``tests/test_torch_workload.py``).

One generator structure is built per ``WorkloadSpec.static_key``;
``generate_many`` runs the specs of one structure as one batch over a
workload axis ``(W, n_cores)``, bitwise equal to per-spec ``generate``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Iterator, List, Sequence

import numpy as np
import torch

from repro_torch.core.dram import NOOP_ISSUE, Trace, host_array
from repro_torch.core.timing import GEOM, DRAMGeometry
from repro_torch.core.workload import rng
from repro_torch.core.workload.params import (MAX_CONTEXTS, SEG16, SPR,
                                              WorkloadParams, WorkloadSpec)
from repro_torch.core.workload.xla_math import (exp_f32, fma_f32, log1p_f32,
                                                log_f32, pow_f32)
from repro_torch.device import resolve_device

I32 = torch.int32
F32 = torch.float32

# Every generator structure built appends a tag here (the workload mirror
# of ``dram.JIT_TRACE_LOG`` in the JAX package): tests assert "one
# generator per static structure", benchmarks report the count.
GEN_TRACE_LOG: List[str] = []


def gen_trace_count() -> int:
    return len(GEN_TRACE_LOG)


# ---------------------------------------------------------------------------
# counter-based draw helpers.  ``key`` is (B, 2): one key per core lane;
# knobs are (B, 1) columns; per-request tensors are (B, n).

def _uniforms(key, n: int, tag: int, m: int):
    """``(B, n, m)`` iid per-request uniforms: row i is request i's draw."""
    return rng.uniform(rng.fold_in(key, tag), (n, m))


def _id_uniforms(key, ids, tag: int, m: int):
    """Uniforms keyed on (key, tag, id_i), ``(B, n, m)``: visit- and
    window-level draws that are equal for every request sharing an id."""
    k = rng.fold_in(key, tag)
    return rng.uniform(rng.fold_in(k[:, None, :], ids), (m,))


def _zipf_from_u(u, n_pages, a):
    """Bounded-Zipf(a) rank sample via the continuous inverse CDF (ranks
    1..n; returns 0-based page ids).  The a ~ 1 singularity takes the log
    form.  The f32 operations keep the JAX package's order, and
    ``u * (n ** s - 1) + 1`` is the one ``fmaf`` XLA contracts it to."""
    n = n_pages.to(F32)
    one_m = 1.0 - a
    near1 = torch.abs(one_m) < 1e-3
    safe = torch.where(near1, torch.ones_like(one_m), one_m)
    k_pow = pow_f32(fma_f32(u, pow_f32(n, safe) - 1.0, 1.0), 1.0 / safe)
    k_log = exp_f32(u * log_f32(n))
    k = torch.where(near1, k_log, k_pow)
    return torch.minimum(torch.clamp_min(k.to(I32) - 1, 0), n_pages - 1)


def _burst_times(u, idx, p: WorkloadParams):
    """Arrival clock: one exponential gap (mean ``interarrival * burst``)
    at each burst boundary, zero within; f32 ticks."""
    burst = torch.clamp_min(p.burst, 1)
    gap = -log1p_f32(-torch.clamp_max(u, 0.999999)) \
        * p.interarrival * burst.to(F32)
    gap = torch.where(torch.remainder(idx, burst) == 0, gap,
                      torch.zeros_like(gap))
    return rng.cumsum_f32(gap)


def _columns(p: WorkloadParams) -> WorkloadParams:
    """(B,) knob leaves -> (B, 1) columns that broadcast over requests."""
    return WorkloadParams(*[x[:, None] for x in p])


def _index(key, n: int):
    return torch.arange(n, dtype=I32, device=key.device)[None]


# ---------------------------------------------------------------------------
# scenario families: (key (B, 2), params (B,), per_core) -> (t, page, col,
# wr), each (B, per_core)

def _gen_zipf_reuse(key, p: WorkloadParams, n: int):
    """Device port of the §7 application model (``traces.gen_core_stream``):
    per-request live context, Bernoulli(1/(1 + visit_mean)) visit starts
    with per-context prefix-count visit ids, window slots regenerated every
    ``window/refresh`` requests (staggered), streaming visits to fresh
    pages, 1-2 hot segments per page with in-visit column rotation."""
    p = _columns(p)
    idx = _index(key, n)
    u = _uniforms(key, n, 0, 5)     # ctx, visit-start, hot-seg, write, gap
    ctx = torch.minimum((u[..., 0] * p.contexts.to(F32)).to(I32),
                        p.contexts - 1)
    # the oracle's visit length is 1 + geometric(1/visit_mean): mean
    # 1 + visit_mean, so a request opens a new visit with that reciprocal
    start = u[..., 1] < 1.0 / (1.0 + torch.clamp_min(p.visit_mean, 0.0))

    onehot = ctx[..., None] == torch.arange(MAX_CONTEXTS, dtype=I32,
                                            device=key.device)
    pick = lambda m: torch.gather(m, -1, ctx[..., None].long())[..., 0]
    st = start[..., None] & onehot
    visit = pick(torch.cumsum(st.to(I32), dim=1, dtype=I32))
    r_mat = torch.cumsum(onehot.to(I32), dim=1, dtype=I32)
    r = pick(r_mat)
    start_r = pick(torch.cummax(
        torch.where(st, r_mat, torch.full_like(r_mat, -1)), dim=1).values)
    off = torch.where(start_r < 0, r - 1, r - start_r)  # position in visit

    # visit-level draws (constant across the visit's requests), keyed on
    # the unique id visit * MAX_CONTEXTS + ctx
    vid = visit * MAX_CONTEXTS + ctx
    v = _id_uniforms(key, vid, 1, 4)
    v_stream, v_sweep, v_slot, v_col = v.unbind(-1)

    # working-set window: slot s holds one zipf draw per generation g;
    # each slot regenerates every E requests (staggered), E = window/refresh
    epoch = torch.clamp_min(
        (p.window.to(F32) / torch.clamp_min(p.refresh, 1e-4)).to(I32), 1)
    window = torch.clamp_min(p.window, 1)
    slot = torch.where(v_sweep < 0.7,                     # coherent sweep
                       torch.remainder(visit, window),
                       torch.minimum((v_slot * window.to(F32)).to(I32),
                                     window - 1))
    gen_id = torch.div(idx + slot * torch.div(epoch, window,
                                              rounding_mode="floor"),
                       epoch, rounding_mode="floor")
    # gen_id * 65536 wraps in the JAX package's int32 and is then read as
    # uint32; int64 here, masked to 32 bits in fold_in, gives the same word
    page_reuse = _zipf_from_u(
        _id_uniforms(key, gen_id.long() * 65536 + slot, 2, 1)[..., 0],
        p.n_pages, p.zipf_a)

    # streaming visits: fresh pages outside the reuse set, never revisited
    streaming = v_stream < p.stream_frac
    page = torch.where(streaming,
                       p.n_pages + torch.remainder(vid, 1 << 20), page_reuse)

    # 1-2 hot segments per page + within-visit column rotation (traces.py)
    prim = torch.remainder(page * 97, SPR)
    sec = torch.remainder(prim + 1 + torch.remainder(page * 31, SPR - 1), SPR)
    seg = torch.where(streaming | (p.hot_segs == 1) | (u[..., 2] < 0.8),
                      prim, sec)
    start_col = torch.clamp_max((v_col * float(SEG16)).to(I32), SEG16 - 1)
    col = seg * SEG16 + torch.remainder(start_col + off, SEG16)
    return _burst_times(u[..., 4], idx, p), page, col, u[..., 3] < p.rw


def _gen_stream(key, p: WorkloadParams, n: int):
    """Sequential streaming sweep: rows visited in order, the first
    ``touch_segs`` segments of each row walked block by block — the
    pattern where in-DRAM caching cannot help."""
    p = _columns(p)
    idx = _index(key, n)
    u = _uniforms(key, n, 0, 2)   # write, gap
    per_row = torch.clamp_min(p.touch_segs, 1) * SEG16
    page = torch.remainder(torch.div(idx, per_row, rounding_mode="floor"),
                           4 * p.n_pages)                 # long cold sweep
    col = torch.remainder(idx, per_row)
    return _burst_times(u[..., 1], idx, p), page, col, u[..., 0] < p.rw


def _gen_stride(key, p: WorkloadParams, n: int):
    """Strided/blocked sweep: every visit jumps ``stride`` rows (mod the
    ``n_pages`` block) and touches ``touch_segs`` segments spread across
    the row."""
    p = _columns(p)
    idx = _index(key, n)
    u = _uniforms(key, n, 0, 2)
    touches = torch.clamp_min(p.touch_segs, 1)
    k = torch.div(idx, touches, rounding_mode="floor")
    page = torch.remainder(k * p.stride, p.n_pages)
    seg = torch.remainder(idx, touches) * torch.div(
        SPR, torch.clamp_max(touches, SPR), rounding_mode="floor")
    col = torch.clamp_max(seg, SPR - 1) * SEG16 + torch.remainder(k, SEG16)
    return _burst_times(u[..., 1], idx, p), page, col, u[..., 0] < p.rw


def _gen_pointer_chase(key, p: WorkloadParams, n: int):
    """Dependent-load chain: each step lands on a uniform-random node of an
    ``n_pages``-row pool, one fixed block of its row; the issue spacing
    carries the serialization."""
    p = _columns(p)
    idx = _index(key, n)
    u = _uniforms(key, n, 0, 3)   # node, write, gap
    page = torch.minimum((u[..., 0] * p.n_pages.to(F32)).to(I32),
                         p.n_pages - 1)
    col = torch.remainder(page * 97, SPR) * SEG16 \
        + torch.remainder(page * 53, SEG16)
    return _burst_times(u[..., 2], idx, p), page, col, u[..., 1] < p.rw


def _gen_embed(key, p: WorkloadParams, n: int):
    """Embedding-lookup / hash-join probe: iid bounded-Zipf row draws, one
    hot segment per row (the embedding vector), gathers issued ``burst``
    back-to-back — the ``figkv/`` access pattern."""
    p = _columns(p)
    idx = _index(key, n)
    u = _uniforms(key, n, 0, 4)   # page, in-vector col, write, gap
    page = _zipf_from_u(u[..., 0], p.n_pages, p.zipf_a)
    col = torch.remainder(page * 97, SPR) * SEG16 \
        + torch.clamp_max((u[..., 1] * float(SEG16)).to(I32), SEG16 - 1)
    return _burst_times(u[..., 3], idx, p), page, col, u[..., 2] < p.rw


def _gen_phase_mix(key, p: WorkloadParams, n: int):
    """Alternating phases: even ``phase_len`` windows replay the zipf_reuse
    model, odd windows stream — insertion/eviction churn at every phase
    boundary."""
    tz, pz, cz, wz = _gen_zipf_reuse(rng.fold_in(key, 11), p, n)
    ts, ps, cs, ws = _gen_stream(rng.fold_in(key, 12), p, n)
    p = _columns(p)
    idx = _index(key, n)
    streamy = torch.remainder(
        torch.div(idx, torch.clamp_min(p.phase_len, 1),
                  rounding_mode="floor"), 2) == 1
    # select gaps per phase, then re-accumulate the clock
    diff = lambda t: t - torch.cat([torch.zeros_like(t[:, :1]), t[:, :-1]],
                                   dim=1)
    t = rng.cumsum_f32(torch.where(streamy, diff(ts), diff(tz)))
    return (t, torch.where(streamy, ps + p.n_pages * 4, pz),
            torch.where(streamy, cs, cz), torch.where(streamy, ws, wz))


_FAMILY_FNS = {
    "zipf_reuse": _gen_zipf_reuse,
    "stream": _gen_stream,
    "stride": _gen_stride,
    "pointer_chase": _gen_pointer_chase,
    "embed": _gen_embed,
    "phase_mix": _gen_phase_mix,
}


# ---------------------------------------------------------------------------
# channel assembly (shared by every family)

def _hash(phys, mult: int, shift: int, mod: int):
    """``((phys * mult) mod 2**32 >> shift) % mod`` as the JAX package's
    uint32 arithmetic computes it; phys < 2**31 and mult < 2**32, so the
    int64 product is exact."""
    return ((((phys * mult) & rng.MASK32) >> shift) % mod).to(I32)


def _assemble(streams, n_channels: int, per_channel: int,
              geom: DRAMGeometry) -> Trace:
    """Merge per-core streams ``(W, n_cores, n)`` into per-channel,
    time-sorted ``Trace`` rows ``(W, n_channels, per_channel)``.

    The multiplicative address hash spreads pages over channels, banks and
    rows; each channel keeps the first ``per_channel`` of its requests in
    (arrival, stream) order; an under-filled channel completes with no-op
    requests (``dram.NOOP_ISSUE``), never duplicated real ones."""
    t, page, col, wr = streams
    W, n_cores, n = t.shape
    dev = t.device
    core = torch.arange(n_cores, dtype=I32, device=dev)[None, :, None] \
        .expand(W, n_cores, n)
    phys = (page + core * 100003).long() & rng.MASK32
    ch = _hash(phys, 2654435761, 8, n_channels)
    bank = _hash(phys, 2246822519, 12, geom.n_banks)
    row = _hash(phys, 40503, 0, geom.n_rows)
    flat = lambda x: x.reshape(W, n_cores * n)
    t, ch, bank, row, col, wr, core = map(flat, (t, ch, bank, row, col, wr,
                                                 core))
    # clamp the arrival clock strictly below the no-op sentinel.  The bound
    # must be float32-representable: the ulp at 2**30 is 64, so NOOP_ISSUE-64
    # is exact, whereas NOOP_ISSUE-2 would round UP to the sentinel itself
    # and silently convert late real requests into no-ops
    t = torch.clamp_max(t, float(NOOP_ISSUE - 64))

    # one stable (channel, time) sort serves every channel: channel c's
    # requests are the contiguous slice [starts[c], starts[c] + counts[c])
    order = torch.sort(t, dim=1, stable=True).indices
    order = order.gather(1, torch.sort(ch.gather(1, order), dim=1,
                                       stable=True).indices)
    counts = torch.zeros(W, n_channels, dtype=torch.int64, device=dev)
    counts.scatter_add_(1, ch.long(), torch.ones_like(ch, dtype=torch.int64))
    starts = torch.cumsum(counts, dim=1) - counts
    j = torch.arange(per_channel, dtype=torch.int64, device=dev)
    pos = torch.clamp_max(starts[:, :, None] + j, n_cores * n - 1)
    src = order.gather(1, pos.reshape(W, -1))
    valid = j < counts[:, :, None]                      # (W, C, per_channel)

    def g(x, fill):
        x = x.gather(1, src).reshape(W, n_channels, per_channel)
        return torch.where(valid, x, torch.full_like(x, fill))

    return Trace(t_issue=g(t.to(I32), NOOP_ISSUE), bank=g(bank, 0),
                 row=g(row, 0), col=g(col, 0), is_write=g(wr, False),
                 core=g(core, 0))


# ---------------------------------------------------------------------------
# entry points

def per_core_requests(n_cores: int, n_channels: int, per_channel: int
                      ) -> int:
    """Requests generated per core: 30 % + 2048 over the per-channel quota,
    so channel truncation has slack for hash imbalance (a channel that
    still under-fills completes with no-ops)."""
    return (13 * n_channels * per_channel // 10) // n_cores + 2048


def _streams(family: str, params: WorkloadParams, seeds: Sequence[int],
             n: int):
    """Per-core streams ``(W, n_cores, n)`` before assembly: params leaves
    ``(W, n_cores)``, one seed per workload; core c of workload w draws
    under ``fold_in(PRNGKey(seed_w), c)``."""
    W, n_cores = params.n_pages.shape
    dev = params.n_pages.device
    key = torch.stack([rng.prng_key(s, dev) for s in seeds])       # (W, 2)
    cores = torch.arange(n_cores, dtype=torch.int64, device=dev)
    keys = rng.fold_in(key[:, None, :], cores).reshape(W * n_cores, 2)
    flat = WorkloadParams(*[x.reshape(W * n_cores) for x in params])
    return [x.reshape(W, n_cores, n)
            for x in _FAMILY_FNS[family](keys, flat, n)]


def _make_gen(family: str, n_cores: int, n_channels: int, per_channel: int,
              geom: DRAMGeometry):
    """The generator of one static structure: params leaves ``(W,
    n_cores)`` and one seed per workload -> ``Trace`` leaves ``(W,
    n_channels, per_channel)``."""
    n = per_core_requests(n_cores, n_channels, per_channel)

    def gen(params: WorkloadParams, seeds: Sequence[int]) -> Trace:
        return _assemble(_streams(family, params, seeds, n), n_channels,
                         per_channel, geom)

    return gen


def family_streams(spec: WorkloadSpec, device=None):
    """One spec's per-core streams before channel assembly, ``(t, page,
    col, wr)`` each ``(n_cores, per_core_requests)``: what ``generate``
    assembles, for holding one device's draws against another's."""
    dev = resolve_device(device)
    n = per_core_requests(spec.n_cores, spec.n_channels, spec.per_channel)
    params = WorkloadParams(*[x[None] for x in spec.params(dev)])
    return [x[0] for x in _streams(spec.family, params, [spec.seed], n)]


@functools.lru_cache(maxsize=None)
def _generator(family: str, n_cores: int, n_channels: int, per_channel: int,
               geom: DRAMGeometry = GEOM):
    GEN_TRACE_LOG.append(f"gen/{family}/{n_cores}x{n_channels}x{per_channel}")
    return _make_gen(family, n_cores, n_channels, per_channel, geom)


def _unbatch(tr: Trace, w: int) -> Trace:
    return Trace(*[x[w] for x in tr])


def generate(spec: WorkloadSpec, geom: DRAMGeometry = GEOM,
             device=None) -> Trace:
    """Materialize one workload on ``device`` (``None``: the CUDA device):
    ``Trace`` leaves ``(C, T)``."""
    dev = resolve_device(device)
    fn = _generator(*spec.static_key, geom)
    params = WorkloadParams(*[x[None] for x in spec.params(dev)])
    return _unbatch(fn(params, [spec.seed]), 0)


def generate_many(specs: Sequence[WorkloadSpec], geom: DRAMGeometry = GEOM,
                  device=None) -> List[Trace]:
    """Generate a workload grid: specs sharing a static structure run as
    ONE batch (knobs stacked ``(W, n_cores)``, one seed per workload),
    bitwise equal to per-spec ``generate``.  Returns per-spec traces in
    input order."""
    dev = resolve_device(device)
    groups: Dict[object, List[int]] = {}
    for i, s in enumerate(specs):
        groups.setdefault(s.static_key, []).append(i)
    out: List[Trace | None] = [None] * len(specs)
    for key, idxs in groups.items():
        fn = _generator(*key, geom)
        batch = WorkloadParams(*[torch.stack(xs) for xs in zip(
            *[specs[i].params(dev) for i in idxs])])
        trs = fn(batch, [specs[i].seed for i in idxs])
        for j, i in enumerate(idxs):
            out[i] = _unbatch(trs, j)
    return out


def generate_stream(spec: WorkloadSpec, epochs: int,
                    geom: DRAMGeometry = GEOM, epoch_gap: int = 64,
                    device=None) -> Iterator[Trace]:
    """Unbounded trace synthesis: yield ``epochs`` successive ``(C, T)``
    numpy segments forming ONE continuous arrival stream (DESIGN.md §13).

    Each epoch re-runs the spec's generator with an epoch-mixed seed and
    shifts its real arrival times past the previous epoch's by a carried
    clock offset, so the concatenated segments form one monotone arrival
    process per channel.  No-op padding stays at the sentinel; shifted
    clocks saturate at ``NOOP_ISSUE - 64``, the clamp ``_assemble``
    applies, rather than ever turning a real request into a no-op."""
    cap = np.int64(NOOP_ISSUE - 64)
    offset = np.int64(0)
    for e in range(epochs):
        ep = dataclasses.replace(
            spec, seed=(spec.seed + 7919 * e) & 0x7FFFFFFF)
        tr = Trace(*[host_array(x) for x in generate(ep, geom, device)])
        t = tr.t_issue.astype(np.int64)
        real = t < NOOP_ISSUE
        shifted = np.where(real, np.minimum(t + offset, cap), t)
        yield tr._replace(t_issue=shifted.astype(np.int32))
        if real.any():
            offset = min(offset + t[real].max() + epoch_gap, cap)
