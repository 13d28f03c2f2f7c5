"""Synthetic memory-trace generation (paper §7 workloads), PyTorch port.

A verbatim copy of the numpy application model of ``repro.core.traces``
(``app_params`` / ``gen_core_stream`` / ``build_trace`` /
``eight_core_workloads``), so the port replays bitwise-identical traces.
Traces stay numpy arrays on the host; the simulator moves them to the
device once per run (``dram.Trace``).  The chunk codec (``encode_trace`` /
``decode_chunk``) compresses a stream for the chunked replay of
``core/streaming.py``: encoding is the JAX package's numpy, decoding runs
as torch ops on the device.

The paper drives Ramulator with Pin traces of 20 applications (Table 2).
Those traces are not distributed, so parameterized streams preserve the
properties the mechanisms are sensitive to: page popularity skew, segment
locality within a row, row-visit run length, memory intensity and
multiprogrammed interference across 4 channels / 16 banks.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import List, NamedTuple

import numpy as np
import torch

from repro_torch.core.dram import NOOP_ISSUE, Trace, host_array
from repro_torch.core.timing import GEOM, TICKS_PER_NS
from repro_torch.device import resolve_device

INTENSIVE = ["zeusmp", "leslie3d", "mcf", "GemsFDTD", "libquantum",
             "bwaves", "lbm", "com", "tigr", "mum"]
NON_INTENSIVE = ["h264ref", "bzip2", "gromacs", "gcc", "bfssandy",
                 "grep", "wc-8443", "sjeng", "tpcc64", "tpch2"]
ALL_APPS = INTENSIVE + NON_INTENSIVE


@dataclasses.dataclass(frozen=True)
class AppParams:
    name: str
    mpki: float
    n_pages: int          # working-set size in DRAM rows
    zipf_a: float         # popularity skew
    visit_mean: float     # accesses per row visit (one context)
    hot_segs: int         # hot segments per page (of row_blocks/16)
    rw: float             # write fraction
    interarrival_ns: float
    contexts: int         # concurrently-live miss streams (MSHR/MLP effect)
    burst: int            # requests issued back-to-back per CPU episode
    window: int           # active working-set window (temporally-grouped pages)
    refresh: float        # per-request probability of window turnover
    stream_frac: float    # fraction of contexts that stream fresh pages
                          # (sequential, no reuse -> caching can't help)


def _h(name: str, lo: float, hi: float, salt: str = "") -> float:
    x = int(hashlib.md5((name + salt).encode()).hexdigest()[:8], 16)
    return lo + (hi - lo) * (x / 0xFFFFFFFF)


def app_params(name: str) -> AppParams:
    intensive = name in INTENSIVE
    if intensive:
        return AppParams(
            name=name,
            mpki=_h(name, 15.0, 45.0, "m"),
            n_pages=int(_h(name, 1500, 5000, "p")),
            zipf_a=_h(name, 0.9, 1.25, "z"),
            visit_mean=_h(name, 1.2, 2.0, "v"),
            hot_segs=1 if _h(name, 0, 1, "s") < 0.7 else 2,
            rw=_h(name, 0.15, 0.35, "w"),
            interarrival_ns=_h(name, 22.0, 48.0, "i"),
            contexts=4,
            burst=3,
            window=int(_h(name, 32, 64, "W")),
            refresh=_h(name, 0.01, 0.04, "r"),
            stream_frac=_h(name, 0.12, 0.28, "f"),
        )
    return AppParams(
        name=name,
        mpki=_h(name, 1.0, 8.0, "m"),
        n_pages=int(_h(name, 300, 1200, "p")),
        zipf_a=_h(name, 1.0, 1.4, "z"),
        visit_mean=_h(name, 2.5, 5.0, "v"),
        hot_segs=1,
        rw=_h(name, 0.1, 0.3, "w"),
        interarrival_ns=_h(name, 300.0, 700.0, "i"),
        contexts=2,
        burst=1,
        window=16,
        refresh=0.01,
        stream_frac=0.15,
    )


def _zipf_probs(n_pages: int, a: float):
    ranks = np.arange(1, n_pages + 1, dtype=np.float64)
    p = ranks ** (-a)
    return p / p.sum()


def gen_core_stream(app: AppParams, core: int, n_reqs: int, seed: int,
                    n_channels: int):
    """One core's request stream: (t_ns, channel, bank, row, col, wr, core).

    Models an OoO core with `contexts` concurrently-live miss streams (MSHR
    parallelism): each emitted request comes from a random live context, so
    row visits from different pages interleave — exactly the effect that
    limits row-buffer locality and that FIGCache's segment co-location
    recovers (paper §1, §3).  Contexts draw pages from a slowly-turning
    *active window* (working-set phase), so temporally-close pages are
    re-visited together — the locality structure RowBenefit eviction is
    designed around (paper §6).  Requests arrive in bursts of `burst`.
    """
    rng = np.random.default_rng(seed)
    probs = _zipf_probs(app.n_pages, app.zipf_a)
    draws = rng.choice(app.n_pages, size=n_reqs + 4 * app.window + 64, p=probs)
    pi = 0
    segs_per_row = GEOM.row_blocks // 16
    window = list(draws[:app.window]); pi = app.window
    cursor = 0

    def new_ctx():
        nonlocal pi, cursor
        if rng.random() < app.stream_frac and pi < len(draws):
            # streaming: a fresh page swept sequentially, never revisited
            page = int(draws[pi]) + app.n_pages  # outside the reuse set
            pi += 1
            visit = 4 + int(rng.integers(0, 3))
            prim = int(rng.integers(0, segs_per_row))
            return {"page": page, "left": visit, "prim": prim, "sec": prim,
                    "start": int(rng.integers(0, 16)), "v": 0}
        # sweep the working set coherently (blocked-algorithm phase
        # behavior): revisit order matches prior visit order, which is the
        # temporal structure RowBenefit co-location exploits (paper §6)
        if rng.random() < 0.7:
            page = int(window[cursor % len(window)])
            cursor += 1
        else:
            page = int(window[int(rng.integers(0, len(window)))])
        visit = 1 + int(rng.geometric(1.0 / app.visit_mean))
        prim = (page * 97) % segs_per_row
        sec = (prim + 1 + (page * 31) % (segs_per_row - 1)) % segs_per_row
        return {"page": page, "left": visit, "prim": prim, "sec": sec,
                "start": int(rng.integers(0, 16)), "v": 0}

    ctxs = [new_ctx() for _ in range(app.contexts)]
    out = np.empty((n_reqs, 6), dtype=np.float64)
    t = rng.exponential(app.interarrival_ns)
    n = 0
    while n < n_reqs:
        for _ in range(app.burst):
            if n >= n_reqs:
                break
            k = int(rng.integers(0, len(ctxs)))
            c = ctxs[k]
            page = c["page"]
            seg = c["prim"] if (app.hot_segs == 1 or rng.random() < 0.8) \
                else c["sec"]
            col = seg * 16 + (c["start"] + c["v"]) % 16
            phys = page + core * 100003       # per-core physical allocation
            ch = (phys * 2654435761 >> 8) % n_channels
            bank = (phys * 2246822519 >> 12) % GEOM.n_banks
            row = (phys * 40503) % GEOM.n_rows
            out[n] = (t, ch, bank, row, col, rng.random() < app.rw)
            n += 1
            c["v"] += 1
            c["left"] -= 1
            if c["left"] <= 0:
                ctxs[k] = new_ctx()
            if rng.random() < app.refresh and pi < len(draws):  # phase drift
                window[int(rng.integers(0, len(window)))] = int(draws[pi])
                pi += 1
        t += rng.exponential(app.interarrival_ns * app.burst)
    return (out[:, 0], out[:, 1].astype(np.int64), out[:, 2].astype(np.int64),
            out[:, 3].astype(np.int64), out[:, 4].astype(np.int64),
            out[:, 5] > 0.5, np.full(n_reqs, core))


def build_trace(apps, n_channels: int, per_channel: int, seed: int = 0):
    """Merge per-core streams into per-channel, time-sorted Trace arrays.

    apps: list of AppParams, one per core.  Returns a Trace with (C, T)
    numpy leaves.  A channel that receives fewer than ``per_channel``
    requests is completed with no-op sentinel requests (``dram.NOOP_ISSUE``
    suffix).
    """
    total = n_channels * per_channel
    per_core = total // len(apps) + per_channel
    streams = [gen_core_stream(a, c, per_core, seed * 1000 + c, n_channels)
               for c, a in enumerate(apps)]
    t = np.concatenate([s[0] for s in streams])
    ch = np.concatenate([s[1] for s in streams])
    bank = np.concatenate([s[2] for s in streams])
    row = np.concatenate([s[3] for s in streams])
    col = np.concatenate([s[4] for s in streams])
    wr = np.concatenate([s[5] for s in streams])
    core = np.concatenate([s[6] for s in streams])

    chans = []
    for c in range(n_channels):
        m = ch == c
        order = np.argsort(t[m], kind="stable")[:per_channel]
        ticks = (t[m][order] * TICKS_PER_NS).astype(np.int32)
        fields = [ticks, bank[m][order].astype(np.int32),
                  row[m][order].astype(np.int32),
                  col[m][order].astype(np.int32),
                  wr[m][order], core[m][order].astype(np.int32)]
        if order.size < per_channel:
            # an under-filled channel completes with no-op sentinel
            # requests (zero-latency, counter-inert), never duplicated
            # real ones, so per-channel stats stay honest
            pad = per_channel - order.size
            fills = (NOOP_ISSUE, 0, 0, 0, False, 0)
            fields = [np.concatenate([f, np.full(pad, v, dtype=f.dtype)])
                      for f, v in zip(fields, fills)]
        chans.append(tuple(fields))
    tr = Trace(
        t_issue=np.stack([c[0] for c in chans]),
        bank=np.stack([c[1] for c in chans]),
        row=np.stack([c[2] for c in chans]),
        col=np.stack([c[3] for c in chans]),
        is_write=np.stack([c[4] for c in chans]),
        core=np.stack([c[5] for c in chans]),
    )
    return tr


def eight_core_workloads():
    """20 multiprogrammed mixes: 5 each at 25/50/75/100 % memory-intensive."""
    rng = np.random.default_rng(7)
    out = []
    for frac, n_int in [(25, 2), (50, 4), (75, 6), (100, 8)]:
        for w in range(5):
            ints = list(rng.choice(INTENSIVE, n_int, replace=False))
            nons = list(rng.choice(NON_INTENSIVE, 8 - n_int, replace=False))
            names = ints + nons
            rng.shuffle(names)
            out.append((f"W{frac}-{w}", frac, [app_params(n) for n in names]))
    return out


# ---------------------------------------------------------------------------
# Chunk codec (DESIGN.md §13): fixed-shape delta-time / page-cluster chunks.

CHUNK_LEN = 1 << 16       # requests per chunk (VMEM-friendly default)
MAX_CLUSTERS = 1024       # per-chunk (bank, row) page-cluster table entries
FLAG_WRITE = 1            # TraceChunk.flags bit 0
FLAG_FILLER = 2           # TraceChunk.flags bit 1 — no-op sentinel tail fill


class TraceChunk(NamedTuple):
    """One fixed-shape compressed chunk of a single channel's stream.

    ~7 bytes/request against the 21 of raw ``Trace`` leaves: issue times
    as int16 deltas off a per-chunk int32 base (``t[i] = base_t +
    cumsum(dt)[i]``, ``dt[0] == 0``), page addresses as uint16 indices
    into a per-chunk first-occurrence table of packed ``bank << 16 | row``
    ids.  Requests past ``n_real`` are fillers (``FLAG_FILLER``) that
    decode to no-op sentinel requests — chunk-interior no-ops once chunks
    are concatenated, inert by the DESIGN.md §9 contract.  All leaves are
    numpy arrays; ``decode_chunk`` moves them to the device as they are
    (int16 / uint8, the uint16 fields as their int16 bit pattern).
    """
    base_t: np.ndarray    # ()  int32 — absolute tick of the first request
    dt: np.ndarray        # (L,) int16 — delta from the previous request
    cl: np.ndarray        # (L,) uint16 — index into ``clusters``
    col: np.ndarray       # (L,) uint8
    core: np.ndarray      # (L,) uint8
    flags: np.ndarray     # (L,) uint8 — FLAG_WRITE | FLAG_FILLER
    clusters: np.ndarray  # (K,) int32 — packed ``bank << 16 | row``
    n_real: np.ndarray    # ()  int32 — requests before the filler tail


def _cluster_ranks(page: np.ndarray):
    """Per-request first-occurrence rank + the table in rank order.
    Ranks are monotone in first-occurrence position, so truncating the
    window at the first rank >= K leaves every surviving rank < K with
    its first occurrence inside the truncated window."""
    uniq, first, inv = np.unique(page, return_index=True,
                                 return_inverse=True)
    order = np.argsort(first, kind="stable")
    rank = np.empty(order.size, dtype=np.int64)
    rank[order] = np.arange(order.size)
    return rank[inv], uniq[order]


def encode_trace(trace: Trace, chunk_len: int = CHUNK_LEN,
                 max_clusters: int = MAX_CLUSTERS) -> List[TraceChunk]:
    """Compress a (T,) request stream into fixed-shape ``TraceChunk``s.

    Exact for EVERY input: any request the encoding cannot represent —
    a time delta outside int16 (including the negative deltas a scheduled
    trace carries), a page past the ``max_clusters`` table — terminates
    the chunk early with no-op filler tail and restarts the next chunk
    with a fresh absolute base and an empty cluster table.  Input no-op
    padding requests are dropped (they are padding, not data; the decoder
    re-synthesizes fillers as needed), so
    ``decode_trace(encode_trace(tr)) == tr`` up to no-op requests.
    """
    assert chunk_len >= 1 and 1 <= max_clusters <= (1 << 16)
    t = host_array(trace.t_issue).astype(np.int64)
    assert t.ndim == 1, "encode_trace takes one channel; see core/streaming"
    keep = np.flatnonzero(t < NOOP_ISSUE)
    t = t[keep]
    bank = host_array(trace.bank).astype(np.int64)[keep]
    row = host_array(trace.row).astype(np.int64)[keep]
    col = host_array(trace.col).astype(np.int64)[keep]
    wr = host_array(trace.is_write).astype(bool)[keep]
    core = host_array(trace.core).astype(np.int64)[keep]
    assert bank.size == 0 or (
        bank.min() >= 0 and bank.max() < (1 << 15)
        and row.min() >= 0 and row.max() < (1 << 16)
        and col.min() >= 0 and col.max() < (1 << 8)
        and core.min() >= 0 and core.max() < (1 << 8)), \
        "trace fields exceed the codec's packed ranges"
    page = (bank << 16) | row

    chunks: List[TraceChunk] = []
    pos, n = 0, t.size
    while pos < n:
        take = min(chunk_len, n - pos)
        tt = t[pos:pos + take]
        dt = np.diff(tt, prepend=tt[0])
        bad = np.flatnonzero((dt < -(1 << 15)) | (dt >= (1 << 15)))
        if bad.size:
            take = int(bad[0])          # dt[0] == 0, so take >= 1
        cl, table = _cluster_ranks(page[pos:pos + take])
        over = np.flatnonzero(cl >= max_clusters)
        if over.size:
            take = int(over[0])         # rank 0 < max_clusters, so >= 1
            cl, table = cl[:take], table[:take]
        table = table[:max_clusters]

        L, K = chunk_len, max_clusters
        sl = slice(pos, pos + take)
        dt_o = np.zeros(L, np.int16)
        dt_o[:take] = dt[:take]
        cl_o = np.zeros(L, np.uint16)
        cl_o[:take] = cl[:take]
        col_o = np.zeros(L, np.uint8)
        col_o[:take] = col[sl]
        core_o = np.zeros(L, np.uint8)
        core_o[:take] = core[sl]
        flags = np.full(L, FLAG_FILLER, np.uint8)
        flags[:take] = wr[sl].astype(np.uint8) * FLAG_WRITE
        clusters = np.zeros(K, np.int32)
        clusters[:table.size] = table
        chunks.append(TraceChunk(
            base_t=np.int32(tt[0]), dt=dt_o, cl=cl_o, col=col_o,
            core=core_o, flags=flags, clusters=clusters,
            n_real=np.int32(take)))
        pos += take
    return chunks


def _on(x, device) -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(x))
    if a.dtype == np.uint16:              # torch has no uint16 arithmetic:
        a = a.view(np.int16)              # move the bits, widen on device
    return torch.from_numpy(a).to(device)


def decode_chunk(chunk: TraceChunk, device=None) -> Trace:
    """Decode one chunk into (L,) ``Trace`` tensors on ``device`` — a few
    torch ops, the same for every chunk of a stream (fixed shapes by
    construction).  Filler entries decode to no-op sentinel requests with
    neutral fields, exactly ``dram.noop_pad``'s convention."""
    dev = resolve_device(device)
    i32 = torch.int32
    flags = _on(chunk.flags, dev).to(i32)
    filler = (flags & FLAG_FILLER) != 0
    dt = _on(chunk.dt, dev).to(i32)
    # int32 wraparound as the JAX package's int32 cumsum (the int64 sum
    # truncates to the same bits)
    tt = (torch.cumsum(dt, dim=0) + int(np.asarray(chunk.base_t))).to(i32)
    cl = _on(chunk.cl, dev).to(i32) & 0xFFFF     # uint16 widened to int32
    packed = _on(chunk.clusters, dev)[cl.long()]

    def neutral(x):
        return torch.where(filler, 0, x.to(i32))

    return Trace(
        t_issue=torch.where(filler, NOOP_ISSUE, tt),
        bank=neutral(packed >> 16),
        row=neutral(packed & 0xFFFF),
        col=neutral(_on(chunk.col, dev)),
        is_write=~filler & ((flags & FLAG_WRITE) != 0),
        core=neutral(_on(chunk.core, dev)),
    )


def decode_trace(chunks: List[TraceChunk], device=None) -> Trace:
    """Host-side roundtrip: decode on ``device`` + concatenate + strip
    fillers, as numpy leaves.  The codec identity
    ``decode_trace(encode_trace(tr)) == tr`` (for clean traces) is pinned by
    ``tests/test_torch_streaming.py``."""
    parts = [Trace(*[host_array(x) for x in decode_chunk(c, device)])
             for c in chunks]
    cat = {f: np.concatenate([getattr(p, f) for p in parts])
           for f in Trace._fields}
    keep = np.flatnonzero(cat["t_issue"] < NOOP_ISSUE)
    return Trace(**{f: v[keep] for f, v in cat.items()})


def encoded_nbytes(chunks: List[TraceChunk]) -> int:
    """On-device footprint of an encoded stream (compression reporting)."""
    return sum(sum(np.asarray(leaf).nbytes for leaf in c) for c in chunks)
