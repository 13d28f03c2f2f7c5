"""The benchmark's own trace generator: a frozen copy of the numpy
application model of ``repro_torch.core.traces`` (``app_params``,
``gen_core_stream``, ``build_trace``, ``eight_core_workloads`` and the app
lists), so later changes to the program's generator leave the yardstick as
it is.  ``tests/test_perfbench_inputs.py`` holds it equal to the program's
today.  Traces are plain dicts of numpy arrays with the leaves of
``dram.Trace``: ``(C, T)`` per channel, time-sorted, a short channel
completed with no-op requests (``t_issue >= NOOP_ISSUE``).
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

TICKS_PER_NS = 8
NOOP_ISSUE = 1 << 30          # dram.NOOP_ISSUE: no-op padding request
N_BANKS = 16                  # timing.GEOM, paper Table 1
N_ROWS = 32768
ROW_BLOCKS = 128
TRACE_FIELDS = ("t_issue", "bank", "row", "col", "is_write", "core")

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
    segs_per_row = ROW_BLOCKS // 16
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
            bank = (phys * 2246822519 >> 12) % N_BANKS
            row = (phys * 40503) % N_ROWS
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

    apps: list of AppParams, one per core.  Returns a dict of the
    ``TRACE_FIELDS`` as (C, T) numpy leaves.  A channel that receives fewer
    than ``per_channel`` requests is completed with no-op sentinel requests
    (``NOOP_ISSUE`` suffix).
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
    return {f: np.stack([c[i] for c in chans])
            for i, f in enumerate(TRACE_FIELDS)}


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
