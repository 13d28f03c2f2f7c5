"""Build and run the PyTorch port of the FIGCache simulator on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises (non-zero exit) on any failed check:

1. device: the card's name and power limit; build every CUDA kernel of the
   port from ``src/repro_torch/csrc`` with nvcc (sm_90a), timed;
2. kernel vs plain: each kernel's wrapper against its plain PyTorch version
   on the card, bitwise, at the main path's shapes and at corner shapes,
   then both timed with CUDA events (median of 25 samples), per eager call
   and as device time (CUDA-graph replay), beside the kernel's byte bound;
3. golden pins: the six FCFS fingerprints of tests/test_obs.py:108-153 on
   the card, with the fused lookup kernel on and off (12 runs);
4. main path: ``simulator.run_eight_core_batch`` over the fig-8 workload set
   (benchmarks/common.py ALL_WL), 4 channels x 6144 requests, all six
   paper mechanisms, ``fts_kernel=True``; launch counts read just around
   it; workload 15 rerun alone with the plain lookup, for the mechanisms
   with a cache (the only ones that reach the lookup), compared bitwise;
5. profile: device busy and idle share of the main path's steps at its
   shapes (torch.profiler), and the device ops that take the time;
6. summary: one ``{"kernels": [...]}`` JSON line (device times from
   CUDA-graph replay), the nvidia-smi line, and last the
   ``{"ok": true, "device": ...}`` line.

Needs a CUDA device: without one it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import dram, simulator, timing, traces  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.fts_lookup import fts_lookup as fts_kernel  # noqa: E402
from repro_torch.kernels.fts_lookup.ref import fts_lookup_ref  # noqa: E402

FIG8_WORKLOADS = (0, 2, 5, 7, 10, 12, 15, 17)   # benchmarks/common.py ALL_WL
PER_CHANNEL = 6144                              # common.QUICK_REQS_8CORE
N_CHANNELS = 4
HBM_BYTES_PER_S = 3.35e12                       # H100 SXM data sheet
KERNELS = ("fts_lookup",)

# (acts_slow, acts_fast, reads, writes, reloc_blocks, wb_blocks, row_hits,
#  cache_hits, insertions, sum(lat_sum_ns), sum(req_cnt), t_end): the FCFS
# column of GOLDEN in tests/test_obs.py:108-153 (cache_rows=2 for the cached
# mechanisms, on that file's _reuse_trace()).
GOLDEN_FCFS = {
    "base": (320, 0, 256, 64, 0, 0, 0, 0, 0, 203846, 320, 28920),
    "lldram": (0, 320, 256, 64, 0, 0, 0, 0, 0, 132798, 320, 19118),
    "lisa_villa": (296, 24, 256, 64, 37888, 7552, 0, 24, 296, 257761, 320,
                   36264),
    "figcache_slow": (295, 0, 256, 64, 4320, 752, 25, 50, 270, 299156, 320,
                      42932),
    "figcache_fast": (270, 25, 256, 64, 4320, 752, 25, 50, 270, 291785, 320,
                      42012),
    "figcache_ideal": (270, 25, 256, 64, 4320, 752, 25, 50, 270, 185359,
                       320, 26656),
}


def log(msg):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps=50, samples=25) -> float:
    """Median over ``samples`` CUDA-event windows of ``reps`` back-to-back
    calls, per call (ms)."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(samples):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        per.append(a.elapsed_time(b) / reps)
    return statistics.median(per)


def graph_ms(fn, reps=20, samples=25) -> float:
    """Device time per call: ``reps`` calls captured in one CUDA graph,
    replayed ``samples`` times between CUDA events; median per call (ms).
    Replay removes the host's per-call cost, which ``time_ms`` includes."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    per = []
    for _ in range(samples):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        per.append(a.elapsed_time(b) / reps)
    return statistics.median(per)


# ---------------------------------------------------------------------------
# phase 2: fts_lookup kernel vs plain

def lookup_case(n_lanes, n_banks, S, seed, dev, score_hi=8):
    """Random stores with many ties, all-miss lanes (seg 1000) and limits
    cycling {0, S/2, S} plus random values below and around S."""
    rng = np.random.default_rng(seed)
    tags = rng.integers(-1, 40, (n_lanes, n_banks, S)).astype(np.int32)
    score = rng.integers(0, score_hi, (n_lanes, n_banks, S)).astype(np.int32)
    bank = rng.integers(0, n_banks, n_lanes).astype(np.int32)
    seg = rng.integers(-1, 41, n_lanes).astype(np.int32)
    seg[::5] = 1000
    limit = np.array([(0, S // 2, S)[i % 3] for i in range(n_lanes)],
                     np.int32)
    limit[3::7] = rng.integers(-2, S + 2, limit[3::7].shape)
    return [torch.from_numpy(x).to(dev)
            for x in (tags, score, bank, seg, limit)]


def lookup_bytes(n_lanes, S) -> int:
    """Bytes one lookup must move: the two selected rows and bank/seg/limit
    read once, the (N, 3) result written once."""
    return 4 * (2 * n_lanes * S + 3 * n_lanes + 3 * n_lanes)


def phase_kernels(dev):
    shapes = [(32, 16, 512), (32, 16, 1024), (32, 16, 2), (40, 4, 13),
              (33, 3, 100), (7, 1, 32)]
    max_err = 0
    for i, (n, nb, S) in enumerate(shapes):
        for score_hi in (8, 2):
            args = lookup_case(n, nb, S, seed=100 * i + score_hi, dev=dev,
                               score_hi=score_hi)
            got = fts_kernel.fts_lookup(*args)
            ref = fts_lookup_ref(*args)
            torch.cuda.synchronize()
            err = int((got.long() - ref.long()).abs().max())
            max_err = max(max_err, err)
            check(torch.equal(got, ref),
                  f"fts_lookup kernel != plain at N={n} banks={nb} S={S}")
            check(bool((got[:, 0] == 0).any()) and bool((args[4] <= 0).any()),
                  "case lacks an all-miss or a limit <= 0 lane")
    log(f"[kernels] fts_lookup == plain bitwise on {2 * len(shapes)} cases "
        f"(N, banks, S) in {shapes}; max_abs_err={max_err}")
    timings = {}
    for n, nb, S in ((32, 16, 512), (32, 16, 1024)):
        args = lookup_case(n, nb, S, seed=7, dev=dev)
        kernel = lambda: fts_kernel.fts_lookup(*args)  # noqa: E731
        plain = lambda: fts_lookup_ref(*args)  # noqa: E731
        k_call, p_call = time_ms(kernel), time_ms(plain)
        k_dev, p_dev = graph_ms(kernel), graph_ms(plain)
        bound = lookup_bytes(n, S) / HBM_BYTES_PER_S * 1e3
        timings[(n, nb, S)] = (k_dev, p_dev, bound)
        log(f"[kernels] fts_lookup N={n} banks={nb} S={S}: device time "
            f"(CUDA-graph replay) kernel {k_dev * 1e3:.3f} us, plain "
            f"{p_dev * 1e3:.3f} us; per eager call kernel "
            f"{k_call * 1e3:.2f} us, plain {p_call * 1e3:.2f} us; byte bound "
            f"{bound * 1e3:.4f} us")
    return max_err, timings


# ---------------------------------------------------------------------------
# phase 3: golden pins

def reuse_trace(n=320):
    """tests/test_obs.py:_reuse_trace() as numpy arrays."""
    idx = np.arange(n)
    return dram.Trace(t_issue=(idx * 16).astype(np.int32),
                      bank=(idx % 3).astype(np.int32),
                      row=((idx * 7) % 13).astype(np.int32),
                      col=((idx * 13) % 128).astype(np.int32),
                      is_write=idx % 5 == 0, core=(idx % 8).astype(np.int32))


def phase_golden(dev):
    tr = reuse_trace()
    t0 = time.perf_counter()
    for mech, want in GOLDEN_FCFS.items():
        for kern in (True, False):
            kw = {"cache_rows": 2} if mech not in ("base", "lldram") else {}
            cfg = timing.paper_config(mech, fts_kernel=kern, **kw)
            cnt = dram.run_channel(tr, cfg, device=dev)
            got = tuple(int(x.sum()) for x in cnt)
            check(got == want, f"golden {mech} fts_kernel={kern}: {got} != "
                  f"{want}")
    log(f"[golden] 12/12 FCFS fingerprints match tests/test_obs.py GOLDEN "
        f"({time.perf_counter() - t0:.1f} s)")


# ---------------------------------------------------------------------------
# phase 4: the main path

def phase_main(dev):
    wl_idx = list(FIG8_WORKLOADS)
    all_wl = traces.eight_core_workloads()
    wls = [all_wl[i] for i in wl_idx]
    groups = []
    real_run_sweep = dram.run_sweep

    def timed_run_sweep(trace, static, params, variant="fused", device=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_run_sweep(trace, static, params, variant, device)
        torch.cuda.synchronize()
        groups.append((static.mechanism, np.shape(trace.t_issue),
                       time.perf_counter() - t0))
        return out

    dram.run_sweep = timed_run_sweep
    try:
        fts_kernel.COUNTER.launches = 0
        t0 = time.perf_counter()
        res = simulator.run_eight_core_batch(
            wls, per_channel=PER_CHANNEL,
            cfg_overrides={"fts_kernel": True}, device=dev)
        wall = time.perf_counter() - t0
        launches = fts_kernel.COUNTER.launches
    finally:
        dram.run_sweep = real_run_sweep
    cached = [m for m in simulator.PAPER_MECHS
              if timing.paper_config(m).has_cache]
    n_cached = len(cached)
    log(f"[main] run_eight_core_batch: {len(wls)} workloads x "
        f"{N_CHANNELS} channels x {PER_CHANNEL} requests x "
        f"{len(simulator.PAPER_MECHS)} mechanisms in {wall:.1f} s; "
        f"fts_lookup launches {launches}")
    check(launches == n_cached * PER_CHANNEL,
          f"fts_lookup launched {launches} times, expected "
          f"{n_cached} x {PER_CHANNEL}")
    for mech, shape, secs in groups:
        lanes, steps = shape[0], shape[1]
        log(f"[main]   group {mech:15s} lanes={lanes} steps={steps} "
            f"wall={secs:.2f} s  {steps / secs:.0f} steps/s  "
            f"{steps * lanes / secs:.0f} request-lanes/s")
    for w, r in zip(wl_idx, res):
        for m, x in r.items():
            check(x.ipc.shape == (8,) and np.isfinite(x.ipc).all()
                  and (x.ipc > 0).all() and np.isfinite(x.system_energy_nj),
                  f"workload {w} {m}: non-finite or empty result")
            n_req = int(x.counters.reads.sum() + x.counters.writes.sum())
            check(0 < n_req <= N_CHANNELS * PER_CHANNEL
                  and n_req == int(x.counters.req_cnt.sum()),
                  f"workload {w} {m}: request count {n_req}")
    avg = {m: float(np.mean([simulator.speedup_summary(r)[m] for r in res]))
           for m in simulator.PAPER_MECHS}
    log("[main] mean weighted speedup vs base over the workloads: " +
        ", ".join(f"{m}={v:.4f}" for m, v in avg.items()))

    # workload 15 alone through the plain lookup: bitwise equal to its
    # slice.  Only the cached mechanisms reach the lookup, so only they rerun.
    before = fts_kernel.COUNTER.launches
    t0 = time.perf_counter()
    alone = simulator.run_eight_core(all_wl[15], mechanisms=cached,
                                     per_channel=PER_CHANNEL, device=dev)
    check(fts_kernel.COUNTER.launches == before,
          "plain-lookup rerun launched the kernel")
    batch = res[wl_idx.index(15)]
    for m in cached:
        for f, a, b in zip(dram.Counters._fields, alone[m].counters,
                           batch[m].counters):
            check(np.array_equal(a, b), f"wl15 {m} {f}: plain rerun "
                  "differs from the kernel batch")
    log(f"[main] workload 15 rerun alone with fts_kernel=False for {cached}: "
        f"counters bitwise equal to its batch slice "
        f"({time.perf_counter() - t0:.1f} s)")
    return launches


# ---------------------------------------------------------------------------
# phase 5: where a main-path step's time goes

def phase_profile(dev, steps=128):
    """Profile ``steps`` requests of the main path's replay at its shapes
    (the workloads x 4 channels as lanes, S = 512): device busy time from
    CUPTI against the wall time of the same replay run unprofiled."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    all_wl = traces.eight_core_workloads()
    trs = [traces.build_trace(all_wl[i][2], N_CHANNELS, steps, 2)
           for i in FIG8_WORKLOADS]
    flat = dram.Trace(*[np.concatenate(xs) for xs in zip(*trs)])
    for mech in ("figcache_fast", "base"):
        cfg = timing.paper_config(mech, fts_kernel=True)
        params = timing.stack_params([cfg.params(device=dev)])

        def replay():
            dram.run_sweep(flat, cfg.static, params, device=dev)
            torch.cuda.synchronize()

        replay()
        t0 = time.perf_counter()
        replay()
        wall = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            replay()
        kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if not kern:
            log(f"[profile] {mech}: the profiler saw no device activity; "
                "device busy share not measured")
            continue
        busy = sum(e.time_range.elapsed_us() for e in kern) * 1e-6
        by_name = {}
        for e in kern:
            t, c = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + e.time_range.elapsed_us(), c + 1)
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
        log(f"[profile] {mech} lanes={flat.t_issue.shape[0]} steps={steps}: "
            f"wall {wall / steps * 1e3:.3f} ms/step unprofiled, device busy "
            f"{busy / steps * 1e3:.3f} ms/step ({len(kern) / steps:.1f} "
            f"device ops/step), device idle share {1 - busy / wall:.4f}")
        for name, (us, c) in top:
            log(f"[profile]   {us / c:8.3f} us x {c / steps:5.1f}/step  "
                f"{name[:90]}")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is available",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    log(f"[device] {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.device_count()} device(s)")

    t0 = time.perf_counter()
    for name in KERNELS:
        _build.load(name)
    log(f"[build] {len(KERNELS)} kernel(s) built in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, (secs, report) in _build.BUILD_LOG.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    max_err, timings = phase_kernels(dev)
    phase_golden(dev)
    launches = phase_main(dev)
    phase_profile(dev)

    k_ms, p_ms, bound = timings[(32, 16, 512)]
    print(json.dumps({"kernels": [{
        "name": "fts_lookup", "route": "cuda",
        "source": "src/repro_torch/csrc/fts_lookup.cu",
        "replaces": "src/repro/kernels/fts_lookup/fts_lookup.py:50",
        "launches": launches, "max_abs_err": max_err, "ms": k_ms,
        "plain_ms": p_ms, "bound_ms": bound, "bound_by": "bytes",
        "library_ms": None}]}), flush=True)
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
