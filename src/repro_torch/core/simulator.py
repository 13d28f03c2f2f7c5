"""Top-level FIGCache system simulator: six mechanisms, perf + energy
metrics.  PyTorch port of ``repro.core.simulator``.

Performance model: the trace replaces Pin, and per-core IPC is derived from
the simulated average memory latency with an MLP-weighted latency-to-CPI
conversion:

    cycles_c = I_c * CPI_exec + N_c * L_c(cycles) / MLP_c
    I_c      = N_c * 1000 / MPKI_c

Single-core results report IPC speedup vs Base; multiprogrammed results
report weighted speedup (paper §7).  ``sweep`` groups a config list by its
static structure and controller, schedules the trace once per controller
(``sched.policies.schedule``, host numpy) and runs each group as one
``dram.run_sweep`` replay over a (params x channel) lane batch, or, with
``chunk_len``, as a streamed replay (``streaming.sweep_stream``, one
replay per segment); ``sweep_traces`` also stacks workloads on the channel
axis.  The counters come back to the host once per group and the IPC /
energy post-processing is the JAX package's numpy code, so equal counters
give exactly equal ``RunResult``s.

While a torch profiler session is on, a call records its program spans
(``obs.trace.span``): the root ``sweep``, ``sweep.stack`` (scheduling and
stacking), and per static group ``sweep.group`` holding ``sweep.params``,
the replay's ``replay.init`` / ``replay.prepare`` / ``replay.run``
(``dram``), ``sweep.to_host`` and ``sweep.results``.

A config with telemetry windows (``MechConfig.telemetry``) replays through
the telemetry route and returns the same results; the windows themselves
are collected by ``streaming`` with an ``obs.WindowCollector``.

Device-generated workloads (DESIGN.md §11): ``sweep_traces`` takes
``workload.WorkloadSpec`` entries beside traces and ``run_scenario`` runs
the mechanisms on one spec; their traces are synthesized on the call's
device by ``workload.generate_many`` / ``generate``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.convert import counters_to_numpy
from repro_torch.core import dram, streaming, traces, workload
from repro_torch.core.sched import policies as sched_policies
from repro_torch.core.energy import ENERGY
from repro_torch.core.timing import (DDR4, DRAMTimings, MechConfig,
                                     paper_config, shared_static,
                                     stack_params, static_group_key)
from repro_torch.obs.trace import span

CPU_GHZ = 3.2
CPI_EXEC = 0.4          # 3-wide OoO issue
MLP_INTENSIVE = 2.2     # 8 MSHRs/core, bursty misses overlap
MLP_NON = 1.4

PAPER_MECHS = ("base", "lisa_villa", "figcache_slow", "figcache_fast",
               "figcache_ideal", "lldram")

@dataclasses.dataclass
class RunResult:
    mechanism: str
    ipc: np.ndarray              # per-core
    avg_lat_ns: np.ndarray       # per-core
    row_hit_rate: float
    cache_hit_rate: float        # hits / lookups (cache mechanisms only)
    exec_time_ns: float
    dram_energy_nj: float
    system_energy_nj: float
    energy_parts: Dict[str, float]
    counters: object             # dram.Counters of numpy arrays


def _per_core_latency(cnt) -> Tuple[np.ndarray, np.ndarray]:
    lat = np.asarray(cnt.lat_sum_ns, dtype=np.float64)
    req = np.asarray(cnt.req_cnt, dtype=np.float64)
    if lat.ndim == 2:            # (channels, cores) -> sum over channels
        lat, req = lat.sum(0), req.sum(0)
    return np.where(req > 0, lat / np.maximum(req, 1), 0.0), req


def _results_from_counters_batch(cnts, cfgs: Sequence[MechConfig],
                                 apps: Sequence, n_channels: int
                                 ) -> List[RunResult]:
    """Turn a stacked batch of numpy ``dram.Counters`` (leaves ``(P,
    ...)``) into ``RunResult``s, vectorized over the params axis."""
    P = len(cfgs)
    lat = np.asarray(cnts.lat_sum_ns, dtype=np.float64)  # (P, [C,] cores)
    req = np.asarray(cnts.req_cnt, dtype=np.float64)
    if lat.ndim == 3:                # multi-channel: sum over channels
        lat, req = lat.sum(1), req.sum(1)
    avg_lat = np.where(req > 0, lat / np.maximum(req, 1), 0.0)
    n_apps = len(apps)
    mpki = np.array([a.mpki for a in apps], dtype=np.float64)
    mlp = np.array([MLP_INTENSIVE if a.name in traces.INTENSIVE else MLP_NON
                    for a in apps], dtype=np.float64)
    r, al = req[:, :n_apps], avg_lat[:, :n_apps]          # (P, n_apps)
    instr = r * 1000.0 / mpki
    cycles = instr * CPI_EXEC + r * (al * CPU_GHZ) / mlp
    with np.errstate(divide="ignore", invalid="ignore"):
        ipc = np.where(r > 0, instr / cycles, 1.0 / CPI_EXEC)
    # exec time: slowest core (ns); 0 when no core issued any request
    exec_ns = np.where(r > 0, cycles / CPU_GHZ, 0.0).max(axis=1)
    instr_tot = instr.sum(axis=1)
    tot = lambda x: np.asarray(x, dtype=np.float64).reshape(P, -1).sum(axis=1)
    n_req = tot(cnts.reads) + tot(cnts.writes)
    parts = ENERGY.system_energy_nj_batch(cnts, n_channels, n_apps,
                                          instr_tot, exec_ns, tot)
    row_hits, cache_hits = tot(cnts.row_hits), tot(cnts.cache_hits)
    out = []
    for i, cfg in enumerate(cfgs):
        div = n_req[i] if n_req[i] else 1.0
        out.append(RunResult(
            mechanism=cfg.mechanism,
            ipc=ipc[i],
            avg_lat_ns=avg_lat[i],
            row_hit_rate=row_hits[i] / div,
            cache_hit_rate=cache_hits[i] / div if cfg.has_cache else 0.0,
            exec_time_ns=float(exec_ns[i]),
            dram_energy_nj=float(parts["dram_total"][i]),
            system_energy_nj=float(parts["system_total"][i]),
            energy_parts={k: float(v[i]) for k, v in parts.items()},
            counters=dram.Counters(*[np.asarray(a)[i] for a in cnts]),
        ))
    return out


def _host_counters(cnt: dram.Counters) -> dram.Counters:
    return dram.Counters(**counters_to_numpy(cnt))


def run_mechanism(trace: dram.Trace, cfg: MechConfig,
                  apps: Sequence[traces.AppParams],
                  device=None) -> RunResult:
    trace = sched_policies.schedule(trace, cfg.sched)
    multi = np.ndim(trace.t_issue) == 2
    run = dram.run_channels if multi else dram.run_channel
    cnt = _host_counters(run(trace, cfg, device=device))
    n_channels = int(trace.t_issue.shape[0]) if multi else 1
    one = dram.Counters(*[np.asarray(a)[None] for a in cnt])
    return _results_from_counters_batch(one, [cfg], apps, n_channels)[0]


def static_groups(cfgs: Sequence[MechConfig]) -> Dict[object, List[int]]:
    """Group a config grid for batched dispatch: configs sharing a
    ``static_group_key`` and a controller go to one group, whose shared
    static is the tightest bucket covering its maximum FTS geometry."""
    keyed: Dict[object, List[int]] = {}
    for i, cfg in enumerate(cfgs):
        keyed.setdefault((static_group_key(cfg), cfg.sched), []).append(i)
    return {(shared_static([cfgs[i] for i in idxs]), sc): idxs
            for (_, sc), idxs in keyed.items()}


def _group_params(cfgs, idxs, t, device):
    return stack_params([cfgs[i].params(t, device) for i in idxs])


def _dispatch_sweep(trace: dram.Trace, static, batch, chunk_len, device
                    ) -> dram.Counters:
    """One static group's replay: the monolithic ``dram.run_sweep`` or,
    with ``chunk_len``, the segment-carried streamed replay, which is
    bitwise-identical and holds O(chunk_len) of the trace on the device."""
    if chunk_len is None:
        return dram.run_sweep(trace, static, batch, device=device)
    return streaming.sweep_stream(streaming.iter_chunks(trace, chunk_len),
                                  static, batch, device=device)


def _replay_group(trace: dram.Trace, static, cfgs, idxs, t, chunk_len,
                  device) -> dram.Counters:
    """One static group's params, replay and counters on the host, each
    under its program span (the replay's own spans are ``dram``'s)."""
    with span("sweep.params"):
        batch = _group_params(cfgs, idxs, t, device)
    cnt = _dispatch_sweep(trace, static, batch, chunk_len, device)
    with span("sweep.to_host"):
        return _host_counters(cnt)


def sweep(trace: dram.Trace, cfgs: Sequence[MechConfig],
          apps: Sequence[traces.AppParams], t: DRAMTimings = DDR4,
          chunk_len: int | None = None, device=None) -> List[RunResult]:
    """Run an arbitrary config grid with one ``dram.run_sweep`` replay per
    static structure and controller, over the trace scheduled once per
    controller.  Results come back in input order and are
    bitwise-identical to per-config ``run_mechanism``.  ``chunk_len``
    streams each group through the segment-carried replay instead (same
    results bitwise)."""
    with span("sweep"):
        multi = np.ndim(trace.t_issue) == 2
        n_channels = int(trace.t_issue.shape[0]) if multi else 1
        out: List[RunResult | None] = [None] * len(cfgs)
        groups = static_groups(cfgs)
        with span("sweep.stack"):           # host pass once per controller
            scheduled = {sc: sched_policies.schedule(trace, sc)
                         for sc in dict.fromkeys(sc for _, sc in groups)}
        for (static, sc), idxs in groups.items():
            with span("sweep.group"):
                cnts = _replay_group(scheduled[sc], static, cfgs, idxs, t,
                                     chunk_len, device)
                with span("sweep.results"):
                    results = _results_from_counters_batch(
                        cnts, [cfgs[i] for i in idxs], apps, n_channels)
                    for j, i in enumerate(idxs):
                        out[i] = results[j]
        return out


def sweep_traces(trs: Sequence, cfgs: Sequence[MechConfig], apps_list=None,
                 t: DRAMTimings = DDR4, chunk_len: int | None = None,
                 device=None) -> List[List[RunResult]]:
    """Cross-workload batching: W traces x N configs in one replay per
    static structure.  Workloads stack on the channel axis ((T,) traces to
    (W, T), (C, T) traces to (W*C, T)); unequal lengths are right-padded
    with no-ops.  Returns ``results[w][i]``, bitwise-equal to per-workload
    ``sweep`` calls.  Each workload is scheduled before the no-op padding,
    so padding stays a suffix; ``chunk_len`` streams the stacked workloads
    as ``sweep`` does.

    Entries may also be ``workload.WorkloadSpec``s: their traces are
    generated on the call's device by one ``workload.generate_many`` call
    (specs of one structure as one batch).  ``apps_list`` may be omitted
    when every entry is a spec; with mixed entries, ``None`` at a spec's
    position takes the spec's ``apps()``."""
    with span("sweep"):
        return _sweep_traces(list(trs), cfgs, apps_list, t, chunk_len,
                             device)


def _sweep_traces(trs: list, cfgs, apps_list, t, chunk_len, device
                  ) -> List[List[RunResult]]:
    if not trs:
        raise ValueError("need at least one workload")
    kinds = (dram.Trace, workload.WorkloadSpec)
    bad = [type(x).__name__ for x in trs if not isinstance(x, kinds)]
    if bad:
        raise TypeError(f"entries must be dram.Trace or WorkloadSpec: {bad}")
    spec_idx = [i for i, x in enumerate(trs)
                if isinstance(x, workload.WorkloadSpec)]
    if apps_list is None:
        if len(spec_idx) != len(trs):
            raise ValueError("apps_list may be omitted only when every "
                             "entry is a WorkloadSpec")
        apps_list = [None] * len(trs)
    if len(apps_list) != len(trs):
        raise ValueError("one apps tuple per trace")
    apps_list = [trs[i].apps() if a is None else a
                 for i, a in enumerate(apps_list)]
    if spec_idx:
        gen = workload.generate_many([trs[i] for i in spec_idx],
                                     device=device)
        for i, tr in zip(spec_idx, gen):
            trs[i] = tr
    ndims = {np.ndim(tr.t_issue) for tr in trs}
    if len(ndims) != 1:
        raise ValueError(f"traces must agree on channel layout: {ndims}")
    multi = ndims == {2}
    C = int(trs[0].t_issue.shape[0]) if multi else 1
    if multi and {int(tr.t_issue.shape[0]) for tr in trs} != {C}:
        raise ValueError("traces must share a channel count")
    W = len(trs)
    t_max = max(tr.t_issue.shape[-1] for tr in trs)
    join = np.concatenate if multi else np.stack
    stacked: Dict[object, dram.Trace] = {}

    def flat_for(sc) -> dram.Trace:
        """The W traces under controller ``sc``, channel-stacked (memoized
        per controller)."""
        if sc not in stacked:
            padded = [dram.noop_pad(dram.Trace(*[
                dram.host_array(x) for x in sched_policies.schedule(tr, sc)]),
                t_max) for tr in trs]
            stacked[sc] = dram.Trace(*[join(xs, axis=0)
                                       for xs in zip(*padded)])
        return stacked[sc]

    out: List[List[RunResult | None]] = [[None] * len(cfgs) for _ in range(W)]
    groups = static_groups(cfgs)
    with span("sweep.stack"):
        for sc in dict.fromkeys(sc for _, sc in groups):
            flat_for(sc)
    for (static, sc), idxs in groups.items():
        with span("sweep.group"):
            cnts = _replay_group(flat_for(sc), static, cfgs, idxs, t,
                                 chunk_len, device)       # (P, W*C, ...)
            with span("sweep.results"):
                for w in range(W):
                    # slice workload w back out; single-channel inputs also
                    # drop the stacking axis so results are shaped exactly
                    # like plain `sweep`
                    if multi:
                        cnt_w = dram.Counters(*[a[:, w * C:(w + 1) * C]
                                                for a in cnts])
                    else:
                        cnt_w = dram.Counters(*[a[:, w] for a in cnts])
                    results = _results_from_counters_batch(
                        cnt_w, [cfgs[i] for i in idxs], apps_list[w], C)
                    for j, i in enumerate(idxs):
                        out[w][i] = results[j]
    return out


def weighted_speedup(res: RunResult, base: RunResult) -> float:
    return float(np.sum(res.ipc / base.ipc))


def speedup(res: RunResult, base: RunResult) -> float:
    """Per-workload average speedup (normalized weighted speedup)."""
    return weighted_speedup(res, base) / len(base.ipc)


def mech_grid(mechanisms, cfg_overrides) -> List[MechConfig]:
    return [paper_config(m, **(cfg_overrides or {})) if m != "base"
            else paper_config(m) for m in mechanisms]


@functools.lru_cache(maxsize=16)
def _single_trace(app_name: str, n_reqs: int, seed: int):
    a = traces.app_params(app_name)
    return traces.build_trace([a], 1, n_reqs, seed), (a,)


def run_single_core(app_name: str, mechanisms=PAPER_MECHS,
                    n_reqs: int = 24576, seed: int = 1,
                    cfg_overrides: dict | None = None,
                    device=None) -> Dict[str, RunResult]:
    tr, apps = _single_trace(app_name, n_reqs, seed)
    res = sweep(tr, mech_grid(mechanisms, cfg_overrides), apps,
                device=device)
    return dict(zip(mechanisms, res))


def run_eight_core(workload, mechanisms=PAPER_MECHS, per_channel: int = 12288,
                   seed: int = 2, cfg_overrides: dict | None = None,
                   device=None) -> Dict[str, RunResult]:
    name, frac, apps = workload
    tr = traces.build_trace(apps, 4, per_channel, seed)
    res = sweep(tr, mech_grid(mechanisms, cfg_overrides), apps,
                device=device)
    return dict(zip(mechanisms, res))


def run_single_core_batch(app_names: Sequence[str], mechanisms=PAPER_MECHS,
                          n_reqs: int = 24576, seed: int = 1,
                          cfg_overrides: dict | None = None, device=None
                          ) -> Dict[str, Dict[str, RunResult]]:
    """All of fig 7 in one replay per static structure: every app's trace
    stacked, every mechanism's params batched."""
    pairs = [_single_trace(a, n_reqs, seed) for a in app_names]
    res = sweep_traces([p[0] for p in pairs],
                       mech_grid(mechanisms, cfg_overrides),
                       [p[1] for p in pairs], device=device)
    return {a: dict(zip(mechanisms, r)) for a, r in zip(app_names, res)}


def run_eight_core_batch(workloads, mechanisms=PAPER_MECHS,
                         per_channel: int = 12288, seed: int = 2,
                         cfg_overrides: dict | None = None, device=None
                         ) -> List[Dict[str, RunResult]]:
    """Stacked-trace counterpart of ``run_eight_core`` for fig 8: W
    multiprogrammed workloads run as one W*C-channel batch per structure."""
    trs = [traces.build_trace(apps, 4, per_channel, seed)
           for _, _, apps in workloads]
    res = sweep_traces(trs, mech_grid(mechanisms, cfg_overrides),
                       [apps for _, _, apps in workloads], device=device)
    return [dict(zip(mechanisms, r)) for r in res]


def run_scenario(spec: workload.WorkloadSpec, mechanisms=PAPER_MECHS,
                 cfg_overrides: dict | None = None, device=None
                 ) -> Dict[str, RunResult]:
    """Evaluate the paper mechanisms on one device-generated scenario
    (DESIGN.md §11): the workload counterpart of ``run_single_core`` /
    ``run_eight_core``, with the trace synthesized on ``device``."""
    res = sweep(workload.generate(spec, device=device),
                mech_grid(mechanisms, cfg_overrides), spec.apps(),
                device=device)
    return dict(zip(mechanisms, res))


def speedup_summary(results: Dict[str, RunResult]) -> Dict[str, float]:
    base = results["base"]
    return {m: weighted_speedup(r, base) / len(base.ipc)
            for m, r in results.items()}
