"""Driver of one job: ``repro_torch.core.simulator.sweep_traces`` over a
traffic mix's workloads and config grid, as an architect's sweep script
calls it.

A job starts when the call is made and ends when its ``RunResult``s are
on the host.  The traces are made in set-up by the benchmark's own
generator (``perfbench/tracegen.py``), one set per pool slot, each from
its own seed drawn from ``--seed``; jobs rotate over the pool, so no job
repeats the one before it.  The same numpy arrays go to the program (as
its ``dram.Trace`` and ``traces.AppParams``) and to the reference.

The traffic file's keys: ``workloads`` (``eight_core_mixes``: indices of
``tracegen.eight_core_workloads()``, or ``single_apps``: application
names, each alone on core 0), ``grid`` (``mechanisms``: paper mechanisms
at the configuration's defaults; ``cross``: one mechanism over the
product of the listed knobs, first) and ``pool`` (trace sets).  The trace
length, ``requests_per_channel``, is the configuration's.

A job's ``check`` is ``check.compare``: every counter and derived result
against the reference's.  Its ``counters`` are the program's
``sim_scan`` launch counter; ``steps_per_launch`` (the trace length) and
``bytes_per_job`` (``roofline.state_bytes`` over every lane) are what the
kernel's metrics read.
"""
from __future__ import annotations

import dataclasses
import importlib
import itertools
from typing import Dict, List, Sequence, Tuple

import numpy as np

from perfbench import check as check_lib
from perfbench import roofline, tracegen


def grid_points(cfg: dict, traffic: dict) -> List[dict]:
    """The traffic's config points, in the order the program gets them."""
    grid = traffic["grid"]
    ref = reference_module(cfg)
    points = []
    cross = grid.get("cross")
    if cross:
        knobs = [k for k in cross if k != "mechanism"]
        for values in itertools.product(*[cross[k] for k in knobs]):
            points.append(ref.mech_point(cfg, cross["mechanism"],
                                         **dict(zip(knobs, values))))
    for m in grid.get("mechanisms", []):
        if m not in cfg["mechanisms"]:
            raise ValueError(f"{m} is not a mechanism of {cfg['name']}")
        points.append(ref.mech_point(cfg, m))
    return points


def workload_apps(cfg: dict, traffic: dict) -> List[list]:
    """One list of ``tracegen.AppParams`` per workload, a core each."""
    wl = traffic["workloads"]
    if "eight_core_mixes" in wl:
        mixes = tracegen.eight_core_workloads()
        out = [mixes[i][2] for i in wl["eight_core_mixes"]]
    else:
        out = [[tracegen.app_params(a)] for a in wl["single_apps"]]
    if any(len(apps) != cfg["cores"] for apps in out):
        raise ValueError(f"{cfg['name']} runs {cfg['cores']} cores a "
                         f"workload")
    return out


def pool_seeds(seed: int, n: int) -> List[int]:
    """The trace seed of each pool slot, drawn from ``--seed``."""
    return [int(s) for s in
            np.random.SeedSequence(seed).generate_state(n, np.uint32)]


def start(cfg: dict, traffic: dict, seed: int, executor=None):
    """Start making the trace pool (in ``executor``'s processes, or here
    when it is None); returns a call that waits for it and gives
    ``pool[k][w]``: workload w's trace (a dict of ``(C, T)`` arrays) in
    trace set k."""
    apps = workload_apps(cfg, traffic)
    args = [(a, cfg["channels"], cfg["requests_per_channel"], s)
            for s in pool_seeds(seed, traffic["pool"]) for a in apps]
    if executor is None:
        made = [tracegen.build_trace(*x) for x in args]
        get = iter(made).__next__
    else:
        futures = iter([executor.submit(tracegen.build_trace, *x)
                        for x in args])

        def get():
            return next(futures).result()

    return lambda: [[get() for _ in apps] for _ in range(traffic["pool"])]


def reference_module(cfg: dict):
    return importlib.import_module(f"perfbench.reference.{cfg['reference']}")


def app_dicts(apps) -> List[dict]:
    return [{"name": a.name, "mpki": a.mpki,
             "intensive": a.name in tracegen.INTENSIVE} for a in apps]


class Reference:
    """A cell's inputs and what the reference makes of them: the trace
    pool, the config points, ``reference`` and ``check``.  It imports
    nothing of the program."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, pool=None):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.points = grid_points(cfg, traffic)
        self.apps = workload_apps(cfg, traffic)
        self.pool = pool if pool is not None else \
            start(cfg, traffic, seed)()
        T = cfg["requests_per_channel"]
        self.steps_per_launch = T
        self.requests = [sum(int((tr["t_issue"] < tracegen.NOOP_ISSUE).sum())
                             for tr in trs) * len(self.points)
                         for trs in self.pool]
        C, geom = cfg["channels"], cfg["geometry"]
        cached = reference_module(cfg).CACHED
        self.bytes_per_job = sum(
            len(self.apps) * C * roofline.state_bytes(
                T, 1, has_cache=p["mechanism"] in cached,
                max_slots=p["cache_rows"] * geom["row_blocks"]
                // p["seg_blocks"],
                max_segs_per_row=geom["row_blocks"] // p["seg_blocks"],
                n_banks=geom["n_banks"], n_cores=geom["n_cores"])
            for p in self.points)

    def reference(self, resolution: int = 1, workers: int | None = None
                  ) -> Dict[Tuple[int, int, int], dict]:
        """Counters and results of the reference for every (workload,
        point) pair of every trace set, ``{(k, w, i): {"counters",
        "result"}}``."""
        ref = reference_module(self.cfg)
        jobs = [(k, w, i) for k in range(len(self.pool))
                for w in range(len(self.apps))
                for i in range(len(self.points))]
        if workers is None:
            workers = check_lib.WORKERS
        cnts = check_lib.map_reference(
            ref.__name__, self.cfg, self.pool, self.points, jobs,
            resolution, workers)
        return {j: {"counters": c,
                    "result": ref.derive(c, self.points[j[2]],
                                         app_dicts(self.apps[j[1]]),
                                         self.cfg)}
                for j, c in zip(jobs, cnts)}

    def check(self, done: Sequence[Tuple[int, object]], expected: dict
              ) -> Dict[str, Tuple[float, float]]:
        """The numbers compared, each with its limit: every result of every
        job against the reference's (``expected``, from ``reference``)."""
        return check_lib.compare(done, expected, len(self.apps),
                                 len(self.points))


class SweepJob(Reference):
    """One cell's job: ``run(k)`` drives the program on trace set k.  The
    program is imported while the trace pool is still being made
    (``pending``, from ``start``)."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 pending, mark):
        from repro_torch.core import dram, simulator, timing, traces
        from repro_torch.kernels.sim_scan import sim_scan as scan_kernel
        mark("the program's import")
        pool = pending()
        mark("traces")
        super().__init__(cfg, traffic, seed, pool)
        _check_program(cfg)
        if cfg["controller"] != "fcfs":
            raise ValueError("sweep_traces jobs run the FCFS controller only")
        self.sim, self.scan, self.device = simulator, scan_kernel, device
        self.timings = timing.DRAMTimings(**cfg["timings_ns"])
        self.mech_cfgs = [timing.MechConfig(
            mechanism=p["mechanism"], seg_blocks=p["seg_blocks"],
            cache_rows=p["cache_rows"], policy=p["policy"],
            insert_threshold=p["insert_threshold"],
            benefit_bits=p["benefit_bits"]) for p in self.points]
        self.prog_apps = [tuple(traces.AppParams(**dataclasses.asdict(a))
                                for a in apps) for apps in self.apps]
        self.prog_traces = [[dram.Trace(*[tr[f] for f in
                                          tracegen.TRACE_FIELDS])
                             for tr in trs] for trs in self.pool]

    def run(self, k: int):
        return self.sim.sweep_traces(self.prog_traces[k], self.mech_cfgs,
                                     self.prog_apps, t=self.timings,
                                     device=self.device)

    def counters(self) -> Dict[str, int]:
        """The program's own counters, read before and after the window."""
        return {"sim_scan.launches": self.scan.COUNTER.launches}


def _check_program(cfg: dict) -> None:
    """The program has to simulate the configuration's system: its fixed
    geometry, MSHRs, tick and core / energy model as the file states."""
    from repro_torch.core import dram, energy, simulator, timing
    have = {"geometry": dataclasses.asdict(timing.GEOM),
            "mshr_per_core": dram.N_MSHR,
            "ticks_per_ns": timing.TICKS_PER_NS,
            "energy": dataclasses.asdict(energy.ENERGY),
            "core_model": {"cpu_ghz": simulator.CPU_GHZ,
                           "cpi_exec": simulator.CPI_EXEC,
                           "mlp_intensive": simulator.MLP_INTENSIVE,
                           "mlp_non_intensive": simulator.MLP_NON}}
    for key, val in have.items():
        if cfg[key] != val:
            raise ValueError(f"the program's {key} {val} is not the "
                             f"configuration's {cfg[key]}")


def setup(cfg: dict, traffic: dict, seed: int, device, pending,
          mark=lambda what: None) -> SweepJob:
    return SweepJob(cfg, traffic, seed, device, pending, mark)
