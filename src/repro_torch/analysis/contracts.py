"""Launch contracts: declarative replay budgets for the port's entry points,
the counterpart of ``repro.analysis.contracts``.

The JAX package budgets *fresh compilations*: one compiled scan for a whole
grid.  Torch compiles nothing, so a port ``Contract`` names one entry
point, the *representative grid* that exercises it (the JAX package's grids,
copied), and two budgets:

* ``max_launches`` — replays the grid takes, counted in ``dram.REPLAYS``
  (one per replay: one ``sim_scan`` launch on the card, one eager loop
  on the CPU); the generator contract counts generator structures built
  (``workload.gen_trace_count``).  The port's "one compiled scan for the
  whole grid" is "one replay launch for the whole grid";
* ``max_builds`` — kernel libraries ``kernels/_build.py`` compiles or opens
  while the grid runs (``_build.load_count``): the counterpart of a fresh
  compilation.  ``None`` leaves a contract's builds unbudgeted; on the CPU
  no library is opened, so it is 0 there.

``static_args`` records what is ALLOWED to cost a separate replay — the
reviewable statement of the StaticConfig/MechParams split for that entry.
Budgets are maxima: a grid's launch count is a property of the code, while
its build count depends on what the process loaded before.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.analysis import findings as F
from repro_torch.device import resolve_device

# ---------------------------------------------------------------------------
# the shared grids (the JAX package's, copied)

# 8 configs, one static structure: threshold x benefit_bits grid
TIMINGS_GRID = [dict(insert_threshold=th, benefit_bits=bb)
                for th in (1, 2, 4, 8) for bb in (4, 5)]
# fig 12 / fig 13 knobs
CAPACITY_GRID = [dict(cache_rows=cr) for cr in (2, 4, 8, 16, 32, 64)]
SEGMENT_GRID = [dict(seg_blocks=sb) for sb in (8, 16, 32, 64, 128)]


class Observed(NamedTuple):
    launches: int    # replays (or generator structures) the grid took
    builds: int      # kernel libraries opened while it ran


@dataclasses.dataclass(frozen=True)
class Contract:
    """One entry point's launch and build budgets.

    ``run(device)`` executes the representative grid on ``device`` and
    returns its ``Observed`` counts."""
    name: str
    description: str
    max_launches: int
    max_builds: Optional[int]
    static_args: Tuple[str, ...]
    run: Callable[[torch.device], Observed]


REGISTRY: Dict[str, Contract] = {}


def contract(name: str, description: str, max_launches: int,
             static_args: Tuple[str, ...], max_builds: Optional[int] = None):
    def deco(fn):
        REGISTRY[name] = Contract(name, description, max_launches,
                                  max_builds, static_args, fn)
        return fn
    return deco


def _violations(c: Contract, observed: Observed) -> List[str]:
    out = []
    if observed.launches > c.max_launches:
        out.append(f"{observed.launches} launch(es) > budget "
                   f"{c.max_launches}")
    if c.max_builds is not None and observed.builds > c.max_builds:
        out.append(f"{observed.builds} kernel build(s) > budget "
                   f"{c.max_builds}")
    return out


def assert_launch_budget(name: str, observed: Observed) -> None:
    """The caller-side gate (``assert_jit_budget``'s counterpart): observed
    counts against the declared budgets (the AssertionError text carries
    the contract)."""
    c = REGISTRY[name]
    bad = _violations(c, observed)
    assert not bad, (
        f"launch contract `{name}` violated: {'; '.join(bad)} (allowed "
        f"separate-replay keys: {', '.join(c.static_args)}) — "
        f"{c.description}")


# ---------------------------------------------------------------------------
# representative inputs (small on purpose: contracts gate COUNTS, not
# performance, so a 256-request trace proves the same property as 1M)

@functools.lru_cache(maxsize=None)
def _toy_trace(device: torch.device):
    from repro_torch.core import dram, workload
    spec = workload.preset("zipf_reuse", n_cores=2, n_channels=1,
                           per_channel=256, seed=3)
    tr = workload.generate(spec, device=device)
    return dram.Trace(*[a[0] for a in tr])   # (C, T) -> (T,)


def _stack_params(cfgs, device):
    from repro_torch.core.timing import stack_params
    return stack_params([c.params(device=device) for c in cfgs])


def _counted(fn, device, count=None) -> Observed:
    """Run ``fn()`` to the end of its device work and count the launches
    (``count()``, default ``dram.replay_count``) and library loads it
    causes."""
    from repro_torch.core import dram
    from repro_torch.kernels import _build
    count = count or dram.replay_count
    r0, b0 = count(), _build.load_count()
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return Observed(count() - r0, _build.load_count() - b0)


def _grid(grid_kw, device) -> Observed:
    from repro_torch.core import dram
    from repro_torch.core.timing import paper_config, shared_static
    cfgs = [paper_config("figcache_fast", **kw) for kw in grid_kw]
    static = shared_static(cfgs)
    tr = _toy_trace(device)
    params = _stack_params(cfgs, device)
    return _counted(lambda: dram.run_sweep(tr, static, params,
                                           device=device), device)


# ---------------------------------------------------------------------------
# the contracts

_SWEEP_KEYS = ("StaticConfig", "variant", "trace/batch shapes")


@contract("sweep.timings",
          "insert_threshold x benefit_bits grid batches into one replay "
          "(pure MechParams knobs)", 1, _SWEEP_KEYS)
def _c_timings(device) -> Observed:
    return _grid(TIMINGS_GRID, device)


@contract("sweep.capacity",
          "fig 12 cache-capacity grid (cache_rows 2..64) shares one padded "
          "FTS structure: one replay for the whole grid", 1, _SWEEP_KEYS)
def _c_capacity(device) -> Observed:
    return _grid(CAPACITY_GRID, device)


@contract("sweep.segment",
          "fig 13 segment-size grid (seg_blocks 8..128) shares one padded "
          "FTS structure: one replay for the whole grid", 1, _SWEEP_KEYS)
def _c_segment(device) -> Observed:
    return _grid(SEGMENT_GRID, device)


@contract("sweep.warm-cache",
          "re-dispatching an already-run grid is one replay and opens no "
          "kernel library: MechParams values are not build keys",
          1, _SWEEP_KEYS, max_builds=0)
def _c_warm(device) -> Observed:
    _grid(CAPACITY_GRID, device)          # warm (budgeted by sweep.capacity)
    return _grid(CAPACITY_GRID, device)   # measured: no library opened


@contract("simulator.sweep_traces",
          "W workloads x N configs of one static structure run as one "
          "replay (ragged traces no-op padded, specs generated on the "
          "device)", 1,
          ("StaticConfig", "sched policy", "padded trace shape"))
def _c_sweep_traces(device) -> Observed:
    from repro_torch.core import simulator, workload
    from repro_torch.core.timing import paper_config
    specs = [workload.preset("zipf_reuse", n_cores=2, n_channels=1,
                             per_channel=n, seed=s)
             for n, s in ((192, 1), (256, 2))]
    cfgs = [paper_config("figcache_fast", insert_threshold=th)
            for th in (1, 4)]
    return _counted(lambda: simulator.sweep_traces(specs, cfgs,
                                                   device=device), device)


@contract("streaming.chunked-replay",
          "a chunked streamed replay is one replay per segment: SimState "
          "out is SimState in, so the 256-request trace in 64-request "
          "chunks takes 4 launches (DESIGN.md §13)", 4,
          ("StaticConfig", "variant", "segment count"))
def _c_chunked_replay(device) -> Observed:
    from repro_torch.core import streaming
    from repro_torch.core.timing import paper_config
    cfg = paper_config("figcache_fast")
    tr = _toy_trace(device)                 # (256,) -> 4 chunks of 64
    return _counted(lambda: streaming.simulate_stream(
        streaming.iter_chunks(tr, 64), cfg, device=device), device)


@contract("orchestrator.shard-sweep",
          "a sharded orchestrated sweep replays each shard segment once "
          "through its (static, sched) group's lanes: one shard of 3 "
          "segments — checkpoints and manifest included — is 3 launches "
          "(DESIGN.md §14)", 3,
          ("StaticConfig", "sched policy", "segment count"))
def _c_shard_sweep(device) -> Observed:
    import tempfile
    from repro_torch.core import workload
    from repro_torch.core.timing import paper_config
    from repro_torch.launch import orchestrator
    specs = [workload.preset("zipf_reuse", n_cores=2, n_channels=2,
                             per_channel=192, seed=9)]
    cfgs = [paper_config("figcache_fast", cache_rows=cr) for cr in (16, 32)]
    plan = orchestrator.make_plan(specs, cfgs, chunk_len=64)

    def run():
        with tempfile.TemporaryDirectory() as d:
            orchestrator.Orchestrator(plan, d, backoff_s=0.0,
                                      devices=[device]).run()
    return _counted(run, device)


def _tel_sweep(cfgs, device, check=None) -> Observed:
    from repro_torch.core import streaming
    from repro_torch.core.timing import shared_static
    from repro_torch.obs.telemetry import WindowCollector
    static = shared_static(cfgs)
    tr = _toy_trace(device)
    params = _stack_params(cfgs, device)
    col = WindowCollector()
    obs = _counted(lambda: streaming.sweep_stream(
        streaming.iter_chunks(tr, 64), static, params, telemetry=col,
        device=device), device)
    if col.n_segments != 4 or not len(col.series(index=(0,))["win_idx"]):
        raise RuntimeError(f"expected 4 collected segments with windows, "
                           f"got {col.n_segments}")
    if check is not None:
        check(col)
    return obs


@contract("obs.telemetry-sweep",
          "a telemetry-enabled capacity sweep streams chunked through the "
          "telemetry replay, one launch per segment: the window carry and "
          "frames do not split the grid (DESIGN.md §15)", 4,
          ("StaticConfig (incl. telemetry period)", "variant",
           "segment count"))
def _c_telemetry_sweep(device) -> Observed:
    from repro_torch.core.timing import paper_config
    cfgs = [dataclasses.replace(paper_config("figcache_fast", **kw),
                                telemetry=64) for kw in CAPACITY_GRID]
    return _tel_sweep(cfgs, device)


@contract("obs.tail-latency",
          "the §16 latency-distribution path — histogram planes in the "
          "telemetry carry, chunked collection, host-side percentile/SLO "
          "extraction — replays a whole SLO-threshold grid once per "
          "segment: slo_ns is a MechParams knob, and percentile extraction "
          "is host numpy (no extra launches)", 4,
          ("StaticConfig (incl. telemetry period)", "variant",
           "segment count"))
def _c_tail_latency(device) -> Observed:
    import numpy as np
    from repro_torch.core.timing import paper_config
    from repro_torch.obs import latency
    cfgs = [dataclasses.replace(paper_config("figcache_fast"),
                                telemetry=64, slo_ns=slo)
            for slo in (50, 100, 200, 400)]

    def check(col):
        for p in range(len(cfgs)):
            cum = col.cumulative(index=(p,))
            pct = latency.percentiles(cum["hist"].sum(axis=(0, 1)))
            if not np.isfinite(pct["p99"].value):
                raise RuntimeError(f"p99 of grid point {p} is not finite")
            s = col.series(index=(p,))
            if int(s["w_slo"].sum()) != int(cum["slo"].sum()):
                raise RuntimeError(f"windowed SLO count of grid point {p} "
                                   f"disagrees with the cumulative plane")
    return _tel_sweep(cfgs, device, check)


@contract("workload.generate_many",
          "a workload grid sharing one generator structure synthesizes as "
          "ONE batched generator", 1,
          ("family", "n_cores x n_channels x per_channel shape"))
def _c_generate_many(device) -> Observed:
    from repro_torch.core import workload
    specs = [workload.preset("zipf_reuse", n_cores=2, n_channels=1,
                             per_channel=320, seed=s) for s in (5, 6, 7)]
    return _counted(lambda: workload.generate_many(specs, device=device),
                    device, workload.gen_trace_count)


# ---------------------------------------------------------------------------
# the pass

def check_contract(name: str, device=None,
                   observed: Optional[Dict[str, Observed]] = None
                   ) -> List[F.Finding]:
    """Run one contract's grid on ``device`` (``None``: the CUDA device);
    its findings.  ``observed`` (a dict), when given, receives the counts
    under the contract's name."""
    c = REGISTRY[name]
    try:
        got = c.run(resolve_device(device))
    except Exception as e:    # noqa: BLE001 - a crashing grid IS a finding
        return [F.Finding(
            rule="launch-contract", entry=name,
            message=f"representative grid failed to run: "
                    f"{type(e).__name__}: {e}")]
    if observed is not None:
        observed[name] = got
    bad = _violations(c, got)
    if bad:
        return [F.Finding(
            rule="launch-contract", entry=name,
            message=f"{'; '.join(bad)}; allowed separate-replay keys are "
                    f"{', '.join(c.static_args)} — {c.description}")]
    return []


def check_all(names: Optional[List[str]] = None, device=None,
              observed: Optional[Dict[str, Observed]] = None) -> F.Report:
    rep = F.Report(passes=["launch-contracts"])
    for name in (names if names is not None else list(REGISTRY)):
        rep.scanned.append(name)
        rep.extend(check_contract(name, device, observed))
    return rep


CHECKS = {"launch-contract":
          "entry point exceeded its declared launch or kernel-build budget"}

# port rule -> the JAX package's rule it stands for
RENAMED = {"launch-contract": "compile-contract"}
