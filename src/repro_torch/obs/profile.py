"""Profiling hooks: cold-vs-warm timing, kernel builds and dispatch counts,
the port's counterpart of ``repro.obs.profile``.

The registered launch contracts (``analysis.contracts.REGISTRY``) are the
port's list of entry points and their representative grids, so they double
as the profiling corpus: each contract runs twice — the first (cold) run
pays whatever kernel library its grid needs (``kernels/_build.py`` compiles
it with ``nvcc`` and opens it; nothing on the CPU), the second (warm) run
opens nothing — and the difference estimates the one-off cost.
``count_dispatches`` instruments the module-level entry points so the warm
run also reports how many calls each absorbed (a contract that claims one
replay for a grid should show one call into ONE entry point), beside the
``sim_scan`` launches it made.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterable, Optional

import torch

__all__ = ["count_dispatches", "profile_contracts"]

# module-level entry points worth counting: (module path, attr)
_ENTRY_POINTS = (
    ("repro_torch.core.dram", "resume"),
    ("repro_torch.core.dram", "resume_tel"),
    ("repro_torch.core.dram", "sweep_resume_tel"),
    ("repro_torch.core.dram", "run_sweep"),
    ("repro_torch.core.dram", "simulate"),
    ("repro_torch.core.sched.wavefront", "resume_waves"),
    ("repro_torch.launch.orchestrator", "shard_step"),
    ("repro_torch.launch.orchestrator", "mesh_step"),
)


@contextlib.contextmanager
def count_dispatches(entry_points=_ENTRY_POINTS):
    """Count calls into the module-level entry points.

    Wraps each entry point with a counting shim for the duration of the
    context and yields the live ``{name: count}`` dict.  Only outermost
    calls count: an entry point called from inside another (``mesh_step``
    -> ``shard_step`` -> ``dram.resume``) is part of that one dispatch, as
    a nested jit is part of its caller's compiled program in the JAX
    package.  Works because every caller in the port resolves these
    through their module attribute (or module global) at call time
    (``dram.resume(...)``), never through a name imported earlier."""
    import importlib

    counts: Dict[str, int] = {}
    depth = [0]
    saved = []
    for mod_name, attr in entry_points:
        mod = importlib.import_module(mod_name)
        fn = getattr(mod, attr)
        name = f"{mod_name.rsplit('.', 1)[-1]}.{attr}"
        counts[name] = 0

        def shim(*a, __fn=fn, __name=name, **kw):
            if depth[0] == 0:
                counts[__name] += 1
            depth[0] += 1
            try:
                return __fn(*a, **kw)
            finally:
                depth[0] -= 1

        saved.append((mod, attr, fn))
        setattr(mod, attr, shim)
    try:
        yield counts
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def profile_contracts(names: Optional[Iterable[str]] = None, device=None
                      ) -> Dict[str, dict]:
    """Cold/warm-profile registered launch contracts on ``device``
    (``None``: the CUDA device).

    Per contract: wall seconds of the cold run and the warm run (both
    synchronised), the cold run's extra (their difference, floored at 0 —
    both runs share one process), the replays and library loads each run
    counted against the budgets, the seconds ``nvcc`` took for libraries
    built during the cold run (``_build.BUILD_LOG``), the warm run's
    dispatches per entry point and its ``sim_scan`` launches."""
    from repro_torch.analysis import contracts
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build
    from repro_torch.kernels.sim_scan import sim_scan as scan_kernel

    dev = resolve_device(device)
    reg = contracts.REGISTRY
    names = list(names) if names is not None else sorted(reg)
    out: Dict[str, dict] = {}
    for name in names:
        c = reg[name]
        built = set(_build.BUILD_LOG)
        t0 = time.perf_counter()
        cold = c.run(dev)
        cold_s = time.perf_counter() - t0
        build_s = sum(s for k, (s, _) in _build.BUILD_LOG.items()
                      if k not in built)
        launches0 = scan_kernel.COUNTER.launches
        with count_dispatches() as dispatches:
            t0 = time.perf_counter()
            warm = c.run(dev)
            warm_s = time.perf_counter() - t0
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        out[name] = {
            "cold_s": round(cold_s, 4),
            "warm_s": round(warm_s, 4),
            "cold_extra_s": round(max(0.0, cold_s - warm_s), 4),
            "launches_cold": cold.launches,
            "launches_warm": warm.launches,
            "max_launches": c.max_launches,
            "builds_cold": cold.builds,
            "builds_warm": warm.builds,
            "max_builds": c.max_builds,
            "build_s": round(build_s, 4),
            "dispatches_warm": {k: v for k, v in sorted(dispatches.items())
                                if v},
            "sim_scan_launches_warm":
                scan_kernel.COUNTER.launches - launches0,
        }
    return out
