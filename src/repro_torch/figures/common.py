"""The figures' shared plumbing: trace sizes, the workload sets, and the
cached traces and result batches the figures share.

Counterpart of ``benchmarks/common.py``.  The sizes and the device are
explicit arguments (``Sizes``, ``device``) rather than a module global,
and both are part of every cache key.  Every cached trace or batch is
keyed on a **content hash** of what determines it
(``workload.content_hash`` over the app tuples / specs, request counts
and seeds), so figs 8-11 share one workloads x mechanisms batch and figs
12-16 share the traces of workloads 5 and 17.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.core import simulator, traces, workload


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Requests per trace: one core's trace (fig 7), one channel of an
    eight-core trace (figs 3, 8-11, 13, 15, 17, tail latency) and one
    channel of the longer eight-core traces (figs 12, 14, 16).  ``quick``
    lets a figure rescale a knob so shrunken traces still fill the cache
    (fig 12's ``cache_rows``)."""
    reqs_1core: int
    reqs_8core: int
    long_8core: int
    quick: bool


FULL = Sizes(reqs_1core=10240, reqs_8core=6144, long_8core=12288,
             quick=False)
QUICK = Sizes(reqs_1core=2048, reqs_8core=1024, long_8core=2048, quick=True)

# two workloads per intensity class
WL_IDX = {25: [0, 2], 50: [5, 7], 75: [10, 12], 100: [15, 17]}
# flattened, in intensity order: figs 8-11 key eight_core_batch on this
# exact tuple so they share ONE cached workloads x mechanisms batch
ALL_WL = tuple(i for idxs in WL_IDX.values() for i in idxs)
# the two workloads (one at 50 %, one at 100 % intensity) figs 12-16 sweep
SWEEP_WL = (WL_IDX[50][0], WL_IDX[100][1])
SEED_8CORE = 2      # the eight-core traces and the scenario specs

_CACHE: Dict[tuple, object] = {}


def clear_cache() -> None:
    _CACHE.clear()


def _cached(kind: str, key_obj, sizes: Sizes, device: torch.device, build):
    key = (kind, workload.content_hash(key_obj), sizes, str(device))
    if key not in _CACHE:
        _CACHE[key] = build()
    return _CACHE[key]


def eight_trace(idx: int, sizes: Sizes, device: torch.device,
                per_channel: int | None = None, seed: int = SEED_8CORE):
    """The (trace, apps) of one multiprogrammed workload, built once on
    the host."""
    _, _, apps = traces.eight_core_workloads()[idx]
    pc = per_channel or sizes.reqs_8core
    return _cached(
        "eight_trace", (tuple(apps), pc, seed), sizes, device,
        lambda: (traces.build_trace(apps, 4, pc, seed), tuple(apps)))


def single_core_batch(apps: tuple, sizes: Sizes, device: torch.device,
                      mechs=simulator.PAPER_MECHS):
    """All apps x all mechanisms via stacked traces: one replay per static
    structure covers the whole fig-7 cross product."""
    return _cached(
        "single_core_batch", (apps, tuple(mechs), sizes.reqs_1core), sizes,
        device, lambda: simulator.run_single_core_batch(
            list(apps), mechanisms=mechs, n_reqs=sizes.reqs_1core,
            device=device))


def eight_core_batch(idxs: tuple, sizes: Sizes, device: torch.device,
                     mechs=simulator.PAPER_MECHS, per_channel=None):
    """All workloads x all mechanisms via stacked traces (fig 8)."""
    wls = [traces.eight_core_workloads()[i] for i in idxs]
    pc = per_channel or sizes.reqs_8core
    apps_key = tuple(tuple(apps) for _, _, apps in wls)

    def build():
        res = simulator.run_eight_core_batch(wls, mechanisms=mechs,
                                             per_channel=pc, device=device)
        return dict(zip(idxs, res))

    return _cached("eight_core_batch", (apps_key, tuple(mechs), pc), sizes,
                   device, build)


def eight_core_grid(idx: int, cfgs, sizes: Sizes, device: torch.device,
                    per_channel: int | None = None):
    """Sweep a config grid over one workload: one replay per static
    structure and controller (``simulator.sweep``)."""
    tr, apps = eight_trace(idx, sizes, device, per_channel)
    return simulator.sweep(tr, list(cfgs), apps, device=device)


def sweep_grid(cfgs, sizes: Sizes, device: torch.device,
               per_channel: int | None = None):
    """``{workload index: [RunResult per config]}`` over ``SWEEP_WL``."""
    return {i: eight_core_grid(i, cfgs, sizes, device, per_channel)
            for i in SWEEP_WL}


def scenario_specs(sizes: Sizes, per_channel: int | None = None,
                   n_cores: int = 8, n_channels: int = 4,
                   seed: int = SEED_8CORE) -> Dict[str, workload.WorkloadSpec]:
    """One preset ``WorkloadSpec`` per scenario family (DESIGN.md §11) at
    the figures' trace scale: the workload axis figs 3, 17 and the
    tail-latency figure sweep."""
    pc = per_channel or sizes.reqs_8core
    return {fam: workload.preset(fam, n_cores=n_cores,
                                 n_channels=n_channels, per_channel=pc,
                                 seed=seed)
            for fam in workload.FAMILIES}


def scenario_trace(spec: workload.WorkloadSpec, sizes: Sizes,
                   device: torch.device):
    """Generate (and cache, by spec content) one scenario trace on
    ``device``."""
    return _cached("scenario_trace", spec, sizes, device,
                   lambda: workload.generate(spec, device=device))
