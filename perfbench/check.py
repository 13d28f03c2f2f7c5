"""The comparison that decides ``correct``, and the helper processes of a
run.

``verdict`` takes what a driver's job returns from its ``check``: each
number compared with its own limit, ``{name: (value, limit)}``.  A run is
correct where every value is at most its limit.

``compare`` is the simulator's comparison, which the ``sweep_traces``
driver returns.  The simulator is exact integer arithmetic, so every
comparison is exact and every limit is 0 (``LIMITS``):

* ``counters_mismatched``: counter elements (every leaf of every channel
  of every (workload, config point) pair, in every job of the window)
  that differ from the reference's replay of the same trace;
* ``results_max_rel_gap``: the widest relative gap of a derived result
  (per-core IPC and latency, hit rates, execution time, every energy
  part) from the reference's, on the same pairs;
* ``results_missing``: results a job did not return, or returned in
  another shape;

The harness adds ``jobs_failed`` (jobs that raised; limit 0) to every
driver's numbers.

The reference replays run in ``WORKERS`` processes of their own (spawned,
numpy only), each handed every trace once.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import importlib
import multiprocessing
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

LIMITS = {"counters_mismatched": 0, "results_max_rel_gap": 0.0,
          "results_missing": 0}
# processes that make the traces and run the reference: the cores the
# run may use, less two for the run itself and the card's driver
WORKERS = max(1, min(6, len(os.sched_getaffinity(0)) - 2))

_STATE: dict = {}


def _init(module: str, cfg: dict, pool, points, resolution: int) -> None:
    _STATE.update(ref=importlib.import_module(module), cfg=cfg, pool=pool,
                  points=points, resolution=resolution)


def _one(job: Tuple[int, int, int]) -> Dict[str, np.ndarray]:
    k, w, i = job
    s = _STATE
    return s["ref"].simulate_workload(s["pool"][k][w], s["points"][i],
                                      s["cfg"], s["resolution"])


@contextlib.contextmanager
def processes(workers: int):
    """``workers`` spawned processes (None for 0); on an error the work
    not yet started is dropped, and every process has ended on exit."""
    if workers <= 0:
        yield None
        return
    ex = concurrent.futures.ProcessPoolExecutor(
        max_workers=workers, mp_context=multiprocessing.get_context("spawn"))
    try:
        yield ex
    except BaseException:
        ex.shutdown(wait=True, cancel_futures=True)
        raise
    ex.shutdown(wait=True)


def end_helpers() -> None:
    """Wait for multiprocessing's resource tracker, the helper process
    that the spawned pools start, to end; it would outlive the pools."""
    import gc
    from multiprocessing import resource_tracker
    gc.collect()                   # the pools' semaphores are unlinked
    stop = getattr(resource_tracker._resource_tracker, "_stop", None)
    if stop is not None:
        stop()


def map_reference(module: str, cfg: dict, pool, points,
                  jobs: Sequence[Tuple[int, int, int]], resolution: int,
                  workers: int) -> List[Dict[str, np.ndarray]]:
    """The reference's counters of each ``(set, workload, point)`` job,
    in ``workers`` spawned processes (0: in this one)."""
    args = (module, cfg, pool, points, resolution)
    if workers <= 0:
        _init(*args)
        try:
            return [_one(j) for j in jobs]
        finally:
            _STATE.clear()
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=workers, mp_context=ctx, initializer=_init,
            initargs=args) as ex:
        return list(ex.map(_one, jobs, chunksize=max(
            1, len(jobs) // (8 * workers))))


def rel_gap(got, want) -> float:
    """Widest ``|got - want| / |want|``, where an element that differs
    from a ``want`` of 0, or is NaN, counts 1; a result of another shape
    raises ``TypeError``."""
    a = np.asarray(got, dtype=np.float64)
    b = np.asarray(want, dtype=np.float64)
    if a.shape != b.shape:
        raise TypeError(f"shape {a.shape}, expected {b.shape}")
    if np.array_equal(a, b):
        return 0.0
    with np.errstate(divide="ignore", invalid="ignore"):
        g = np.abs(a - b) / np.abs(b)
    g = np.where(np.isfinite(g), g, 1.0)
    return float(np.where(a == b, 0.0, g).max())


RESULT_FIELDS = ("ipc", "avg_lat_ns", "row_hit_rate", "cache_hit_rate",
                 "exec_time_ns", "dram_energy_nj", "system_energy_nj")


def result_gap(res, want: dict) -> float:
    """Widest relative gap of a program ``RunResult``'s derived fields and
    energy parts from ``want`` (the reference's ``derive``)."""
    gaps = [rel_gap(getattr(res, f), want[f]) for f in RESULT_FIELDS]
    gaps += [rel_gap(res.energy_parts[k], v)
             for k, v in want["energy_parts"].items()]
    return max(gaps)


def counter_mismatches(res, want: Dict[str, np.ndarray]) -> int:
    """Elements of the program's counters that differ from ``want``; a
    leaf of another shape or dtype counts whole."""
    n = 0
    for k, w in want.items():
        got = np.asarray(getattr(res.counters, k))
        if got.shape != w.shape or got.dtype != w.dtype:
            n += w.size
        else:
            n += int((got != w).sum())
    return n


def compare(done: Sequence[Tuple[int, object]], expected: dict,
            n_workloads: int, n_points: int
            ) -> Dict[str, Tuple[float, float]]:
    """The numbers of ``LIMITS``, each with its limit, over the window's
    jobs ``done`` (``(trace set, results[w][i])``) against ``expected``
    (``{(set, w, i): {"counters", "result"}}``)."""
    out = {"counters_mismatched": 0, "results_max_rel_gap": 0.0,
           "results_missing": 0}
    for k, results in done:
        for w in range(n_workloads):
            row = results[w] if results is not None and \
                len(results) == n_workloads else None
            for i in range(n_points):
                res = row[i] if row is not None and len(row) == n_points \
                    else None
                want = expected[(k, w, i)]
                try:
                    out["counters_mismatched"] += counter_mismatches(
                        res, want["counters"])
                    out["results_max_rel_gap"] = max(
                        out["results_max_rel_gap"],
                        result_gap(res, want["result"]))
                except (AttributeError, KeyError, TypeError):
                    out["results_missing"] += 1
    return {k: (v, LIMITS[k]) for k, v in out.items()}


def verdict(checks: Dict[str, Tuple[float, float]]) -> bool:
    """Every number at most its limit (and at least one number)."""
    return bool(checks) and all(v <= lim for v, lim in checks.values())
