"""One run of one cell of ``BENCHMARK.json``.

Everything that belongs to a configuration, a traffic mix, a driver or a
metric is found by name: ``BENCHMARK.json`` names the cell's
configuration file and traffic mix; the traffic file
(``perfbench/traffic/<traffic>.json``) names its driver
(``perfbench/drivers/<driver>.py``); each metric is a reader of its own
(``perfbench/metrics/<metric>.py``, ``read(ctx)``, ``None`` where it has
nothing to read).

A run: set-up (the program imported, its kernels built and loaded, the
traces made, one job on every trace set as warm-up), then a closed loop
of one client for ``--seconds``: each job starts when the last one's
results are on the host.  The window closes at the end of the last job
started before the deadline.  Then the device's peak memory is read, the
process is checked for JAX, the trace (``--trace 1``) is read, and the
reference replays the checked pairs of every trace set (the driver's
``check``, with its limits; ``check.verdict``).
"""
from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import sys
import time
import traceback
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_file(kind: str, name: str) -> types.ModuleType:
    """``perfbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = BENCH / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_{kind}_{name}".replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_of(bench: dict, name: str):
    """(cell, config entry, configuration, traffic) of workload ``name``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; cells: "
                         f"{', '.join(cells)}")
    cell = cells[name]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = load_json(ROOT / entry["file"])
    traffic = load_json(BENCH / "traffic" / f"{cell['traffic']}.json")
    return cell, entry, cfg, traffic


def metrics_for(bench: dict, cell: str, trace: bool):
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


def forbidden_modules():
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


class NoDevice(Exception):
    """The machine lacks the devices the cell asks for."""


def cuda_device(chips: int):
    """The first CUDA device, when ``chips`` are there."""
    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        raise NoDevice(f"needs {chips} CUDA device(s); torch sees {have}")
    return torch.device("cuda", 0)


def run_cell(bench: dict, name: str, seed: int, seconds: float,
             trace: bool, device_of, t_start: float, config_patch=None,
             traffic_patch=None, workers=None,
             check_imports: bool = True) -> dict:
    """Set up, measure and check one run; the result line's keys but
    ``device``'s name, plus ``checks`` and ``log``.  ``device_of(chips)``
    gives the device (or raises ``NoDevice``); it is called while the
    driver makes its inputs.  ``config_patch`` / ``traffic_patch``
    override keys of the configuration / traffic file, ``workers`` the
    number of helper processes (0: none), and ``check_imports=False``
    skips the look for JAX: for the tests, whose process is not a
    benchmark's.

    Everything of the job is the driver's (``drivers/<name>.py``):
    ``start`` begins making the inputs in the helper processes, ``setup``
    gives the job; the job's ``run(k)``, ``requests[k]``, ``pool``,
    ``counters()`` (the program's counters, optional), ``reference`` and
    ``check`` (``{number: (value, limit)}``) are all the harness uses."""
    from perfbench import check as check_lib
    from perfbench import trace as trace_lib

    cell, _, cfg, traffic = cell_of(bench, name)
    cfg = {**cfg, **(config_patch or {})}
    traffic = {**traffic, **(traffic_patch or {})}
    if workers is None:
        workers = check_lib.WORKERS
    driver = load_file("drivers", traffic["driver"])
    marks = [("start", t_start)]

    def mark(what):
        marks.append((what, time.perf_counter()))

    with check_lib.processes(workers) as ex:
        pending = driver.start(cfg, traffic, seed, ex)
        import torch
        mark("torch")
        device = device_of(cell["chips"])
        mark("the device")
        job = driver.setup(cfg, traffic, seed, device, pending, mark)
    mark("inputs")
    for k in range(len(job.pool)):              # warm-up: every trace set
        job.run(k)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    mark("warm-up")
    setup_s = marks[-1][1] - t_start
    log = ["set-up: " + ", ".join(f"{n} {t - p:.2f} s" for (_, p), (n, t)
                                  in zip(marks, marks[1:]))]

    def counts():
        return job.counters() if hasattr(job, "counters") else {}

    def since(before):
        return {k: v - before[k] for k, v in counts().items()}

    tracing, traced, spans = trace, None, []
    if trace:
        trace_lib.start(device.type == "cuda")
    done, walls, requests, failed, attempted = [], [], 0, 0, 0
    counts0 = counts()
    t0 = time.perf_counter()
    deadline = t0 + seconds
    trace_until = t0 + min(seconds, trace_lib.TRACE_SECONDS)
    t_end = t0
    gc.collect()
    while not done or time.perf_counter() < deadline:
        if tracing and done and time.perf_counter() >= trace_until:
            traced, tracing = trace_lib.stop(), False
            counts_traced = since(counts0)
        k = attempted % len(job.pool)
        attempted += 1
        ns = time.time_ns()
        a = time.perf_counter()
        try:
            res = job.run(k)
        except Exception:                       # counted, then reported
            failed += 1
            log.append(f"job {attempted - 1} failed: "
                       + traceback.format_exc(limit=-3))
            if attempted >= 3 and not done:     # nothing ever completes
                break
            continue
        t_end = time.perf_counter()
        if tracing:
            spans.append((ns, time.time_ns()))
        walls.append(t_end - a)
        done.append((k, res))
        gc.freeze()             # kept for the check: no collector passes
        requests += job.requests[k]
    window_s = t_end - t0
    counts_window = since(counts0)
    if tracing:
        traced = trace_lib.stop()
        counts_traced = counts_window
    gc.unfreeze()
    if walls:
        w = sorted(walls)
        log.append(f"window: {len(walls)} jobs in {window_s:.3f} s; job ms "
                   f"first {walls[0] * 1e3:.2f}, min {w[0] * 1e3:.2f}, "
                   f"median {w[len(w) // 2] * 1e3:.2f}, max "
                   f"{w[-1] * 1e3:.2f}; set-up {setup_s:.2f} s")
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    t_trace = time.perf_counter()
    tl = trace_lib.read(traced, spans) if trace else None
    ctx = types.SimpleNamespace(
        walls_s=walls, requests=requests, window_s=window_s,
        setup_s=setup_s, n_jobs=len(spans) if trace else len(done),
        counters=counts_traced if trace else counts_window, job=job, tl=tl)
    dev_extra, breakdown = {}, None
    if tl is not None and tl.jobs:
        lo, hi = tl.window
        dev_extra = {"busy_s": trace_lib.busy_ns(tl, lo, hi) * 1e-9,
                     "window_s": (hi - lo) * 1e-9}
        breakdown = trace_lib.breakdown(tl)
        inside = sum(trace_lib.busy_in_jobs(tl))
        log.append(f"trace: {len(tl.jobs)} jobs, {len(tl.device)} device "
                   f"and {len(tl.host)} host operations read in "
                   f"{time.perf_counter() - t_trace:.1f} s; device busy "
                   f"{dev_extra['busy_s']:.4f} s of {dev_extra['window_s']:.4f},"
                   f" {inside * 1e-9:.4f} s of it inside jobs")
    metrics = {}
    for m in metrics_for(bench, name, trace):
        v = load_file("metrics", m["name"]).read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    t_ref = time.perf_counter()
    expected = job.reference(workers=workers)
    t_cmp = time.perf_counter()
    checks = {**job.check(done, expected), "jobs_failed": (failed, 0)}
    log.append(f"reference: {len(expected)} results in "
               f"{t_cmp - t_ref:.1f} s; {len(done)} jobs compared in "
               f"{time.perf_counter() - t_cmp:.1f} s")
    out = {"correct": check_lib.verdict(checks) and bool(done),
           "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": {"memory_peak_bytes": int(peak), **dev_extra},
           "checks": {k: {"value": v, "limit": lim}
                      for k, (v, lim) in checks.items()},
           "log": log}
    if breakdown is not None:
        out["breakdown"] = breakdown
    bad = forbidden_modules() if check_imports else []
    if bad:
        raise RuntimeError(f"modules of JAX or the JAX package loaded: "
                           f"{bad}")
    return out


def parse(argv):
    p = argparse.ArgumentParser(description="one run of one benchmark cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse(argv)
    bench = load_json(ROOT / "BENCHMARK.json")
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    try:
        out = run_cell(bench, args.workload, args.seed, args.seconds,
                       bool(args.trace), cuda_device, t_start)
    except NoDevice as e:
        print(f"perfbench: {args.workload} {e}", file=sys.stderr)
        return 2
    from perfbench import check as check_lib
    check_lib.end_helpers()
    import torch
    for line in out.pop("log"):
        print(line, file=sys.stderr)
    chips = cell_of(bench, args.workload)[0]["chips"]
    out["device"] = {"platform": "gpu",
                     "kind": torch.cuda.get_device_name(0),
                     "count": chips, **out["device"]}
    checks = out.pop("checks")
    out["checks"] = checks                      # the last key
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
