"""The control of ``correct``: the reference computed at a precision below
the configuration's, put in the program's place, has to come out as not
correct.

The configuration states times at 1/8 ns (ticks).  The control replays
every (workload, config point) pair of every trace set of a cell, at the
cell's own size and from its seed, in whole nanoseconds (``resolution``
8: issue times and timings rounded to whole ns), and hands its results to
the cell's comparison as if the program had returned them.  The
comparison's numbers are printed per seed; a sound benchmark reads every
one of them as failing.  The benchmark's own runs do not run it.

    python3 perfbench/controls.py --workload <cell> --seeds 1 2 3
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import types
from pathlib import Path


def as_results(job, expected: dict, k: int):
    """``results[w][i]`` shaped like the program's, from reference
    counters and derived fields (``expected[(k, w, i)]``)."""
    out = []
    for w in range(len(job.apps)):
        row = []
        for i in range(len(job.points)):
            e = expected[(k, w, i)]
            r = dict(e["result"])
            row.append(types.SimpleNamespace(
                counters=types.SimpleNamespace(**e["counters"]), **r))
        out.append(row)
    return out


def control_numbers(bench: dict, cell: str, seed: int, workers: int,
                    config_patch=None, traffic_patch=None) -> dict:
    """The comparison's numbers with the control's results in the
    program's place, one job per trace set."""
    from perfbench import check as check_lib
    from perfbench import harness
    _, _, cfg, traffic = harness.cell_of(bench, cell)
    cfg = {**cfg, **(config_patch or {})}
    traffic = {**traffic, **(traffic_patch or {})}
    driver = harness.load_file("drivers", traffic["driver"])
    job = driver.Reference(cfg, traffic, seed)
    expected = job.reference(workers=workers)
    control = job.reference(resolution=8, workers=workers)
    done = [(k, as_results(job, control, k)) for k in range(len(job.pool))]
    checks = job.check(done, expected)
    return {"numbers": {k: v for k, (v, _) in checks.items()},
            "correct": check_lib.verdict(checks)}


def main(argv=None) -> int:
    root = Path(__file__).resolve().parents[1]
    sys.path[0:1] = [str(root)]
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    from perfbench import check, harness
    bench = harness.load_json(root / "BENCHMARK.json")
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = control_numbers(bench, args.workload, seed, check.WORKERS)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": round(time.perf_counter() - t0, 1),
                          **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
