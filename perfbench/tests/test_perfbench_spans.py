"""The readers of the program's spans (``perfbench/spans.py`` and the seven
``dispatch.*`` metrics it feeds): the attribution rule on a made-up
timeline, ``None`` without spans, and a traced tiny run of every cell on
the CPU."""
import itertools
import random
import sys
import types

import pytest

from perfbench import harness, spans
from perfbench.trace import Timeline

IDLE = ["dispatch.params_idle_ms_per_job", "dispatch.layout_idle_ms_per_job",
        "dispatch.launch_idle_ms_per_job", "dispatch.results_idle_ms_per_job",
        "dispatch.unspanned_idle_ms_per_job"]
COUNTS = ["dispatch.h2d_copies_per_job", "dispatch.h2d_bytes_per_job"]
faults = harness.load_file("tests", "test_perfbench_faults")
# copies a job of each tiny cell makes: 15 a config point, 2 + 6 a group
COPIES = {"ddr4-8core.paper-grid": 6 * (15 + 8),
          "ddr4-1core.paper-grid": 6 * (15 + 8),
          "ddr4-8core.design-sweep": 9 * 15 + 2 * 8}


def _reader(name):
    return harness.load_file("metrics", name).read


def _span(recs, ids, name, start, end, parent=None, **counts):
    i = next(ids)
    job = i if parent is None else next(
        r["args"]["job"] for r in recs
        if r["ph"] == "B" and r["args"]["id"] == parent)
    recs.append({"name": name, "ph": "B", "ts": start,
                 "args": {"id": i, "parent": parent, "job": job}})
    recs.append({"name": name, "ph": "E", "ts": end,
                 "args": {"id": i, **counts}})
    return i


def _made_up():
    """Two jobs, [0, 1000) and [2000, 2600) ns.  Job 1: a root over [10,
    990) holding a group over [20, 900) holding params [30, 200) (3 copies,
    12 B) and a run [300, 500) (device ops [250, 400) straddling its start
    and [450, 800)); an idle gap under no span at [990, 1000).  Job 2 has
    no spans: all its idle time (600 - 100 busy) is unspanned.  A root
    outside every job is left out."""
    ids = itertools.count(1)
    recs = []
    root = _span(recs, ids, "sweep", 10, 990)
    group = _span(recs, ids, "sweep.group", 20, 900, root)
    _span(recs, ids, "sweep.params", 30, 200, group, h2d_copies=3,
          h2d_bytes=12)
    _span(recs, ids, "replay.run", 300, 500, group)
    _span(recs, ids, "sweep", 3000, 3100, None, h2d_copies=99)
    tl = Timeline(jobs=[(0, 1000), (2000, 2600)],
                  device=[("k", 250, 400), ("k", 450, 800),
                          ("c", 2100, 2200)], host=[])
    return tl, recs


def _ctx(tl):
    return types.SimpleNamespace(tl=tl, n_jobs=len(tl.jobs))


def test_idle_time_goes_to_the_innermost_span(monkeypatch):
    tl, recs = _made_up()
    monkeypatch.setattr(spans, "records", lambda: recs)
    ctx = _ctx(tl)
    got = {m: _reader(m)(ctx) for m in IDLE + COUNTS}
    # job 1: params [30, 200) = 170; run [300, 500) idle [400, 450) = 50;
    # unspanned: [0, 30) + [200, 250) + [800, 1000) = 280 (group, root,
    # none); layout, results 0.  Job 2: 500 unspanned.  Two jobs.
    ms = 1e-6 / 2
    assert got["dispatch.params_idle_ms_per_job"] == pytest.approx(170 * ms)
    assert got["dispatch.launch_idle_ms_per_job"] == pytest.approx(50 * ms)
    assert got["dispatch.layout_idle_ms_per_job"] == 0
    assert got["dispatch.results_idle_ms_per_job"] == 0
    assert got["dispatch.unspanned_idle_ms_per_job"] == \
        pytest.approx(780 * ms)
    assert got["dispatch.h2d_copies_per_job"] == 1.5
    assert got["dispatch.h2d_bytes_per_job"] == 6
    host = _reader("dispatch.host_ms_per_job")(ctx)
    assert abs(sum(got[m] for m in IDLE) - host) < 1e-9


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_the_phases_add_up_to_the_host_time(monkeypatch, seed):
    """Random nested spans and device operations over three jobs."""
    rng = random.Random(seed)
    recs, device, jobs = [], [], []
    ids = iter(range(1, 10 ** 6))
    for j in range(3):
        lo = j * 10 ** 5
        hi = lo + rng.randrange(5000, 90000)
        jobs.append((lo, hi))
        for _ in range(40):
            s = rng.randrange(lo - 500, hi)
            device.append(("op", s, s + rng.randrange(1, 3000)))
        root = _span(recs, ids, "sweep", lo + 5, hi - 5)
        t = lo + 10
        for name in ["sweep.stack", "sweep.group", "sweep.params",
                     "replay.init", "replay.prepare", "replay.run",
                     "sweep.to_host", "sweep.results", "sweep.group"]:
            e = min(hi - 6, t + rng.randrange(1, 6000))
            _span(recs, ids, name, t, e, root)
            t = e
    device.sort(key=lambda s: s[1])
    tl = Timeline(jobs, device, [])
    monkeypatch.setattr(spans, "records", lambda: recs)
    ctx = _ctx(tl)
    host = _reader("dispatch.host_ms_per_job")(ctx)
    assert abs(sum(_reader(m)(ctx) for m in IDLE) - host) < 1e-9


@pytest.mark.parametrize("program", ["without the recorder", "no records"])
def test_every_reader_is_none_without_spans(monkeypatch, program):
    tl, recs = _made_up()
    if program == "without the recorder":      # the parent's program
        monkeypatch.setitem(sys.modules, "repro_torch.obs.trace",
                            types.ModuleType("repro_torch.obs.trace"))
        assert spans.records() == []
    else:                                       # a root outside the jobs
        monkeypatch.setattr(spans, "records", lambda: recs[-2:])
    for m in IDLE + COUNTS:
        assert _reader(m)(_ctx(tl)) is None
    assert _reader("dispatch.host_ms_per_job")(_ctx(tl)) > 0


@pytest.mark.parametrize("cell", sorted(faults.SMALL))
def test_a_traced_tiny_run_reads_all_seven(cell):
    out = faults.run(cell, seed=2 ** 33 + 17, trace=True)
    assert out["correct"], out["checks"]
    got = {m: out["metrics"][m]["value"] for m in IDLE + COUNTS}
    host = out["metrics"]["dispatch.host_ms_per_job"]["value"]
    assert abs(sum(got[m] for m in IDLE) - host) < 1e-9
    assert got["dispatch.h2d_copies_per_job"] == COPIES[cell]
    assert got["dispatch.h2d_bytes_per_job"] > 0
