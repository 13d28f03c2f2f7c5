"""The plain reference against the program's eager path on the CPU:
every counter bit for bit, and every derived result, for cached and
cache-less mechanisms (small caches too, so evictions and dirty
write-backs happen)."""
import dataclasses

import numpy as np
import pytest

from perfbench import check, harness, tracegen
from perfbench.drivers import sweep_traces as driver
from perfbench.reference import ddr4_sim as ref
from repro_torch.core import dram, simulator, timing, traces


def _cfg(name="figcache-ddr4-8core"):
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    entry = {c["name"]: c for c in bench["configs"]}[name]
    return harness.load_json(harness.ROOT / entry["file"])


def _program(trs, apps, points):
    cfgs = [timing.MechConfig(
        mechanism=p["mechanism"], seg_blocks=p["seg_blocks"],
        cache_rows=p["cache_rows"], insert_threshold=p["insert_threshold"])
        for p in points]
    return simulator.sweep_traces(
        [dram.Trace(*[t[f] for f in tracegen.TRACE_FIELDS]) for t in trs],
        cfgs, [tuple(traces.AppParams(**dataclasses.asdict(a)) for a in aa)
               for aa in apps], device="cpu")


@pytest.mark.parametrize("points", [
    [("base", {}), ("figcache_fast", {})],
    [("lldram", {}), ("lisa_villa", {"cache_rows": 2}),
     ("figcache_slow", {"cache_rows": 1, "seg_blocks": 32}),
     ("figcache_ideal", {"cache_rows": 1, "seg_blocks": 8,
                         "insert_threshold": 2})],
], ids=["paper", "small-caches"])
def test_reference_equals_the_program_bitwise(points):
    cfg = _cfg()
    mixes = tracegen.eight_core_workloads()
    apps = [mixes[5][2], mixes[17][2]]
    trs = [tracegen.build_trace(a, 4, 400, 3_000_000_001 + i)
           for i, a in enumerate(apps)]
    pts = [ref.mech_point(cfg, m, **kw) for m, kw in points]
    res = _program(trs, apps, pts)
    wb = 0
    for w, tr in enumerate(trs):
        for i, p in enumerate(pts):
            want = ref.simulate_workload(tr, p, cfg)
            assert check.counter_mismatches(res[w][i], want) == 0, p
            derived = ref.derive(want, p, driver.app_dicts(apps[w]), cfg)
            assert check.result_gap(res[w][i], derived) == 0.0, p
            wb += int(want["wb_blocks"].sum())
    if len(points) > 2:
        assert wb > 0              # dirty victims were written back


def test_reference_one_core_one_channel():
    cfg = _cfg("figcache-ddr4-1core")
    apps = [[tracegen.app_params("mcf")], [tracegen.app_params("gcc")]]
    trs = [tracegen.build_trace(a, 1, 300, 17 + i)
           for i, a in enumerate(apps)]
    pts = [ref.mech_point(cfg, m) for m in ("base", "figcache_fast")]
    res = _program(trs, apps, pts)
    for w, tr in enumerate(trs):
        for i, p in enumerate(pts):
            want = ref.simulate_workload(tr, p, cfg)
            assert check.counter_mismatches(res[w][i], want) == 0
            assert check.result_gap(res[w][i], ref.derive(
                want, p, driver.app_dicts(apps[w]), cfg)) == 0.0


def test_noop_padding_is_inert():
    cfg = _cfg()
    tr = tracegen.build_trace(tracegen.eight_core_workloads()[0][2], 4, 64, 5)
    pad = {f: np.concatenate([v, np.full((4, 16), tracegen.NOOP_ISSUE
                                         if f == "t_issue" else 0,
                                         dtype=v.dtype)], axis=1)
           for f, v in tr.items()}
    p = ref.mech_point(cfg, "figcache_fast")
    a, b = ref.simulate_workload(tr, p, cfg), ref.simulate_workload(pad, p, cfg)
    for k in ref.COUNTERS:
        np.testing.assert_array_equal(a[k], b[k])


def test_reference_refuses_what_it_does_not_model():
    with pytest.raises(ValueError):
        ref.mech_point(_cfg(), "figcache_fast", policy="lru")
