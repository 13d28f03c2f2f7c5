"""The program recorder (``repro_torch.obs.trace.PROGRAM``) on the sweep
path: its clock against the profiler's, silence while the profiler is
off, the span tree of one ``sweep_traces`` call, and the host-to-device
copies it counts, at tiny sizes on the CPU."""
import time

import numpy as np
import pytest
import torch

from repro_torch.core import simulator, traces
from repro_torch.core.timing import MechConfig
from repro_torch.obs import trace

CPU = torch.device("cpu")
GROUP = ["sweep.params", "replay.init", "replay.prepare", "replay.run",
         "sweep.to_host", "sweep.results"]
TRACE_BYTES = 5 * 4 + 1          # five int32 leaves and one bool a request


def _profiler_on():
    """The profiler with CPU activity, started as a ``--trace 1`` run on
    the CPU starts it."""
    from torch.autograd import profiler as P
    acts = {P.ProfilerActivity.CPU}
    cfg = P.ProfilerConfig(P.ProfilerState.KINETO, False, False, False,
                           False, False, P._ExperimentalConfig())
    P._prepare_profiler(cfg, acts)
    P._enable_profiler(cfg, acts)


def _profiler_off():
    from torch.autograd import profiler as P
    return P._disable_profiler()


@pytest.fixture(autouse=True)
def empty_recorder():
    trace.PROGRAM.events.clear()
    yield
    trace.PROGRAM.events.clear()


def _workloads(n_req=16):
    mixes = traces.eight_core_workloads()
    apps = [mixes[i][2] for i in (5, 17)]
    return [traces.build_trace(a, 4, n_req, 7 + i)
            for i, a in enumerate(apps)], apps


PAPER = simulator.mech_grid(simulator.PAPER_MECHS, None)
CROSS = [MechConfig(mechanism="figcache_fast", cache_rows=r, seg_blocks=s,
                    insert_threshold=k)
         for r in (1, 64) for s in (8, 128) for k in (1, 4)] + \
    [MechConfig(mechanism="base")]


def _traced_sweep(cfgs, trs, apps):
    _profiler_on()
    try:
        return simulator.sweep_traces(trs, cfgs, apps, device=CPU)
    finally:
        _profiler_off()


def _spans(events):
    """``{id: (name, B record, E record)}`` in the order the spans opened."""
    out = {}
    for r in events:
        i = r["args"]["id"]
        if r["ph"] == "B":
            out[i] = [r["name"], r, None]
        else:
            assert r["ph"] == "E" and out[i][2] is None and \
                out[i][0] == r["name"]
            out[i][2] = r
    return out


def test_spans_lie_on_the_profilers_clock():
    a = torch.randn(128, 128)
    _profiler_on()
    try:
        brackets = []
        for _ in range(4):
            with trace.span("mm"):
                a @ a
            brackets.append(len(trace.PROGRAM.events))
    finally:
        result = _profiler_off()
    spans = _spans(trace.PROGRAM.events)
    mms = [ev for ev in result.events() if ev.name() == "aten::mm"]
    assert len(mms) == len(spans) == 4
    for (_, b, e), ev in zip(spans.values(), mms):
        start = ev.start_ns()
        assert b["ts"] <= start and start + ev.duration_ns() <= e["ts"]
    assert abs(b["ts"] - time.time_ns()) < 60e9     # Unix-epoch ns


def test_nothing_is_recorded_while_the_profiler_is_off():
    assert not trace.recording()
    trs, apps = _workloads()
    simulator.sweep_traces(trs, PAPER[:2], apps, device=CPU)
    assert len(trace.PROGRAM.events) == 0
    assert trace.span("x") is trace.span("y")       # one shared no-op
    trace.count(h2d_copies=1)
    assert len(trace.PROGRAM.events) == 0
    assert trace.PROGRAM.events.maxlen == trace.PROGRAM_MAXLEN == 1 << 20


@pytest.mark.parametrize("cfgs", [PAPER, CROSS], ids=["paper", "cross"])
def test_one_call_gives_one_job_tree(cfgs):
    trs, apps = _workloads()
    _traced_sweep(cfgs, trs, apps)
    spans = _spans(trace.PROGRAM.events)
    assert all(e is not None for _, _, e in spans.values())   # B has its E
    roots = [i for i, (_, b, _) in spans.items()
             if b["args"]["parent"] is None]
    assert len(roots) == 1 and spans[roots[0]][0] == "sweep"
    root = roots[0]
    assert all(b["args"]["job"] == root for _, b, _ in spans.values())
    children = {}
    for i, (name, b, _) in spans.items():
        children.setdefault(b["args"]["parent"], []).append(i)
    n_groups = len(simulator.static_groups(cfgs))
    top = [spans[i][0] for i in children[root]]
    assert top == ["sweep.stack"] + ["sweep.group"] * n_groups
    for g in children[root][1:]:
        assert [spans[i][0] for i in children[g]] == GROUP
        for i in children[g]:
            assert i not in children            # the innermost spans
    for i, (_, b, e) in spans.items():          # nested in time
        p = b["args"]["parent"]
        assert b["ts"] <= e["ts"]
        if p is not None:
            assert spans[p][1]["ts"] <= b["ts"] and e["ts"] <= spans[p][2]["ts"]


def _expected_copies(cfgs, trs):
    """The sweep path's copy sites: 15 scalars a config point
    (``MechConfig.params``), the two scalars of ``fts.init`` and the six
    trace leaves (``dram._lane_trace``) a static group."""
    W, (C, T) = len(trs), trs[0].t_issue.shape
    groups = simulator.static_groups(cfgs).values()
    copies = sum(15 * len(idxs) + 2 + 6 for idxs in groups)
    nbytes = sum(15 * 4 * len(idxs) + 2 * 4 + TRACE_BYTES * W * C * T
                 for idxs in groups)
    return copies, nbytes


@pytest.mark.parametrize("cfgs", [PAPER, CROSS], ids=["paper", "cross"])
def test_host_to_device_copies_are_counted_where_made(cfgs):
    trs, apps = _workloads()
    plain = simulator.sweep_traces(trs, cfgs, apps, device=CPU)
    traced = _traced_sweep(cfgs, trs, apps)
    got = {"h2d_copies": 0, "h2d_bytes": 0}
    where = set()
    for r in trace.PROGRAM.events:
        assert r["ph"] in "BE"                  # nothing outside a span
        for k in got:
            if k in r["args"]:
                got[k] += r["args"][k]
                where.add(r["name"])
    assert (got["h2d_copies"], got["h2d_bytes"]) == \
        _expected_copies(cfgs, trs)
    assert where == {"sweep.params", "replay.init", "replay.prepare"}
    for rw_plain, rw_traced in zip(plain, traced):    # bitwise equal
        for a, b in zip(rw_plain, rw_traced):
            for x, y in zip(a.counters, b.counters):
                np.testing.assert_array_equal(x, y)
            assert (a.ipc.tobytes(), a.exec_time_ns, a.energy_parts) == \
                (b.ipc.tobytes(), b.exec_time_ns, b.energy_parts)


def test_a_span_that_raises_is_closed_and_counts_without_a_span():
    _profiler_on()
    try:
        with pytest.raises(ValueError):
            with trace.span("outer"):
                trace.count(h2d_copies=2)
                trace.count(h2d_copies=1, h2d_bytes=4)
                raise ValueError("planted")
        trace.count(h2d_copies=3)
    finally:
        _profiler_off()
    b, e, c = trace.PROGRAM.events
    assert (b["ph"], e["ph"], c["ph"]) == ("B", "E", "C")
    assert e["args"] == {"id": b["args"]["id"], "h2d_copies": 3,
                         "h2d_bytes": 4, "raised": "ValueError"}
    assert c["name"] == "count" and c["args"] == {"h2d_copies": 3}
