"""The port's config split (``core/timing.py``) and numpy trace model
(``core/traces.py``) against the JAX package: equal knobs, equal static
structures, bitwise-equal traces."""
import dataclasses
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import timing as jt
from repro.core import traces as jtr
from repro_torch.core import timing as pt
from repro_torch.core import traces as ptr

MECHS = ("base", "lisa_villa", "figcache_slow", "figcache_fast",
         "figcache_ideal", "lldram")
POLICIES = ("row_benefit", "segment_benefit", "lru", "random")
CAPACITY = ({}, {"cache_rows": 2}, {"cache_rows": 16, "seg_blocks": 8},
            {"cache_rows": 128, "seg_blocks": 32}, {"insert_threshold": 3,
                                                   "benefit_bits": 3})


def _pair(mech, **kw):
    return jt.paper_config(mech, **kw), pt.paper_config(mech, **kw)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("mech", MECHS)
def test_params_and_statics_equal(mech, policy):
    for kw in CAPACITY:
        j, p = _pair(mech, policy=policy, **kw)
        jp, pp = j.params(), p.params(device="cpu")
        assert jt.MechParams._fields == pt.MechParams._fields
        for f in pt.MechParams._fields:
            x, y = np.asarray(getattr(jp, f)), getattr(pp, f)
            assert y.dtype == torch.int32 and y.dim() == 0, f
            assert int(x) == int(y), (mech, policy, kw, f)
        for attr in ("static", "exact_static"):
            assert dataclasses.asdict(getattr(j, attr)) == \
                dataclasses.asdict(getattr(p, attr)), (mech, policy, kw)
        assert jt.static_group_key(j) == pt.static_group_key(p)


@pytest.mark.parametrize("mech", MECHS)
def test_shared_static_equal_over_capacity_grid(mech):
    grid = [dict(cache_rows=cr, seg_blocks=sb)
            for cr, sb in itertools.product((2, 64, 128), (8, 16, 32))]
    js = jt.shared_static([jt.paper_config(mech, **kw) for kw in grid])
    ps = pt.shared_static([pt.paper_config(mech, **kw) for kw in grid])
    assert dataclasses.asdict(js) == dataclasses.asdict(ps)


def test_stacked_params_and_timings():
    cfgs = [pt.paper_config("figcache_fast", cache_rows=cr)
            for cr in (2, 4, 8)]
    stacked = pt.stack_params([c.params(device="cpu") for c in cfgs])
    assert stacked.n_slots.tolist() == [16, 32, 64]
    assert stacked.rcd.dtype == torch.int32
    t = pt.DRAMTimings()
    for name in ("rcd", "rp", "ras", "cas", "bl", "ccd", "reloc", "rcd_fast",
                 "rp_fast", "ras_fast", "lisa_hop"):
        assert getattr(t, name) == getattr(jt.DDR4, name), name
    assert t.full_reloc_ns() == jt.DDR4.full_reloc_ns()
    assert dataclasses.asdict(pt.GEOM) == dataclasses.asdict(jt.GEOM)


def test_sched_config_mirrors_reference():
    assert pt.SCHED_FCFS.is_identity and jt.SCHED_FCFS.is_identity
    drain = pt.SchedConfig(write_drain=True)
    assert not drain.is_identity
    assert dataclasses.asdict(drain) == \
        dataclasses.asdict(jt.SchedConfig(write_drain=True))
    with pytest.raises(ValueError):
        pt.SchedConfig(policy="lifo")


def test_eight_core_workloads_equal():
    jw, pw = jtr.eight_core_workloads(), ptr.eight_core_workloads()
    assert len(jw) == len(pw) == 20
    for (jn, jf, ja), (pn, pf, pa) in zip(jw, pw):
        assert (jn, jf) == (pn, pf)
        assert [dataclasses.asdict(a) for a in ja] == \
            [dataclasses.asdict(a) for a in pa]


@pytest.mark.parametrize("wl,per_channel,seed", [(17, 512, 2), (0, 300, 5)])
def test_build_trace_bitwise(wl, per_channel, seed):
    japps = jtr.eight_core_workloads()[wl][2]
    papps = ptr.eight_core_workloads()[wl][2]
    jtrace = jtr.build_trace(japps, 4, per_channel, seed)
    ptrace = ptr.build_trace(papps, 4, per_channel, seed)
    assert jtrace._fields == ptrace._fields
    for f, x, y in zip(ptrace._fields, jtrace, ptrace):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape == (4, per_channel)
        assert np.array_equal(x, y), f


def test_single_core_trace_bitwise():
    a = "libquantum"
    jtrace = jtr.build_trace([jtr.app_params(a)], 1, 1024, 1)
    ptrace = ptr.build_trace([ptr.app_params(a)], 1, 1024, 1)
    for f, x, y in zip(ptrace._fields, jtrace, ptrace):
        assert np.array_equal(np.asarray(x), np.asarray(y)), f
