"""The port's telemetry windows and ``obs/`` (``repro_torch.obs``) against
the JAX package's (``repro.obs``), on the same numpy-seeded traces.

``repro.core.streaming.simulate_stream`` / ``sweep_stream`` with a
``repro.obs.WindowCollector`` against the port's with its own collector:
every frame row (valid and filler), the final ``TelemetryState``,
``cumulative()`` and ``series()``, for the 6 mechanisms x 4 controllers of
``tests/test_obs.py`` at PERIOD 32 and the PERIOD 1 stress point for
``base`` and ``figcache_fast`` under ``fcfs`` and ``frfcfs+drain``; then
the ports of ``tests/test_obs.py``'s contracts (golden invisibility,
conservation, chunk invariance, guardrails, rendering, histogram mass, the
time-sum bracket under ``LAT_SUM_CAP``, bucket scheme, percentile oracle,
zero-request windows, all-no-op segments, the Chrome counter round trip),
the span log's byte-determinism and Chrome schema, and the three contracts
driven by the port's orchestrator (``repro_torch.launch.orchestrator`` on
the CPU): the faulted run's span log byte-identical across runs with its
manifest events, the killed run's open span and the resumed run's restore,
and the Chrome export of a real span log.

Tolerances: every integer leaf, frame row, histogram and count is compared
exactly; the derived float rates (``hit_rate``, ``avg_lat_ns``, ...) are
compared with ``np.array_equal(..., equal_nan=True)``, i.e. exactly too,
NaN for NaN.  The port runs on the CPU (the eager loop, the ``sim_scan``
kernel's plain version) on one torch thread.
"""
import dataclasses
import functools
import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import dram as jd
from repro.core import streaming as jst
from repro.core import timing as jt
from repro.core import traces as jtr
from repro.obs import latency as jlat
from repro.obs import telemetry as jtel
from repro.obs import trace as jtrace
from repro_torch.core import dram as pd
from repro_torch.core import streaming as pst
from repro_torch.core import timing as pt
from repro_torch.obs import latency, trace
from repro_torch.obs.telemetry import (WindowCollector, series_csv,
                                       window_table)

CPU = "cpu"
MECHS = ("base", "lldram", "lisa_villa", "figcache_slow", "figcache_fast",
         "figcache_ideal")
CACHED = ("lisa_villa", "figcache_slow", "figcache_fast", "figcache_ideal")
SCHEDS = {
    "fcfs": {},
    "frfcfs": dict(policy="frfcfs", queue_depth=8, starve_cap=4),
    "drain": dict(write_drain=True, drain_batch=4),
    "frfcfs+drain": dict(policy="frfcfs", queue_depth=8, starve_cap=4,
                         write_drain=True, drain_batch=4),
}
PERIOD = 32
SLO_NS = 40   # inside _reuse_trace's latency range: violations nonzero
# (acts_slow, acts_fast, reads, writes, reloc_blocks, wb_blocks, row_hits,
#  cache_hits, insertions, sum(lat_sum_ns), sum(req_cnt), t_end): GOLDEN of
# tests/test_obs.py, the telemetry-off fingerprints, per mechanism and
# controller (the rows of frfcfs equal fcfs's, frfcfs+drain's drain's)
_G = {
    ("base", "fcfs"): (320, 0, 256, 64, 0, 0, 0, 0, 0, 203846, 320, 28920),
    ("base", "drain"): (320, 0, 256, 64, 0, 0, 0, 0, 0, 204769, 320, 28968),
    ("lldram", "fcfs"): (0, 320, 256, 64, 0, 0, 0, 0, 0, 132798, 320, 19118),
    ("lldram", "drain"): (0, 320, 256, 64, 0, 0, 0, 0, 0, 133624, 320,
                          19188),
    ("lisa_villa", "fcfs"): (296, 24, 256, 64, 37888, 7552, 0, 24, 296,
                             257761, 320, 36264),
    ("lisa_villa", "drain"): (297, 23, 256, 64, 38016, 7552, 0, 23, 297,
                              257802, 320, 36262),
    ("figcache_slow", "fcfs"): (295, 0, 256, 64, 4320, 752, 25, 50, 270,
                                299156, 320, 42932),
    ("figcache_slow", "drain"): (291, 0, 256, 64, 4272, 768, 29, 53, 267,
                                 296726, 320, 42712),
    ("figcache_fast", "fcfs"): (270, 25, 256, 64, 4320, 752, 25, 50, 270,
                                291785, 320, 42012),
    ("figcache_fast", "drain"): (267, 24, 256, 64, 4272, 768, 29, 53, 267,
                                 290152, 320, 41884),
    ("figcache_ideal", "fcfs"): (270, 25, 256, 64, 4320, 752, 25, 50, 270,
                                 185359, 320, 26656),
    ("figcache_ideal", "drain"): (267, 24, 256, 64, 4272, 768, 29, 53, 267,
                                  184511, 320, 26528),
}
GOLDEN = {(m, s): _G[(m, "drain" if "drain" in s else "fcfs")]
          for m in MECHS for s in SCHEDS}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The eager loops run thousands of tiny ops; with several test workers
    on one host, torch's intra-op threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reuse_trace(n=320):
    """tests/test_obs.py:_reuse_trace() as numpy arrays."""
    idx = np.arange(n)
    return pd.Trace(t_issue=(idx * 16).astype(np.int32),
                    bank=(idx % 3).astype(np.int32),
                    row=((idx * 7) % 13).astype(np.int32),
                    col=((idx * 13) % 128).astype(np.int32),
                    is_write=idx % 5 == 0, core=(idx % 8).astype(np.int32))


def _jax(tr):
    return jd.Trace(*[jnp.asarray(np.asarray(x)) for x in tr])


def _cfgs(mech, sid="fcfs", period=PERIOD, slo_ns=SLO_NS, **kw):
    """(JAX config, port config) of one combo, telemetry on at ``period``
    (0: off)."""
    if mech in CACHED:
        kw.setdefault("cache_rows", 2)
    out = []
    for t in (jt, pt):
        cfg = t.paper_config(mech, sched=t.SchedConfig(**SCHEDS[sid]), **kw)
        out.append(dataclasses.replace(cfg, telemetry=period, slo_ns=slo_ns))
    return tuple(out)


def _stream_both(tr, mech, sid="fcfs", period=PERIOD, chunk=160):
    """The same stream through both packages, each with its collector:
    (port collector, port counters, JAX collector, JAX counters)."""
    jcfg, pcfg = _cfgs(mech, sid, period)
    pcol, jcol = WindowCollector(), jtel.WindowCollector()
    pcnt = pst.simulate_stream(pst.iter_chunks(tr, chunk), pcfg,
                               telemetry=pcol, device=CPU)
    jcnt = jst.simulate_stream(jst.iter_chunks(_jax(tr), chunk), jcfg,
                               telemetry=jcol)
    return pcol, pcnt, jcol, jcnt


@functools.lru_cache(maxsize=None)
def _combo(mech, sid, period=PERIOD):
    return _stream_both(_reuse_trace(), mech, sid, period)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _leaves(tree):
    out = []
    pd._map(out.append, tree)
    return out


def _assert_collectors_equal(pcol, jcol, index=(), ctx=""):
    """Every frame row (valid and filler rows alike), the final cursor,
    the series and the cumulative planes, bitwise."""
    assert pcol.n_segments == jcol.n_segments, ctx
    for i, (pf, jf) in enumerate(zip(pcol._chunks, jcol._chunks)):
        assert np.array_equal(_np(pf.valid), np.asarray(jf.valid)), (ctx, i)
        for f in pd.TelemetryWindows._fields:
            a, b = _np(getattr(pf.win, f)), np.asarray(getattr(jf.win, f))
            assert a.shape == b.shape and np.array_equal(a, b), (ctx, i, f)
    pl = _leaves(pcol._final)
    jl = jax.tree.leaves(jcol._final)
    assert len(pl) == len(jl) == 16, ctx
    for a, b in zip(pl, jl):
        assert np.array_equal(_np(a), np.asarray(b)), ctx
    ps, js = pcol.series(index), jcol.series(index)
    assert list(ps) == list(js), ctx
    for k in js:
        assert ps[k].dtype == js[k].dtype, (ctx, k)
        assert np.array_equal(ps[k], js[k], equal_nan=True), (ctx, k)
    for k, v in jcol.cumulative(index).items():
        assert np.array_equal(pcol.cumulative(index)[k], v), (ctx, k)


def _fingerprint(cnt):
    return tuple(int(_np(x).sum()) for x in cnt)


def _assert_counters_equal(ref, got, ctx):
    for f, a, b in zip(pd.Counters._fields, ref, got):
        assert np.array_equal(_np(a), _np(b)), (ctx, f)


# ---------------------------------------------------------------------------
# the port against the JAX package

@pytest.mark.parametrize("sid", list(SCHEDS))
@pytest.mark.parametrize("mech", MECHS)
def test_collected_telemetry_matches_jax(mech, sid):
    """PERIOD 32, two 160-request segments: frames, final cursor, series
    and cumulative planes bitwise equal to the JAX package's."""
    pcol, pcnt, jcol, jcnt = _combo(mech, sid)
    _assert_collectors_equal(pcol, jcol, ctx=(mech, sid))
    _assert_counters_equal(jcnt, pcnt, (mech, sid))


@pytest.mark.parametrize("sid", ["fcfs", "frfcfs+drain"])
@pytest.mark.parametrize("mech", ["base", "figcache_fast"])
def test_period1_matches_jax(mech, sid):
    """The stress point: every request closes a window (segment rings of
    T + 1 rows, 319 closed windows)."""
    pcol, _, jcol, _ = _combo(mech, sid, 1)
    _assert_collectors_equal(pcol, jcol, ctx=(mech, sid, 1))
    assert len(pcol.series()["win_idx"]) == 320


@pytest.mark.parametrize("sid", list(SCHEDS))
@pytest.mark.parametrize("mech", MECHS)
def test_telemetry_invisible_and_counters_identical(mech, sid):
    """Telemetry on leaves the counters at the telemetry-off golden
    fingerprint of tests/test_obs.py, and the collector saw 2 segments."""
    pcol, pcnt, _, _ = _combo(mech, sid)
    assert _fingerprint(pcnt) == GOLDEN[(mech, sid)], (mech, sid)
    assert pcol.n_segments == 2
    assert len(pcol.series()["win_idx"]) > 0


@pytest.mark.parametrize("sid", list(SCHEDS))
@pytest.mark.parametrize("mech", MECHS)
def test_hist_mass_reconciles_with_counters(mech, sid):
    """The read plane's mass is ``Counters.reads``, the write plane's
    ``writes``, the per-core mass ``req_cnt``; every window row's mass is
    its request count; the SLO count is conserved window by window."""
    pcol, cnt, _, _ = _combo(mech, sid)
    cum = pcol.cumulative()
    assert int(cum["hist"][0].sum()) == int(cnt.reads)
    assert int(cum["hist"][1].sum()) == int(cnt.writes)
    assert np.array_equal(cum["hist"].sum(axis=(0, 2)),
                          _np(cnt.req_cnt).astype(np.int64))
    s = pcol.series()
    assert np.array_equal(s["w_hist"].sum(axis=1), s["w_reqs"])
    assert int(s["w_slo"].sum()) == int(cum["slo"].sum()) > 0


def test_resume_tel_multi_channel_and_sweep_match_jax():
    """The segment entry points themselves: ``resume_tel`` over a (C, T)
    trace and ``sweep_resume_tel`` over (P,) params and (C, T), frame
    leaves (C, W, ...) and (P, C, W, ...), cursor and planes, bitwise."""
    apps = [jtr.app_params(n) for n in ("libquantum", "mcf")]
    tr = pd.Trace(*[np.asarray(x) for x in jtr.build_trace(apps, 2, 200, 4)])
    jcfgs, pcfgs = zip(*[_cfgs("figcache_fast", cache_rows=cr, period=16)
                         for cr in (2, 64)])
    jstatic, pstatic = jt.shared_static(jcfgs), pt.shared_static(pcfgs)
    jb = jax.tree.map(lambda *xs: jnp.stack(xs), *[c.params() for c in jcfgs])
    pb = pt.stack_params([c.params(device=CPU) for c in pcfgs])
    cases = [
        (jd.resume_tel(_jax(tr), jcfgs[0].static, jcfgs[0].params(),
                       jd.sim_init(jcfgs[0].static, channels=2)),
         pd.resume_tel(tr, pcfgs[0].static, pcfgs[0].params(device=CPU),
                       pd.sim_init(pcfgs[0].static, channels=2, device=CPU),
                       device=CPU), (2,)),
        (jd.sweep_resume_tel(_jax(tr), jstatic, jb,
                             jd.sim_init(jstatic, channels=2, batch=2)),
         pd.sweep_resume_tel(tr, pstatic, pb, pd.sim_init(
             pstatic, channels=2, batch=2, device=CPU), device=CPU),
         (2, 2))]
    for (jstate, jfr), (pstate, pfr), lead in cases:
        assert tuple(pfr.valid.shape[:-1]) == lead
        for a, b in zip(_leaves(pfr), jax.tree.leaves(jfr)):
            assert a.shape == b.shape and np.array_equal(_np(a), b), lead
        for a, b in zip(_leaves(pd._unlane(pstate.tel, lead)),
                        jax.tree.leaves(jstate.tel)):
            assert np.array_equal(_np(a), b), lead
        assert int(pfr.valid.sum()) > 0


# ---------------------------------------------------------------------------
# conservation and the window clock

@pytest.mark.parametrize("mech", ("base", "figcache_fast"))
def test_window_sums_match_counters(mech):
    tr = _reuse_trace()
    _, cfg = _cfgs(mech)
    col = WindowCollector()
    cnt = pst.simulate_stream(pst.iter_chunks(tr, 64), cfg, telemetry=col,
                              device=CPU)
    s = col.series()
    assert np.array_equal(s["win_idx"], np.arange(len(s["win_idx"])))
    assert int(s["w_reqs"].sum()) == int(cnt.reads) + int(cnt.writes)
    for lane, f in (("w_reads", "reads"), ("w_writes", "writes"),
                    ("w_row_hits", "row_hits"),
                    ("w_cache_hits", "cache_hits"), ("w_ins", "insertions"),
                    ("w_reloc_blocks", "reloc_blocks"),
                    ("w_lat_ns", "lat_sum_ns")):
        assert int(s[lane].sum()) == int(_np(getattr(cnt, f)).sum()), lane
    assert int(s["w_bank_issues"].sum()) == int(s["w_reqs"].sum())


def test_windows_index_real_requests_not_noops():
    """A ragged chunking (no-ops padding the last segment) yields the same
    series as the exact one."""
    tr = _reuse_trace()
    _, cfg = _cfgs("figcache_fast")
    exact, ragged = WindowCollector(), WindowCollector()
    pst.simulate_stream(pst.iter_chunks(tr, 160), cfg, telemetry=exact,
                        device=CPU)
    pst.simulate_stream(pst.iter_chunks(tr, 96), cfg, telemetry=ragged,
                        device=CPU)
    a, b = exact.series(), ragged.series()
    for k in a:
        assert np.array_equal(a[k], b[k], equal_nan=True), k


@pytest.mark.parametrize("period", (PERIOD, 1), ids=("period32", "period1"))
def test_series_chunk_invariance(period):
    """chunk in {1, 7, 64, full} == monolithic, byte for byte, and the
    final cursor and cumulative planes with them."""
    tr = _reuse_trace()
    _, cfg = _cfgs("figcache_fast", period=period)
    mono = WindowCollector()
    pst.simulate_stream(pst.iter_chunks(tr, 320), cfg, telemetry=mono,
                        device=CPU)
    assert mono.n_segments == 1
    ref = mono.series()
    assert len(ref["win_idx"]) == -(-320 // period)
    for L in (1, 7, 64):
        col = WindowCollector()
        pst.simulate_stream(pst.iter_chunks(tr, L), cfg, telemetry=col,
                            device=CPU)
        assert col.n_segments == -(-320 // L)
        got = col.series()
        for k in ref:
            assert np.array_equal(ref[k], got[k], equal_nan=True), (L, k)
        for a, b in zip(_leaves(mono._final), _leaves(col._final)):
            assert torch.equal(a, b), L


def test_series_chunk_invariance_multi_channel():
    """Two channels, streamed at 100 and monolithic, each channel's series
    equal, and equal to the JAX package's."""
    apps = tuple(jtr.app_params(n) for n in ("libquantum", "mcf"))
    tr = pd.Trace(*[np.asarray(x) for x in jtr.build_trace(list(apps), 2,
                                                          384, 4)])
    jcfg, cfg = _cfgs("figcache_fast")
    mono, col, jcol = WindowCollector(), WindowCollector(), \
        jtel.WindowCollector()
    pst.simulate_stream(pst.iter_chunks(tr, 384), cfg, telemetry=mono,
                        device=CPU)
    pst.simulate_stream(pst.iter_chunks(tr, 100), cfg, telemetry=col,
                        device=CPU)
    jst.simulate_stream(jst.iter_chunks(_jax(tr), 100), jcfg, telemetry=jcol)
    _assert_collectors_equal(col, jcol, (1,), "multi-channel")
    for c in range(2):
        a, b = mono.series(index=(c,)), col.series(index=(c,))
        for k in a:
            assert np.array_equal(a[k], b[k], equal_nan=True), (c, k)


def test_series_chunk_invariance_sweep():
    """The batched path: every grid point's series survives chunking and
    equals the JAX package's ``sweep_stream``."""
    tr = _reuse_trace()
    jcfgs, pcfgs = zip(*[_cfgs("figcache_fast", cache_rows=cr)
                         for cr in (2, 64)])
    static = pt.shared_static(pcfgs)
    pb = pt.stack_params([c.params(device=CPU) for c in pcfgs])
    jb = jax.tree.map(lambda *xs: jnp.stack(xs), *[c.params() for c in jcfgs])
    mono, col, jcol = WindowCollector(), WindowCollector(), \
        jtel.WindowCollector()
    pst.sweep_stream(pst.iter_chunks(tr, 320), static, pb, telemetry=mono,
                     device=CPU)
    pst.sweep_stream(pst.iter_chunks(tr, 64), static, pb, telemetry=col,
                     device=CPU)
    jst.sweep_stream(jst.iter_chunks(_jax(tr), 64), jt.shared_static(jcfgs),
                     jb, telemetry=jcol)
    for p in range(2):
        _assert_collectors_equal(col, jcol, (p,), ("sweep", p))
        a, b = mono.series(index=(p,)), col.series(index=(p,))
        for k in a:
            assert np.array_equal(a[k], b[k], equal_nan=True), (p, k)
    hits = [int(mono.series(index=(p,))["w_cache_hits"].sum())
            for p in range(2)]
    assert hits[1] >= hits[0]


# ---------------------------------------------------------------------------
# guardrails and rendering

def test_telemetry_guardrails():
    tr = _reuse_trace()
    _, cfg_tel = _cfgs("figcache_fast")
    _, cfg_off = _cfgs("figcache_fast", period=0)
    with pytest.raises(ValueError, match="telemetry"):
        pst.simulate_stream(pst.iter_chunks(tr, 160), cfg_off,
                            telemetry=WindowCollector(), device=CPU)
    with pytest.raises(ValueError, match="wavefront"):
        pst.simulate_stream(pst.iter_chunks(tr, 160), cfg_tel,
                            telemetry=WindowCollector(), wavefront_exec=True,
                            device=CPU)
    with pytest.raises(ValueError, match="dense"):
        pd.simulate(tr, cfg_tel.static, cfg_tel.params(device=CPU),
                    variant="dense", device=CPU)
    with pytest.raises(ValueError, match="telemetry"):
        pd.resume_tel(tr, cfg_off.static, cfg_off.params(device=CPU),
                      pd.sim_init(cfg_off.static, device=CPU), device=CPU)
    with pytest.raises(ValueError, match="telemetry"):
        pd.sweep_resume_tel(tr, cfg_off.static, cfg_off.params(device=CPU),
                            pd.sim_init(cfg_off.static, device=CPU),
                            device=CPU)
    with pytest.raises(ValueError, match=r"\(P,\)"):
        pd.sweep_resume_tel(tr, cfg_tel.static, cfg_tel.params(device=CPU),
                            pd.sim_init(cfg_tel.static, device=CPU),
                            device=CPU)
    # a telemetry replay needs the cursor that sim_init makes
    with pytest.raises(ValueError, match="SimState.tel"):
        pd.resume_tel(tr, cfg_tel.static, cfg_tel.params(device=CPU),
                      pd.sim_init(cfg_off.static, device=CPU), device=CPU)
    col = WindowCollector()
    with pytest.raises(ValueError, match="close"):
        col.cumulative()
    col.close(pd.sim_init(cfg_tel.static, device=CPU))
    with pytest.raises(ValueError, match="closed"):
        col.add(None)


def test_window_table_and_csv_render():
    pcol, _, jcol, _ = _combo("figcache_fast", "fcfs")
    s = pcol.series()
    tbl = window_table(s, max_rows=4)
    assert "hit%" in tbl and len(tbl.splitlines()) <= 6
    assert tbl == jtel.window_table(jcol.series(), max_rows=4)
    csv = series_csv(s)
    assert csv.splitlines()[0].startswith("win_idx")
    assert len(csv.splitlines()) == len(s["win_idx"]) + 1
    assert csv == jtel.series_csv(jcol.series())


# ---------------------------------------------------------------------------
# §16 latency histograms, percentiles, SLO accounting

def test_lat_sum_inside_hist_bracket():
    s = _combo("figcache_fast", "fcfs")[0].series()
    lo, hi = latency.bucket_bounds(pd.HIST_BUCKETS)
    lower = (s["w_hist"] * lo).sum(axis=1)
    upper = (s["w_hist"] * hi).sum(axis=1)
    assert np.all(np.minimum(lower, pd.LAT_SUM_CAP) <= s["w_lat_ns"])
    assert np.all(s["w_lat_ns"] <= np.minimum(upper, pd.LAT_SUM_CAP))


def test_lat_sum_saturation_keeps_hist_mass_exact():
    """The eager ``_telemetry_step`` driven into ``LAT_SUM_CAP`` saturation
    (20 requests of 2^26 ns): the time-sum lane clamps, histogram, count
    and SLO lanes stay exact, and the whole carry equals the JAX
    package's ``_telemetry_step`` driven the same way."""
    tel = pd._tel_open(pd.init_telemetry(device=CPU), 3, 1 << 20)
    j = jd.init_telemetry()
    jcur = jd._tel_pack(j.win)
    jscan = jd._TelScan(
        cur=jcur, hist=j.hist, slo=j.slo,
        buf_scalars=jnp.zeros((4,) + jcur.scalars.shape, jnp.int32),
        buf_banks=jnp.zeros((4,) + jcur.bank_issues.shape, jnp.int32),
        buf_hist=jnp.zeros((4,) + jcur.hist_win.shape, jnp.int32),
        n=jnp.int32(0))
    one = lambda v, dt=torch.int32: torch.tensor([v], dtype=dt)  # noqa
    lanes = torch.arange(1)
    steps, big = 20, 1 << 26
    for i in range(steps):
        tel = pd._telemetry_step(
            tel, 1 << 20, lanes=lanes, real=one(True, torch.bool),
            bank=one(0, torch.long), core=one(0, torch.long),
            is_write=one(False, torch.bool), row_hit=one(False, torch.bool),
            hit=one(False, torch.bool), n_ins=one(0), moved=one(0),
            lat_ns=one(big), bus_wait=one(0), mshr_wait=one(0),
            slo_ns=one(SLO_NS), step_id=one(i))
        t, f, z = jnp.bool_(True), jnp.bool_(False), jnp.int32(0)
        jscan = jd._telemetry_step(
            jscan, 1 << 20, real=t, bank=z, core=z, is_write=f, row_hit=f,
            hit=f, n_ins=z, moved=z, lat_ns=jnp.int32(big), bus_wait=z,
            mshr_wait=z, slo_ns=jnp.int32(SLO_NS), step_id=jnp.int32(i))
    cursor, _ = pd._tel_close(tel)
    win = pd._unlane(cursor, ()).win
    assert int(win.w_lat_ns) == pd.LAT_SUM_CAP
    assert int(win.w_reqs) == steps
    assert int(win.w_hist.sum()) == steps
    assert int(win.w_hist[pd.HIST_BUCKETS - 1]) == steps
    assert int(win.w_slo) == steps == int(tel.slo[0, 0])
    lo, hi = latency.bucket_bounds(pd.HIST_BUCKETS)
    lower = int((_np(win.w_hist) * lo).sum())
    upper = int((_np(win.w_hist) * hi).sum())
    assert min(lower, pd.LAT_SUM_CAP) <= int(win.w_lat_ns) \
        <= min(upper, pd.LAT_SUM_CAP)
    jwin = jd._tel_unpack(jscan.cur)
    for f in pd.TelemetryWindows._fields:
        assert np.array_equal(_np(getattr(win, f)),
                              np.asarray(getattr(jwin, f))), f
    assert np.array_equal(_np(tel.hist[0]), np.asarray(jscan.hist))
    assert np.array_equal(_np(tel.buf_scalars[0, :1]),
                          np.asarray(jscan.buf_scalars[:1]))


def test_bucket_scheme_host_device_agree():
    """``dram.hist_bucket`` (torch), ``obs.latency.bucket_index`` (numpy)
    and the JAX package's ``hist_bucket`` agree, ``lat_ns = 0`` and the
    int32 extremes included; the published bounds partition."""
    vals = np.array([0, 1, 2, 3, 4, 7, 8, 127, 128, (1 << 27) - 1, 1 << 27,
                     -5, np.iinfo(np.int32).max], np.int32)
    ref = np.asarray(jax.vmap(jd.hist_bucket)(jnp.asarray(vals)))
    assert np.array_equal(_np(pd.hist_bucket(torch.from_numpy(vals))), ref)
    assert np.array_equal(latency.bucket_index(vals), ref)
    lo, hi = latency.bucket_bounds(pd.HIST_BUCKETS)
    assert lo[0] == hi[0] == 0
    for b in range(1, pd.HIST_BUCKETS):
        assert int(latency.bucket_index(np.int64(lo[b]))) == b
        if b < pd.HIST_BUCKETS - 1:
            assert int(latency.bucket_index(np.int64(hi[b]))) == b
            assert lo[b + 1] == hi[b] + 1


def test_percentiles_vs_exact_sort_oracle():
    """PERIOD 1: every window is one request, so ``w_lat_ns`` is the exact
    latency series; each percentile's bracket holds the nearest-rank
    order statistic, and the SLO count is the oracle's."""
    pcol = _combo("figcache_fast", "fcfs", 1)[0]
    s = pcol.series()
    lats = np.sort(s["w_lat_ns"])
    n = len(lats)
    cum = pcol.cumulative()
    hist = cum["hist"].sum(axis=(0, 1))
    assert int(hist.sum()) == n == 320
    for q in latency.QS:
        p = latency.percentile(hist, q)
        k = min(max(int(np.ceil(q * n)), 1), n)
        oracle = int(lats[k - 1])
        assert p.lo <= oracle <= p.hi, (q, oracle, p)
        assert p.lo <= p.value <= p.hi, (q, p)
    assert int(cum["slo"].sum()) == int((s["w_lat_ns"] > SLO_NS).sum()) > 0


def test_latency_helpers_match_jax():
    """percentiles, core_tails, cdf_csv, tail_series and slo_summary of the
    same planes equal the JAX package's (floats exactly, NaN for NaN)."""
    pcol = _combo("figcache_fast", "frfcfs+drain")[0]
    cum, s = pcol.cumulative(), pcol.series()
    h = cum["hist"].sum(axis=(0, 1))
    assert latency.percentiles(h) == jlat.percentiles(h)
    assert latency.percentile(np.zeros(4, np.int64), 0.5)[2:] == (0, 0)
    for a, b in ((latency.core_tails(cum["hist"]),
                  jlat.core_tails(cum["hist"])),
                 (latency.tail_series(s), jlat.tail_series(s))):
        assert list(a) == list(b)
        for k in a:
            assert np.array_equal(a[k], b[k], equal_nan=True), k
    hists = {"rd": cum["hist"][0].sum(0), "wr": cum["hist"][1].sum(0)}
    assert latency.cdf_csv(hists) == jlat.cdf_csv(hists)
    assert latency.slo_summary(s, SLO_NS) == jlat.slo_summary(s, SLO_NS)


def test_zero_request_window_guard():
    """A hand-made all-zero window row degrades explicitly: count rates
    0.0, latency series NaN, no RuntimeWarning, the table renders."""
    zeros = lambda *sh: torch.zeros(sh, dtype=torch.int32)  # noqa
    win = pd.TelemetryWindows(
        **{f: zeros(1) for f in pd._TEL_SCALARS},
        w_bank_issues=zeros(1, pd.GEOM.n_banks),
        w_hist=zeros(1, pd.HIST_BUCKETS))
    col = WindowCollector()
    col.add(pd.TelemetryFrame(valid=torch.tensor([True]), win=win))
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        s = col.series()
    assert s["hit_rate"][0] == 0.0 and s["slo_rate"][0] == 0.0
    assert np.isnan(s["avg_lat_ns"][0])
    assert np.isnan(s["p50_ns"][0]) and np.isnan(s["p99_ns"][0])
    assert "nan" in window_table(s).lower()
    assert window_table(WindowCollector().series()) == \
        "(no closed telemetry windows)"


def test_all_noop_segment_is_telemetry_inert():
    """A whole no-op segment spliced into the stream leaves the series,
    the cumulative planes and the final cursor byte-identical."""
    tr = _reuse_trace()
    _, cfg = _cfgs("figcache_fast")
    ref, got = WindowCollector(), WindowCollector()
    pst.simulate_stream(pst.iter_chunks(tr, 160), cfg, telemetry=ref,
                        device=CPU)
    segs = list(pst.iter_chunks(tr, 160))
    empty = pd.Trace(*[np.zeros(0, bool if f == "is_write" else np.int32)
                       for f in pd.Trace._fields])
    segs.insert(1, pd.noop_pad(empty, 160))
    pst.simulate_stream(iter(segs), cfg, telemetry=got, device=CPU)
    a, b = ref.series(), got.series()
    assert set(a) == set(b)
    for k in a:
        assert np.array_equal(a[k], b[k], equal_nan=True), k
    assert np.array_equal(ref.cumulative()["hist"], got.cumulative()["hist"])
    for x, y in zip(_leaves(ref._final), _leaves(got._final)):
        assert torch.equal(x, y)
    assert not bool(got._chunks[1].valid.any())


# ---------------------------------------------------------------------------
# the span log and the Chrome export

def test_chrome_counter_roundtrip(tmp_path):
    """Counter events survive the JSONL -> Chrome round trip exactly,
    interleaved with spans, NaN samples dropped; the port's Chrome file is
    byte-identical to the JAX package's from the same series."""
    pcol, _, jcol, _ = _combo("figcache_fast", "fcfs")
    s = pcol.series()
    docs = []
    for mod, series, name in ((trace, s, "port"),
                              (jtrace, jcol.series(), "jax")):
        log = tmp_path / f"{name}.jsonl"
        tracer = mod.Tracer(str(log))
        with tracer.span("replay"):
            n = mod.counter_events(tracer, series, PERIOD)
        tracer.close()
        dst = tmp_path / f"{name}.chrome.json"
        assert mod.chrome_from_jsonl(str(log), str(dst)) == n + 2
        docs.append(dst.read_bytes())
    assert docs[0] == docs[1]
    evs = json.loads(docs[0])["traceEvents"]
    cs = [e for e in evs if e["ph"] == "C"]
    assert len(cs) == n > 0
    assert {e["name"] for e in cs} >= {"telemetry/hit_rate",
                                       "telemetry/latency_ns",
                                       "telemetry/slo"}
    assert all(v == v for e in cs for v in e["args"].values())
    first = next(e for e in cs if e["name"] == "telemetry/hit_rate")
    assert first["args"]["hit_rate"] == float(s["hit_rate"][0])
    assert first["ts"] == float(s["win_idx"][0]) * PERIOD
    assert evs[0]["ph"] == "B" and evs[-1]["ph"] == "E"
    assert trace.telemetry_counter_events(s, PERIOD) == \
        jtrace.telemetry_counter_events(jcol.series(), PERIOD)


def _scripted_log(mod, path):
    """Spans, events and counters on the default counter clock."""
    tr = mod.Tracer(str(path))
    tr.begin("run", grid="fig8")
    tr.event("retry", shard=3, attempt=1)
    with tr.span("shard", key="w0/base"):
        tr.counter("progress", done=1, left=2)
    tr.begin("checkpoint.save", chunk=4)
    tr.close()                 # dies inside run and checkpoint.save
    return path.read_bytes()


def test_tracer_byte_determinism(tmp_path):
    """Two runs of the same script give byte-identical logs, on the
    counter clock and on an injected clock, and the port's log is the JAX
    package's byte for byte."""
    a = _scripted_log(trace, tmp_path / "a.jsonl")
    assert a == _scripted_log(trace, tmp_path / "b.jsonl")
    assert a == _scripted_log(jtrace, tmp_path / "j.jsonl")
    recs = trace.read_jsonl(str(tmp_path / "a.jsonl"))
    assert [r["ts"] for r in recs] == [float(i) for i in
                                       range(1, len(recs) + 1)]
    clock = iter(np.arange(0.5, 100.0, 0.25))
    t = trace.Tracer(clock=lambda: float(next(clock)))
    t.event("x")
    t.counter("c", v=3)
    assert [e["ts"] for e in t.events] == [0.5, 0.75]
    assert t.events[1] == {"name": "c", "ph": "C", "ts": 0.75, "pid": 0,
                           "tid": 0, "args": {"v": 3.0}}


def test_chrome_schema_open_span(tmp_path):
    """A log that ends inside open spans exports to a balanced Chrome
    trace: required keys, known phases, instants thread-scoped, the open
    spans closed (inner first) at the last timestamp and flagged."""
    _scripted_log(trace, tmp_path / "s.jsonl")
    dst = tmp_path / "s.chrome.json"
    n = trace.chrome_from_jsonl(str(tmp_path / "s.jsonl"), str(dst))
    doc = json.loads(dst.read_text())
    evs = doc["traceEvents"]
    assert n == len(evs) and doc["displayTimeUnit"] == "ms"
    depth = 0
    for e in evs:
        assert {"name", "ph", "ts", "pid", "tid", "args"} <= set(e)
        assert e["ph"] in ("B", "E", "i", "C")
        if e["ph"] == "i":
            assert e["s"] == "t"
        depth += 1 if e["ph"] == "B" else -1 if e["ph"] == "E" else 0
        assert depth >= 0
    assert depth == 0
    synth = [e for e in evs if e["args"].get("synthetic_close")]
    assert [e["name"] for e in synth] == ["checkpoint.save", "run"]
    assert all(e["ts"] == max(x["ts"] for x in evs) for e in synth)
    assert trace.chrome_trace(trace.read_jsonl(str(tmp_path / "s.jsonl"))) \
        == jtrace.chrome_trace(jtrace.read_jsonl(str(tmp_path / "s.jsonl")))


# ------------------------------------------- orchestrator-driven contracts

def _traced_faulted_run(run_dir):
    """kill+resume, transient x3 (exp backoff), straggler re-issue: one
    orchestrated sweep on the CPU, spans appended to one JSONL log."""
    from repro_torch.launch import orchestrator as orch_mod
    from repro_torch.runtime.faults import (FaultEvent, FaultPlan,
                                            InjectedKill)
    run_dir.mkdir(parents=True, exist_ok=True)
    plan = orch_mod.ci_grid(chunk_len=128)
    fp = FaultPlan([
        FaultEvent(kind="transient", shard=0, times=3),
        FaultEvent(kind="kill", shard=1, segment=1, mode="raise"),
        FaultEvent(kind="slow", shard=4, segment=0, factor=8.0),
    ])
    log = run_dir / "span.jsonl"
    tracer = trace.Tracer(str(log), clock=fp.clock.now)
    kw = dict(fault_plan=fp, backoff_s=0.05, max_retries=3, tracer=tracer,
              devices=[CPU])
    o = orch_mod.Orchestrator(plan, str(run_dir), **kw)
    with pytest.raises(InjectedKill):
        o.run()
    o2 = orch_mod.Orchestrator(plan, str(run_dir), **kw)
    assert o2.run() == {"done": len(plan.shards)}
    tracer.close()
    return o2, fp, log, plan


def test_span_log_byte_identical_and_manifest_events(tmp_path):
    o, fp, log, plan = _traced_faulted_run(tmp_path / "a")
    _, _, log2, _ = _traced_faulted_run(tmp_path / "b")
    assert log.read_bytes() == log2.read_bytes()
    assert len(log.read_bytes()) > 0

    # the exponential backoff ran on the logical clock, never wall time
    assert fp.clock.slept[:3] == [0.05, 0.1, 0.2]

    events = trace.read_jsonl(str(log))
    names = {e["name"] for e in events}
    assert {"run", "shard", "checkpoint.save", "checkpoint.restore",
            "transient_retry", "straggler_reissue"} <= names
    # logical timestamps are monotone in emission order
    ts = [e["ts"] for e in events]
    assert all(a <= b for a, b in zip(ts, ts[1:]))
    # per-attempt shard spans carry worker + attempt + outcome
    shard_b = [e for e in events if e["name"] == "shard" and e["ph"] == "B"]
    assert all({"key", "worker", "attempt"} <= set(e["args"])
               for e in shard_b)
    retried = plan.shards[0].key
    assert sum(e["args"].get("key") == retried for e in shard_b) == 4

    # durable manifest diagnostics: the same attempts, without the tracer
    rec = o.manifest["shards"][retried]["events"]
    assert [r["kind"] for r in rec] == ["transient_retry"] * 3
    assert [r["attempt"] for r in rec] == [1, 2, 3]
    assert [r["backoff_s"] for r in rec] == [0.05, 0.1, 0.2]
    slow = o.manifest["shards"][plan.shards[4].key]["events"]
    assert any(r["kind"] == "straggler_reissue" and r["worker"] !=
               r["new_worker"] for r in slow)


def test_kill_leaves_open_span_resume_restores(tmp_path):
    """The killed run's log ends inside an open span (the death site);
    the resumed run records the checkpoint restore for the killed shard."""
    from repro_torch.launch import orchestrator as orch_mod
    from repro_torch.runtime.faults import (FaultEvent, FaultPlan,
                                            InjectedKill)
    plan = orch_mod.ci_grid(chunk_len=128)
    fp = FaultPlan([FaultEvent(kind="kill", shard=1, segment=1,
                               mode="raise")])
    log = tmp_path / "span.jsonl"
    tracer = trace.Tracer(str(log), clock=fp.clock.now)
    kw = dict(fault_plan=fp, backoff_s=0.0, tracer=tracer, devices=[CPU])
    o = orch_mod.Orchestrator(plan, str(tmp_path), **kw)
    with pytest.raises(InjectedKill):
        o.run()
    depth = sum(1 if e["ph"] == "B" else -1 if e["ph"] == "E" else 0
                for e in trace.read_jsonl(str(log)))
    assert depth > 0                       # died inside >= 1 open span
    o2 = orch_mod.Orchestrator(plan, str(tmp_path), **kw)
    assert o2.run() == {"done": len(plan.shards)}
    tracer.close()
    restores = [e for e in trace.read_jsonl(str(log))
                if e["name"] == "checkpoint.restore"]
    assert any(e["args"]["shard"] == plan.shards[1].key for e in restores)


def test_chrome_export_schema(tmp_path):
    _, _, log, _ = _traced_faulted_run(tmp_path / "run")
    dst = tmp_path / "span.chrome.json"
    n = trace.chrome_from_jsonl(str(log), str(dst))
    doc = json.loads(dst.read_text())
    evs = doc["traceEvents"]
    assert n == len(evs) and n > 0
    assert doc["displayTimeUnit"] == "ms"
    for e in evs:
        assert {"name", "ph", "ts", "pid", "tid"} <= set(e)
        assert e["ph"] in ("B", "E", "i")
        if e["ph"] == "i":
            assert e["s"] == "t"
    # B/E strictly balanced: the exporter synthesizes closes for spans
    # the process died inside, and flags them
    depth = 0
    for e in evs:
        depth += 1 if e["ph"] == "B" else -1 if e["ph"] == "E" else 0
        assert depth >= 0
    assert depth == 0
    # the killed run died inside run+shard spans: the exporter must have
    # synthesized (and flagged) their closes
    assert sum(bool(e.get("args", {}).get("synthetic_close"))
               for e in evs if e["ph"] == "E") >= 1


# ---------------------------------------------------------------- the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device to launch the sim_scan kernel")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("period", [1, PERIOD])
def test_cuda_telemetry_stream_matches_cpu(cuda_device, period):
    """On the card a telemetry stream is one sim_scan launch per segment
    (the telemetry instantiation), and its frames, cursor, series and
    planes equal the CPU route's (the eager loop) bitwise, single-channel
    and swept."""
    from repro_torch.kernels.sim_scan import sim_scan as scan
    tr = _reuse_trace()
    _, cfg = _cfgs("figcache_fast", "frfcfs+drain", period)
    want, got = WindowCollector(), WindowCollector()
    pst.simulate_stream(pst.iter_chunks(tr, 64), cfg, telemetry=want,
                        device=CPU)
    before = scan.COUNTER.launches
    pst.simulate_stream(pst.iter_chunks(tr, 64), cfg, telemetry=got,
                        device=cuda_device)
    got.block()
    assert scan.COUNTER.launches - before == got.n_segments == 5
    for a, b in zip(_leaves(got._chunks) + _leaves(got._final),
                    _leaves(want._chunks) + _leaves(want._final)):
        assert a.is_cuda and torch.equal(a.cpu(), b)
    pcfgs = [_cfgs("figcache_fast", period=period, cache_rows=cr)[1]
             for cr in (2, 64)]
    static = pt.shared_static(pcfgs)
    cols = []
    for dev in (CPU, cuda_device):
        cols.append(WindowCollector())
        pb = pt.stack_params([c.params(device=dev) for c in pcfgs])
        pst.sweep_stream(pst.iter_chunks(tr, 100), static, pb,
                         telemetry=cols[-1], device=dev)
    for p in range(2):
        a, b = cols[0].series((p,)), cols[1].series((p,))
        for k in a:
            assert np.array_equal(a[k], b[k], equal_nan=True), (p, k)


# ---------------------------------------------------------------------------
# obs.profile and ``python -m repro_torch.obs`` (the launch contracts of the
# telemetry paths; the report's sections against ``python -m repro.obs``)

def test_compile_contract_registered():
    """The telemetry sweep owns a declared launch budget: one replay per
    segment, 4 for the 256-request trace in chunks of 64."""
    from repro_torch.analysis import contracts
    assert "obs.telemetry-sweep" in contracts.REGISTRY
    got = {}
    assert contracts.check_contract("obs.telemetry-sweep", CPU, got) == []
    assert got["obs.telemetry-sweep"] == (4, 0)


def test_tail_latency_contract_registered():
    """The §16 tail-latency pipeline owns a declared launch budget: the
    SLO-threshold grid replays once per segment, percentiles on the
    host."""
    from repro_torch.analysis import contracts
    assert "obs.tail-latency" in contracts.REGISTRY
    got = {}
    assert contracts.check_contract("obs.tail-latency", CPU, got) == []
    assert got["obs.tail-latency"] == (4, 0)


@functools.lru_cache(maxsize=None)
def _obs_sections():
    """Both packages' report sections at a tiny size: 256 requests, chunk
    64, period 32, SLO 100 ns, 1 rep, 1 round."""
    from repro.obs import __main__ as jobs
    from repro_torch.obs import __main__ as pobs
    ptax, pmono, pcfgs = pobs.measure_tax(256, 64, 32, 1, rounds=1,
                                          slo_ns=100, device=CPU)
    jtax, jmono, jcfgs = jobs.measure_tax(256, 64, 32, 1, rounds=1,
                                          slo_ns=100)
    pm = pobs.phase_mix_series(256, 32, 64, 64, device=CPU)
    jm = jobs.phase_mix_series(256, 32, 64, 64)
    return (ptax, pmono, pcfgs, pm), (jtax, jmono, jcfgs, jm)


def test_obs_tax_section_matches_jax():
    (ptax, pmono, pcfgs, _), (jtax, jmono, jcfgs, _) = _obs_sections()
    assert list(ptax) == list(jtax)
    assert ptax["windows_bitwise_chunked_vs_monolithic"] is True
    assert jtax["windows_bitwise_chunked_vs_monolithic"] is True
    assert [c.cache_rows for c in pcfgs] == [c.cache_rows for c in jcfgs]
    for p in range(len(pcfgs)):
        a, b = pmono.series(index=(p,)), jmono.series(index=(p,))
        assert list(a) == list(b)
        for k in a:
            assert np.array_equal(a[k], b[k], equal_nan=True), (p, k)
        ca, cb = pmono.cumulative(index=(p,)), jmono.cumulative(index=(p,))
        for k in cb:
            assert np.array_equal(ca[k], cb[k]), (p, k)


def test_obs_tail_section_matches_jax(tmp_path):
    from repro.obs import __main__ as jobs
    from repro_torch.obs import __main__ as pobs
    (_, pmono, pcfgs, _), (_, jmono, jcfgs, _) = _obs_sections()
    (tmp_path / "p").mkdir(), (tmp_path / "j").mkdir()
    pt = pobs.tail_latency_section(pmono, pcfgs, 100, str(tmp_path / "p"))
    jt = jobs.tail_latency_section(jmono, jcfgs, 100, str(tmp_path / "j"))
    assert (tmp_path / "p" / "obs_latency_cdf.csv").read_text() == \
        (tmp_path / "j" / "obs_latency_cdf.csv").read_text()
    pt.pop("cdf_csv"), jt.pop("cdf_csv")
    assert pt == jt and len(pt["per_point"]) == 6


def test_obs_phase_mix_matches_jax():
    (*_, pm), (*_, jm) = _obs_sections()
    assert list(pm) == list(jm) and len(pm["win_idx"]) == 8
    for k in pm:
        assert np.array_equal(pm[k], jm[k], equal_nan=True), k


def test_count_dispatches_counts_outermost_calls():
    """Every segment of a stream is one ``dram.resume`` dispatch; a call
    made inside another entry point (``mesh_step`` -> ``shard_step`` ->
    ``dram.resume``) counts once, for the outermost."""
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import orchestrator
    from repro_torch.obs.profile import count_dispatches
    _, cfg = _cfgs("figcache_fast", period=0)
    tr = _reuse_trace()
    with count_dispatches() as n:
        pst.simulate_stream(pst.iter_chunks(tr, 80), cfg, device=CPU)
    assert {k: v for k, v in n.items() if v} == {"dram.resume": 4}
    mesh = mesh_lib.make_sweep_mesh(devices=[CPU], n_params=1,
                                    n_channels=1)
    prog = orchestrator.init_progress(cfg.static, 1, 1, device=CPU)
    seg = pd.Trace(*[np.asarray(x)[None, :16] for x in tr])
    with count_dispatches() as n:
        orchestrator.mesh_step(mesh, seg, cfg.static, pt.stack_params(
            [cfg.params(device=CPU)]), prog)
    assert {k: v for k, v in n.items() if v} == {"orchestrator.mesh_step": 1}
    assert pd.resume is not None and "shim" not in pd.resume.__name__


def test_profile_contracts_on_cpu():
    from repro_torch.obs.profile import profile_contracts
    rec = profile_contracts(["sweep.capacity", "obs.tail-latency"],
                            device=CPU)
    assert list(rec) == ["sweep.capacity", "obs.tail-latency"]
    cap, tail = rec["sweep.capacity"], rec["obs.tail-latency"]
    assert (cap["launches_cold"], cap["launches_warm"]) == (1, 1)
    assert (tail["launches_cold"], tail["launches_warm"]) == (4, 4)
    for r in rec.values():
        assert r["builds_cold"] == r["builds_warm"] == 0 == r["build_s"]
        assert r["sim_scan_launches_warm"] == 0
        assert r["warm_s"] > 0 and r["cold_extra_s"] >= 0
    assert cap["dispatches_warm"] == {"dram.run_sweep": 1}
    assert tail["dispatches_warm"] == {"dram.sweep_resume_tel": 4}


def test_obs_cli_runs_every_section(tmp_path, monkeypatch, capsys):
    """``python -m repro_torch.obs --device cpu`` end to end, its sections
    shrunk to the tiny size: the record has the JAX record's keys (plus
    ``device``) and the pin holds."""
    from repro_torch.obs import __main__ as pobs
    tax, pm = pobs.measure_tax, pobs.phase_mix_series
    monkeypatch.setattr(pobs, "measure_tax", lambda n, c, per, reps, rounds,
                        slo_ns, device: tax(256, 64, per, 1, 1, slo_ns,
                                            device))
    monkeypatch.setattr(pobs, "phase_mix_series", lambda n, per, c, pl,
                        device: pm(256, per, 64, 64, device))
    out = tmp_path / "BENCH_obs.json"
    rc = pobs.main(["--quick", "--device", "cpu", "--json", str(out),
                    "--outdir", str(tmp_path), "--period", "32"])
    rec = json.loads(out.read_text())
    text = capsys.readouterr().out
    assert rec["windows_bitwise_chunked_vs_monolithic"] is True
    assert rc == (0 if rec["telemetry_tax"] <= pobs.TAX_TRIPWIRE else 1)
    assert rec["device"] == "cpu" and set(rec["profile"]) == set(
        pobs._QUICK_PROFILE)
    assert {"bench", "quick", "telemetry_tax", "telemetry_tax_rounds",
            "tail_latency", "phase_mix", "profile"} <= set(rec)
    assert (tmp_path / "obs_phase_mix.csv").exists()
    assert "[obs] profiling quick subset" in text
