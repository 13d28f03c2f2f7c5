"""The port's fused simulator step (``repro_torch.core.dram``) against the
JAX package on the CPU.  The simulator is exact int32 arithmetic, so every
``Counters`` field must be bitwise equal."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import dram as jd
from repro.core import timing as jt
from repro.core import traces as jtr
from repro_torch import convert
from repro_torch.core import dram as pd
from repro_torch.core import timing as pt

CPU = "cpu"
CACHED = ("lisa_villa", "figcache_slow", "figcache_fast", "figcache_ideal")
POLICIES = ("row_benefit", "segment_benefit", "lru", "random")


def _matrix():
    """tests/test_hotloop.py's 18 cells: six mechanisms x four policies,
    one policy for the cache-less mechanisms."""
    return [(m, "row_benefit") for m in ("base", "lldram")] + \
        [(m, p) for m in CACHED for p in POLICIES]


def _np_trace(bank_mod, row_mod, n=320):
    idx = np.arange(n)
    return dict(t_issue=(idx * 16).astype(np.int32),
                bank=(idx % bank_mod).astype(np.int32),
                row=((idx * 7) % row_mod).astype(np.int32),
                col=((idx * 13) % 128).astype(np.int32),
                is_write=idx % 5 == 0, core=(idx % 8).astype(np.int32))


def _pressure():
    """tests/test_hotloop.py:_pressure_trace(320) as numpy arrays."""
    return _np_trace(4, 97)


def _reuse():
    """tests/test_obs.py:_reuse_trace() (320 requests) as numpy arrays."""
    return _np_trace(3, 13)


def _jax_trace(d):
    return jd.Trace(**{k: jnp.asarray(v) for k, v in d.items()})


def _cfgs(mech, cache_rows=2, **kw):
    if mech in CACHED:
        kw["cache_rows"] = cache_rows
    return jt.paper_config(mech, **kw), pt.paper_config(mech, **kw)


def _np_counters(cnt):
    if isinstance(cnt, pd.Counters):
        return convert.counters_to_numpy(cnt)
    return {f: np.asarray(x) for f, x in zip(cnt._fields, cnt)}


def _assert_equal(ref, got, ctx):
    ref, got = _np_counters(ref), _np_counters(got)
    assert list(ref) == list(got)
    for f in ref:
        assert ref[f].shape == got[f].shape, (ctx, f)
        assert np.array_equal(ref[f], got[f]), (ctx, f, ref[f], got[f])


@functools.lru_cache(maxsize=None)
def _port_run(mech, policy, fts_kernel=False, exact=False):
    _, cfg = _cfgs(mech, policy=policy, fts_kernel=fts_kernel)
    run = pd.run_channel_exact if exact else pd.run_channel
    return run(pd.Trace(**_pressure()), cfg, device=CPU)


@pytest.mark.parametrize("mech,policy", _matrix())
def test_run_channel_bitwise_vs_jax(mech, policy):
    jcfg, _ = _cfgs(mech, policy=policy)
    ref = jd.run_channel(_jax_trace(_pressure()), jcfg)
    got = _port_run(mech, policy)
    assert got.reads.dtype == torch.int32 and got.reads.dim() == 0
    _assert_equal(ref, got, (mech, policy))


@pytest.mark.parametrize("mech,policy", _matrix())
def test_fts_kernel_path_and_exact_static_match(mech, policy):
    """``fts_kernel=True`` (the plain version of the kernel on the CPU)
    equals ``False``, and the unpadded ``run_channel_exact`` equals the
    padded run, bitwise."""
    plain = _port_run(mech, policy)
    _assert_equal(plain, _port_run(mech, policy, fts_kernel=True),
                  (mech, policy, "fts_kernel"))
    _assert_equal(plain, _port_run(mech, policy, exact=True),
                  (mech, policy, "exact"))


def test_noop_pad_is_inert():
    _, cfg = _cfgs("figcache_fast")
    tr = pd.Trace(**_pressure())
    padded = pd.noop_pad(tr, 512)
    assert padded.t_issue.shape == (512,)
    assert padded.t_issue[-1] == pd.NOOP_ISSUE
    _assert_equal(pd.run_channel(tr, cfg, device=CPU),
                  pd.run_channel(padded, cfg, device=CPU), "noop-pad")
    tt = pd.noop_pad(pd.Trace(**{k: torch.from_numpy(v)
                                 for k, v in _pressure().items()}), 400)
    assert isinstance(tt.bank, torch.Tensor) and tt.bank.shape == (400,)


# (acts_slow, acts_fast, reads, writes, reloc_blocks, wb_blocks, row_hits,
#  cache_hits, insertions, sum(lat_sum_ns), sum(req_cnt), t_end): the FCFS
# column of tests/test_obs.py:108-153 (GOLDEN), cache_rows=2 for the cached
# mechanisms, on tests/test_obs.py:_reuse_trace().
GOLDEN_FCFS = {
    "base": (320, 0, 256, 64, 0, 0, 0, 0, 0, 203846, 320, 28920),
    "lldram": (0, 320, 256, 64, 0, 0, 0, 0, 0, 132798, 320, 19118),
    "lisa_villa": (296, 24, 256, 64, 37888, 7552, 0, 24, 296, 257761, 320,
                   36264),
    "figcache_slow": (295, 0, 256, 64, 4320, 752, 25, 50, 270, 299156, 320,
                      42932),
    "figcache_fast": (270, 25, 256, 64, 4320, 752, 25, 50, 270, 291785, 320,
                      42012),
    "figcache_ideal": (270, 25, 256, 64, 4320, 752, 25, 50, 270, 185359,
                       320, 26656),
}


def fingerprint(cnt):
    return tuple(int(x.sum()) for x in cnt)


@pytest.mark.parametrize("fts_kernel", [False, True])
@pytest.mark.parametrize("mech", list(GOLDEN_FCFS))
def test_golden_fcfs_pins(mech, fts_kernel):
    _, cfg = _cfgs(mech, fts_kernel=fts_kernel)
    cnt = pd.run_channel(pd.Trace(**_reuse()), cfg, device=CPU)
    assert fingerprint(cnt) == GOLDEN_FCFS[mech]


def test_run_sweep_capacity_grid_bitwise_vs_jax():
    """P = 3 capacity/segment grid on a 2-channel build_trace: one port
    replay over 6 lanes equals the JAX package's vmapped run_sweep."""
    apps = [jtr.app_params(n) for n in ("libquantum", "mcf", "gcc")]
    jtrace = jtr.build_trace(apps, 2, 384, 4)
    grid = [dict(cache_rows=2), dict(cache_rows=4, seg_blocks=8),
            dict(cache_rows=16)]
    jcfgs = [jt.paper_config("figcache_fast", **kw) for kw in grid]
    pcfgs = [pt.paper_config("figcache_fast", **kw) for kw in grid]
    jstatic, pstatic = jt.shared_static(jcfgs), pt.shared_static(pcfgs)
    jbatch = jax.tree.map(lambda *xs: jnp.stack(xs),
                          *[c.params() for c in jcfgs])
    ref = jd.run_sweep(jax.tree.map(jnp.asarray, jtrace), jstatic, jbatch)
    pbatch = pt.stack_params([c.params(device=CPU) for c in pcfgs])
    got = pd.run_sweep(pd.Trace(*[np.asarray(x) for x in jtrace]), pstatic,
                       pbatch, device=CPU)
    assert got.lat_sum_ns.shape == (3, 2, 8)
    _assert_equal(ref, got, "run_sweep")


@pytest.mark.parametrize("mech,policy", [("figcache_fast", "row_benefit"),
                                         ("lisa_villa", "lru"),
                                         ("figcache_slow", "random")])
def test_state_carried_from_jax_into_port(mech, policy):
    """JAX ``dram.resume`` over the first 160 requests, then the port over
    the rest from the converted state, equals JAX over all 320."""
    jcfg, pcfg = _cfgs(mech, policy=policy)
    trace = _pressure()
    head = {k: v[:160] for k, v in trace.items()}
    tail = {k: v[160:] for k, v in trace.items()}
    jstate = jd.resume(_jax_trace(head), jcfg.static, jcfg.params(),
                       jd.sim_init(jcfg.static))
    state = convert.sim_state_from_numpy(
        [np.asarray(x) for x in jax.tree.leaves(jstate.bank)],
        [np.asarray(x) for x in jax.tree.leaves(jstate.cnt)], device=CPU)
    assert state.bank.fts.tags.shape == (1, 16, pcfg.static.max_slots)
    params = convert.mech_params_from_numpy(
        {k: np.asarray(v) for k, v in jcfg.params()._asdict().items()},
        device=CPU)
    final = pd.resume(pd.Trace(**tail), pcfg.static, params, state,
                      device=CPU)
    got = pd.Counters(*[x[0] for x in pd.finalize(final)])
    ref = jd.run_channel(_jax_trace(trace), jcfg)
    _assert_equal(ref, got, (mech, policy))
    # resume leaves its input untouched: replaying the tail again agrees
    again = pd.finalize(pd.resume(pd.Trace(**tail), pcfg.static, params,
                                  state, device=CPU))
    _assert_equal(pd.finalize(final), again, "resume-is-pure")


def test_unported_paths_raise():
    """Every body is ported: a telemetry config runs (its counters equal
    the JAX package's and the telemetry-off run's) and so does the dense
    body.  What still raises is what the JAX package refuses too: the
    dense body with telemetry, and an unknown variant."""
    jcfg, cfg = _cfgs("figcache_fast", telemetry=8)
    trace = pd.Trace(**_pressure())
    got = pd.run_channel(trace, cfg, device=CPU)
    _assert_equal(jd.run_channel(_jax_trace(_pressure()), jcfg), got, "jax")
    _assert_equal(pd.run_channel(trace, _cfgs("figcache_fast")[1],
                                 device=CPU), got, "telemetry off")
    assert callable(pd.make_step(pt.paper_config("base").static,
                                 variant="dense"))
    with pytest.raises(ValueError, match="dense"):
        pd.make_step(cfg.static, variant="dense")
    with pytest.raises(ValueError, match="variant"):
        pd.make_step(pt.paper_config("base").static, variant="wave")


@functools.lru_cache(maxsize=None)
def _dense_run(mech, policy):
    _, cfg = _cfgs(mech, policy=policy)
    return pd.simulate(pd.Trace(**_pressure()), cfg.static,
                       cfg.params(device=CPU), variant="dense", device=CPU)


@pytest.mark.parametrize("mech,policy", _matrix())
def test_dense_equals_fused_and_jax_dense(mech, policy):
    """tests/test_hotloop.py:174's bar in the port: the dense body's
    counters equal the fused body's and the JAX package's dense body's
    (``dram._simulate_jit(..., variant="dense")``), bit for bit."""
    jcfg, _ = _cfgs(mech, policy=policy)
    ref = jd._simulate_jit(_jax_trace(_pressure()), jcfg.static,
                           jcfg.params(), variant="dense")
    got = _dense_run(mech, policy)
    _assert_equal(ref, got, (mech, policy, "jax dense"))
    _assert_equal(_port_run(mech, policy), got, (mech, policy, "fused"))


def test_dense_logs_eager_replays():
    """Each replay is counted in ``REPLAYS`` with its tag; the dense body
    is always an eager replay, as is every CPU replay."""
    _, cfg = _cfgs("figcache_fast")
    tr = pd.Trace(**{k: v[:16] for k, v in _pressure().items()})
    n0 = pd.replay_count()
    pd.simulate(tr, cfg.static, cfg.params(device=CPU), variant="dense",
                device=CPU)
    pd.run_channel(tr, cfg, device=CPU)
    assert pd.replay_count() - n0 == 2
    assert list(pd.REPLAYS.last)[-2:] == [
        "eager/dense/figcache_fast/row_benefit/16x1",
        "eager/fused/figcache_fast/row_benefit/16x1"]
