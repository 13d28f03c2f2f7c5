"""The port's bank-wavefront route (``repro_torch.core.sched.wavefront``)
against the JAX package: the host compile pass (``form_waves``,
``linearize_waves``, ``pad_waves``, ``wave_stats``) leaf for leaf, and the
eager wave step's counters against the JAX wave scan and against the
port's serial loop on the linearized trace, for six mechanisms x four
replacement policies under the four controllers, multi-channel, ragged
no-op and params-batched cases.  ``cuda`` cases hold the card route (the
linearized waves through one ``sim_scan`` launch) against the eager wave
step on the card."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import dram as jd
from repro.core import sched as jsched
from repro.core.sched import wavefront as jwave
from repro.core.timing import paper_config as jconfig
from repro_torch.core import dram as pd
from repro_torch.core import timing as pt
from repro_torch.core import traces as ptr
from repro_torch.core.sched import policies as ppol
from repro_torch.core.sched import wavefront as pwave
from repro_torch.core.timing import GEOM, SchedConfig, paper_config
from repro_torch.kernels.sim_scan import sim_scan as scan

CPU = "cpu"
POLICIES = ("row_benefit", "segment_benefit", "lru", "random")
CACHED = ("lisa_villa", "figcache_slow", "figcache_fast", "figcache_ideal")
MATRIX = [(m, "row_benefit") for m in ("base", "lldram")] + \
    [(m, p) for m in CACHED for p in POLICIES]
SCHEDS = {
    "fcfs": {},
    "frfcfs": dict(policy="frfcfs", queue_depth=8, starve_cap=4),
    "drain": dict(write_drain=True, drain_batch=4),
    "frfcfs+drain": dict(policy="frfcfs", queue_depth=8, starve_cap=4,
                         write_drain=True, drain_batch=4),
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The eager loops run thousands of tiny ops; with several test workers
    on one host, torch's intra-op threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pressure_trace(n=320):
    """tests/test_sched.py's hammer: a tiny cache under constant
    insert/evict pressure, five banks, eight cores."""
    idx = np.arange(n)
    return pd.Trace(t_issue=(idx * 16).astype(np.int32),
                    bank=(idx % 5).astype(np.int32),
                    row=((idx * 7) % 97).astype(np.int32),
                    col=((idx * 13) % 128).astype(np.int32),
                    is_write=idx % 5 == 0, core=(idx % 8).astype(np.int32))


def _random_trace(seed, n=200, gap=60):
    rng = np.random.default_rng(seed)
    return pd.Trace(
        t_issue=np.cumsum(rng.integers(0, gap, n)).astype(np.int32),
        bank=rng.integers(0, GEOM.n_banks, n).astype(np.int32),
        row=rng.integers(0, 50, n).astype(np.int32),
        col=rng.integers(0, 128, n).astype(np.int32),
        is_write=rng.random(n) < 0.3,
        core=rng.integers(0, GEOM.n_cores, n).astype(np.int32))


def _jax(tr):
    return jd.Trace(*[np.asarray(x) for x in tr])


def _cfg(mech, policy="row_benefit", config=paper_config, **kw):
    if mech in CACHED:
        kw.setdefault("cache_rows", 2)
    return config(mech, policy=policy, **kw)


def _assert_traces_equal(ref, got, ctx):
    for f in pd.Trace._fields:
        a, b = np.asarray(getattr(ref, f)), np.asarray(getattr(got, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), (ctx, f)


def _assert_counters_equal(ref, got, ctx):
    for name, a, b in zip(pd.Counters._fields, ref, got):
        a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        assert np.array_equal(a, b.cpu().numpy()), (ctx, name)


# ------------------------------------------------------ the compile pass

@pytest.mark.parametrize("width", [1, 8, 16])
@pytest.mark.parametrize("lookahead", [0, 32])
def test_form_waves_matches_jax(width, lookahead):
    """form_waves, linearize_waves, pad_waves and wave_stats on one
    channel, on (C, T) channels of unequal real length (all-no-op filler
    waves) and on a trace with interior no-ops: every leaf equal."""
    one = _random_trace(width * 7 + lookahead)
    ragged = pd.Trace(*[np.stack(xs) for xs in zip(
        pd.noop_pad(_random_trace(1, n=150), 200), _random_trace(2),
        pd.noop_pad(_random_trace(3, n=40), 200))])
    holes = _pressure_trace()._replace(t_issue=np.where(
        np.arange(320) % 9 == 4, pd.NOOP_ISSUE,
        _pressure_trace().t_issue).astype(np.int32))
    for name, tr in (("one", one), ("ragged", ragged), ("holes", holes)):
        got = pwave.form_waves(tr, width=width, lookahead=lookahead)
        ref = jwave.form_waves(_jax(tr), width=width, lookahead=lookahead)
        _assert_traces_equal(ref, got, (name, "form"))
        _assert_traces_equal(jwave.linearize_waves(ref),
                             pwave.linearize_waves(got), (name, "linear"))
        n = got.t_issue.shape[-2]
        _assert_traces_equal(jwave.pad_waves(ref, n + 3),
                             pwave.pad_waves(got, n + 3), (name, "pad"))
        assert pwave.wave_stats(got) == jwave.wave_stats(ref)
        assert pwave.pad_waves(got, n) is got


def test_wave_formation_invariants():
    """Distinct banks in every wave (pads included), at most N_MSHR
    same-core lanes, per-bank FIFO order, and the identity linearization
    at lookahead 0."""
    tr = _random_trace(5)
    for width, lookahead in ((16, 0), (5, 48), (3, 7)):
        wtr = pwave.form_waves(tr, width=width, lookahead=lookahead)
        real = wtr.t_issue < pd.NOOP_ISSUE
        for w in range(wtr.t_issue.shape[0]):
            assert len(set(wtr.bank[w].tolist())) == width
            _, k = np.unique(wtr.core[w][real[w]], return_counts=True)
            assert (k <= pd.N_MSHR).all()
        lin = pwave.linearize_waves(wtr)
        for b in range(GEOM.n_banks):
            assert np.array_equal(tr.t_issue[tr.bank == b],
                                  lin.t_issue[lin.bank == b])
        if lookahead == 0:
            assert np.array_equal(lin.t_issue, tr.t_issue)


# -------------------------------------------------------- the eager step

@pytest.mark.parametrize("mech,policy", MATRIX)
def test_wave_step_matches_jax_and_serial(mech, policy):
    """The 18 mechanism x policy cells on the pressure trace: the eager
    wave step equals the JAX package's wave scan and the port's serial
    loop, bit for bit."""
    tr = _pressure_trace()
    got = pwave.run_channel_waves(tr, _cfg(mech, policy), device=CPU)
    ref = jsched.run_channel_waves(_jax(tr), _cfg(mech, policy, jconfig))
    _assert_counters_equal(ref, got, (mech, policy))
    _assert_counters_equal(pd.run_channel(tr, _cfg(mech, policy),
                                          device=CPU), got, "serial")


@pytest.mark.parametrize("sid", list(SCHEDS))
def test_wave_step_under_every_controller(sid):
    """Scheduled traces (non-monotone issue times) through waves formed
    with and without lookahead: the eager wave step equals the serial
    loop on the linearized order, and JAX's wave scan."""
    sc = SchedConfig(**SCHEDS[sid])
    tr = ppol.schedule(_random_trace(11, n=240, gap=30), sc)
    cfg = _cfg("figcache_fast", "segment_benefit")
    for lookahead in (0, 16):
        wtr = pwave.form_waves(tr, lookahead=lookahead)
        got = pwave.simulate_waves(wtr, cfg.static, cfg.params(device=CPU),
                                   device=CPU)
        serial = pd.run_channel(pwave.linearize_waves(wtr), cfg, device=CPU)
        _assert_counters_equal(serial, got, (sid, lookahead))
        jcfg = _cfg("figcache_fast", "segment_benefit", jconfig)
        ref = jwave._simulate_waves_jit(_jax(wtr), jcfg.static,
                                        jcfg.params())
        _assert_counters_equal(ref, got, (sid, lookahead, "jax"))


def test_wave_step_multi_channel_and_ragged_noops():
    """(C, T) traces with ragged no-op tails and interior no-ops, at widths
    1, 8 and 16: equal to the serial loop and to JAX."""
    apps = [ptr.app_params(n) for n in ("libquantum", "mcf", "gcc")]
    tr = ptr.build_trace(apps, 3, 384, 4)
    t = tr.t_issue.copy()
    t[1, 300:] = pd.NOOP_ISSUE             # a ragged channel
    t[2, 50:58] = pd.NOOP_ISSUE            # an interior no-op run
    tr = tr._replace(t_issue=t)
    cfg = _cfg("figcache_fast", cache_rows=4)
    serial = pd.run_channels(tr, cfg, device=CPU)
    for width in (1, 8, 16):
        got = pwave.run_channel_waves(tr, cfg, width=width, device=CPU)
        _assert_counters_equal(serial, got, width)
    ref = jsched.run_channel_waves(_jax(tr), _cfg("figcache_fast", config=
                                                  jconfig, cache_rows=4))
    _assert_counters_equal(ref, serial, "jax")


def test_wave_sweep_matches_run_sweep():
    """run_sweep_waves batches over stacked params like dram.run_sweep,
    on one channel and on two."""
    cfgs = [_cfg("figcache_fast", cache_rows=cr) for cr in (2, 4)]
    static = pt.shared_static(cfgs)
    params = pt.stack_params([c.params(device=CPU) for c in cfgs])
    one = _pressure_trace()
    two = pd.Trace(*[np.stack(xs) for xs in zip(one, _random_trace(4, 320))])
    for tr in (one, two):
        got = pwave.run_sweep_waves(pwave.form_waves(tr), static, params,
                                    device=CPU)
        _assert_counters_equal(pd.run_sweep(tr, static, params, device=CPU),
                               got, tr.t_issue.ndim)


def test_wave_step_saturates_the_latency_sum():
    """A latency sum started just below LAT_SUM_CAP saturates there; the
    wave step clamps once per wave, as the JAX wave scan does."""
    tr = _random_trace(8, n=96)._replace(
        t_issue=(np.arange(96) * 8).astype(np.int32),
        core=np.zeros(96, np.int32))
    cfg = _cfg("base")
    state = pd.sim_init(cfg.static, device=CPU)
    state.cnt.lat_sum_ns[:] = pd.LAT_SUM_CAP - 40
    wtr = pwave.form_waves(tr)
    got = pwave.resume_waves(wtr, cfg.static, cfg.params(device=CPU), state,
                             device=CPU).cnt
    assert int(got.lat_sum_ns[0, 0]) == pd.LAT_SUM_CAP
    assert int(state.cnt.reads[0]) == 0                 # the input is kept


def test_wave_route_refuses_telemetry():
    cfg = pt.paper_config("base", telemetry=32)
    with pytest.raises(ValueError, match="telemetry"):
        pwave.run_channel_waves(_pressure_trace(), cfg, device=CPU)


# ---------------------------------------------------------------- the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device to launch the sim_scan kernel")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mech,policy", MATRIX)
def test_cuda_wave_route_matches_eager_wave_step(cuda_device, mech, policy):
    """On the card a wave replay is one sim_scan launch over the
    linearized waves; it equals the eager wave step run on the card."""
    tr = ppol.schedule(_pressure_trace(), SchedConfig(**SCHEDS["frfcfs"]))
    cfg = _cfg(mech, policy)
    wtr = pwave.form_waves(tr, lookahead=16)
    p = cfg.params(device=cuda_device)
    state = pd.sim_init(cfg.static, device=cuda_device)
    before = scan.COUNTER.launches
    got = pwave.resume_waves(wtr, cfg.static, p, state, device=cuda_device)
    torch.cuda.synchronize()
    assert scan.COUNTER.launches - before == 1
    want = pwave._advance_waves_eager(wtr, cfg.static, p, state, cuda_device)
    for a, b in zip(scan._leaves(got.bank, got.cnt),
                    scan._leaves(want.bank, want.cnt)):
        assert torch.equal(a[1], b[1]), (mech, policy, a[0])
