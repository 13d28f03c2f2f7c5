"""The port's controllers (``repro_torch.core.sched.policies``) against the
JAX package: the service-order permutations bit for bit on random traces
and on the cases of ``tests/test_sched.py``, the carried ``StreamScheduler``
window across chunkings, the simulator entry points under the four
controllers of ``tests/test_obs.py`` (counters and ``RunResult``s equal to
the JAX package's), and all 24 ``GOLDEN`` fingerprints of
``tests/test_obs.py``.  ``cuda`` cases replay scheduled traces through the
``sim_scan`` kernel and hold them against the CPU route."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import dram as jd
from repro.core import simulator as jsim
from repro.core import traces as jtr
from repro.core.sched import policies as jpol
from repro.core.timing import SchedConfig as JSched
from repro.core.timing import paper_config as jconfig
from repro_torch.core import dram as pd
from repro_torch.core import simulator as psim
from repro_torch.core import streaming as pst
from repro_torch.core import traces as ptr
from repro_torch.core.sched import policies as ppol
from repro_torch.core.timing import GEOM, SchedConfig, paper_config
from repro_torch.kernels.sim_scan import sim_scan as scan

CPU = "cpu"
MECHS = ("base", "lldram", "lisa_villa", "figcache_slow", "figcache_fast",
         "figcache_ideal")
CACHED = ("lisa_villa", "figcache_slow", "figcache_fast", "figcache_ideal")
# tests/test_obs.py's controllers, as keyword arguments of SchedConfig
SCHEDS = {
    "fcfs": {},
    "frfcfs": dict(policy="frfcfs", queue_depth=8, starve_cap=4),
    "drain": dict(write_drain=True, drain_batch=4),
    "frfcfs+drain": dict(policy="frfcfs", queue_depth=8, starve_cap=4,
                         write_drain=True, drain_batch=4),
}
# (acts_slow, acts_fast, reads, writes, reloc_blocks, wb_blocks, row_hits,
#  cache_hits, insertions, sum(lat_sum_ns), sum(req_cnt), t_end): GOLDEN of
# tests/test_obs.py:108-153, the chunked (160) replay of _reuse_trace()
GOLDEN = {
    ("base", "fcfs"): (320, 0, 256, 64, 0, 0, 0, 0, 0, 203846, 320, 28920),
    ("base", "frfcfs"): (320, 0, 256, 64, 0, 0, 0, 0, 0, 203846, 320, 28920),
    ("base", "drain"): (320, 0, 256, 64, 0, 0, 0, 0, 0, 204769, 320, 28968),
    ("base", "frfcfs+drain"): (320, 0, 256, 64, 0, 0, 0, 0, 0, 204769, 320,
                               28968),
    ("lldram", "fcfs"): (0, 320, 256, 64, 0, 0, 0, 0, 0, 132798, 320, 19118),
    ("lldram", "frfcfs"): (0, 320, 256, 64, 0, 0, 0, 0, 0, 132798, 320,
                           19118),
    ("lldram", "drain"): (0, 320, 256, 64, 0, 0, 0, 0, 0, 133624, 320,
                          19188),
    ("lldram", "frfcfs+drain"): (0, 320, 256, 64, 0, 0, 0, 0, 0, 133624,
                                 320, 19188),
    ("lisa_villa", "fcfs"): (296, 24, 256, 64, 37888, 7552, 0, 24, 296,
                             257761, 320, 36264),
    ("lisa_villa", "frfcfs"): (296, 24, 256, 64, 37888, 7552, 0, 24, 296,
                               257761, 320, 36264),
    ("lisa_villa", "drain"): (297, 23, 256, 64, 38016, 7552, 0, 23, 297,
                              257802, 320, 36262),
    ("lisa_villa", "frfcfs+drain"): (297, 23, 256, 64, 38016, 7552, 0, 23,
                                     297, 257802, 320, 36262),
    ("figcache_slow", "fcfs"): (295, 0, 256, 64, 4320, 752, 25, 50, 270,
                                299156, 320, 42932),
    ("figcache_slow", "frfcfs"): (295, 0, 256, 64, 4320, 752, 25, 50, 270,
                                  299156, 320, 42932),
    ("figcache_slow", "drain"): (291, 0, 256, 64, 4272, 768, 29, 53, 267,
                                 296726, 320, 42712),
    ("figcache_slow", "frfcfs+drain"): (291, 0, 256, 64, 4272, 768, 29, 53,
                                        267, 296726, 320, 42712),
    ("figcache_fast", "fcfs"): (270, 25, 256, 64, 4320, 752, 25, 50, 270,
                                291785, 320, 42012),
    ("figcache_fast", "frfcfs"): (270, 25, 256, 64, 4320, 752, 25, 50, 270,
                                  291785, 320, 42012),
    ("figcache_fast", "drain"): (267, 24, 256, 64, 4272, 768, 29, 53, 267,
                                 290152, 320, 41884),
    ("figcache_fast", "frfcfs+drain"): (267, 24, 256, 64, 4272, 768, 29,
                                        53, 267, 290152, 320, 41884),
    ("figcache_ideal", "fcfs"): (270, 25, 256, 64, 4320, 752, 25, 50, 270,
                                 185359, 320, 26656),
    ("figcache_ideal", "frfcfs"): (270, 25, 256, 64, 4320, 752, 25, 50,
                                   270, 185359, 320, 26656),
    ("figcache_ideal", "drain"): (267, 24, 256, 64, 4272, 768, 29, 53, 267,
                                  184511, 320, 26528),
    ("figcache_ideal", "frfcfs+drain"): (267, 24, 256, 64, 4272, 768, 29,
                                         53, 267, 184511, 320, 26528),
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The eager loops run thousands of tiny ops; with several test workers
    on one host, torch's intra-op threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(mech, sid="fcfs", config=paper_config, sched=SchedConfig, **kw):
    if mech in CACHED:
        kw.setdefault("cache_rows", 2)
    return config(mech, sched=sched(**SCHEDS[sid]), **kw)


def _reuse_trace(n=320):
    """tests/test_obs.py:_reuse_trace() as numpy arrays."""
    idx = np.arange(n)
    return pd.Trace(t_issue=(idx * 16).astype(np.int32),
                    bank=(idx % 3).astype(np.int32),
                    row=((idx * 7) % 13).astype(np.int32),
                    col=((idx * 13) % 128).astype(np.int32),
                    is_write=idx % 5 == 0, core=(idx % 8).astype(np.int32))


def _random_trace(seed, n=240, rows=8, channels=None, noops=0):
    """tests/test_sched.py's _sched_trace (one channel) or a (C, T) stack
    of them, each channel ending in ``noops`` no-op requests."""
    if channels is not None:
        chans = [_random_trace(seed * 31 + c, n, rows, None, noops)
                 for c in range(channels)]
        return pd.Trace(*[np.stack(xs) for xs in zip(*chans)])
    rng = np.random.default_rng(seed)
    tr = pd.Trace(t_issue=np.cumsum(rng.integers(1, 40, n)).astype(np.int32),
                  bank=rng.integers(0, GEOM.n_banks, n).astype(np.int32),
                  row=rng.integers(0, rows, n).astype(np.int32),
                  col=rng.integers(0, 128, n).astype(np.int32),
                  is_write=rng.random(n) < 0.4,
                  core=rng.integers(0, GEOM.n_cores, n).astype(np.int32))
    return pd.noop_pad(tr, n + noops)


def _jax_trace(tr):
    return jd.Trace(*[np.asarray(x) for x in tr])


def _assert_traces_equal(ref, got, ctx):
    for f in pd.Trace._fields:
        a, b = np.asarray(getattr(ref, f)), np.asarray(getattr(got, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), (ctx, f)


def _fingerprint(cnt):
    return tuple(int(x.sum()) for x in cnt)


# ------------------------------------------------------- the permutations

@pytest.mark.parametrize("seed", range(6))
def test_perms_match_jax(seed):
    """frfcfs_perm (with a tight arrival window, ties in the row-hit walk,
    starve caps 0..8) and write_drain_perm equal the JAX package's."""
    tr = _random_trace(seed, rows=3 + seed)
    b, r, w = (np.asarray(x).tolist() for x in (tr.bank, tr.row,
                                                  tr.is_write))
    t = np.asarray(tr.t_issue).tolist()
    order = list(range(len(t)))
    rng = np.random.default_rng(seed)
    for qd, cap, window in ((1, 4, 400), (8, 0, 400), (8, 4, 40),
                            (32, 8, 10 ** 6), (int(rng.integers(2, 40)),
                                               int(rng.integers(1, 9)), 8)):
        args = (b, r, t, order, qd, cap, GEOM.n_banks, window)
        assert ppol.frfcfs_perm(*args) == jpol.frfcfs_perm(*args), \
            (seed, qd, cap, window)
    for batch in (1, 4, 16, 1000):
        assert ppol.write_drain_perm(b, r, w, order, batch) == \
            jpol.write_drain_perm(b, r, w, order, batch), (seed, batch)


@pytest.mark.parametrize("sid", list(SCHEDS)[1:] + ["window"])
def test_schedule_matches_jax(sid):
    """schedule on one channel and on (C, T) traces with no-op suffixes:
    every leaf, dtype included, equal to the JAX package's, and the no-ops
    stay a suffix."""
    kw = dict(SCHEDS["frfcfs+drain"], arrival_window_ns=2) \
        if sid == "window" else SCHEDS[sid]
    for tr in (_random_trace(3), _random_trace(5, noops=7),
               _random_trace(7, channels=3, noops=5)):
        got = ppol.schedule(tr, SchedConfig(**kw))
        ref = jpol.schedule(_jax_trace(tr), JSched(**kw))
        _assert_traces_equal(ref, got, sid)
        t = np.asarray(got.t_issue)
        assert (t[..., -5:] >= pd.NOOP_ISSUE).all() or not \
            (np.asarray(tr.t_issue) >= pd.NOOP_ISSUE).any()


def test_schedule_accepts_tensor_leaves():
    tr = _random_trace(9)
    sc = SchedConfig(**SCHEDS["frfcfs+drain"])
    got = ppol.schedule(pd.Trace(*[torch.from_numpy(np.asarray(x))
                                   for x in tr]), sc)
    _assert_traces_equal(ppol.schedule(tr, sc), got, "tensors")


# ------------------------------------------------ tests/test_sched.py cases

def _req_keys(tr):
    return sorted(zip(*(np.asarray(x).tolist() for x in
                        (tr.t_issue, tr.bank, tr.row, tr.col))))


@pytest.mark.parametrize("seed,qd,cap,drain", [
    (0, 1, 0, False), (1, 5, 3, True), (2, 16, 8, False), (3, 32, 2, True),
    (4, 9, 1, True)])
def test_frfcfs_is_permutation_and_respects_starve_cap(seed, qd, cap, drain):
    sc = SchedConfig("frfcfs", queue_depth=qd, starve_cap=cap,
                     write_drain=drain, drain_batch=8,
                     arrival_window_ns=10 ** 6)
    tr = _random_trace(seed)
    out = ppol.schedule(tr, sc)
    assert _req_keys(out) == _req_keys(tr)
    order = list(range(np.asarray(tr.t_issue).size))
    if drain:
        order = ppol.write_drain_perm(
            np.asarray(tr.bank).tolist(), np.asarray(tr.row).tolist(),
            np.asarray(tr.is_write).tolist(), order, 8)
    pos = {i: k for k, i in enumerate(order)}
    tmap = {}
    t_in = np.asarray(tr.t_issue).tolist()
    for i in order:
        tmap.setdefault(t_in[i], []).append(pos[i])
    pending = set(range(len(order)))
    bypass = 0
    for ti in np.asarray(out.t_issue).tolist():
        p = tmap[ti].pop(0)
        if p == min(pending):
            bypass = 0
        else:
            bypass += 1
            assert bypass <= cap, (p, bypass, cap)
        pending.remove(p)


def test_frfcfs_starve_cap_zero_is_fcfs():
    tr = _random_trace(3)
    out = ppol.schedule(tr, SchedConfig("frfcfs", starve_cap=0))
    assert np.array_equal(out.t_issue, tr.t_issue)


def test_fcfs_is_identity_object():
    tr = _random_trace(3)
    assert ppol.schedule(tr, SchedConfig()) is tr
    assert ppol.schedule(tr, None) is tr


def test_frfcfs_serves_row_hit_first():
    tr = pd.Trace(t_issue=np.asarray([0, 1, 2], np.int32),
                  bank=np.zeros(3, np.int32),
                  row=np.asarray([7, 9, 7], np.int32),
                  col=np.asarray([0, 0, 16], np.int32),
                  is_write=np.zeros(3, bool), core=np.zeros(3, np.int32))
    out = ppol.schedule(tr, SchedConfig("frfcfs", queue_depth=4))
    assert out.row.tolist() == [7, 7, 9]


def test_frfcfs_preserves_per_row_fifo():
    tr = _random_trace(11)
    out = ppol.schedule(tr, SchedConfig("frfcfs", queue_depth=16))
    key_in = np.asarray(tr.bank) * 1000 + np.asarray(tr.row)
    key_out = out.bank * 1000 + out.row
    for k in np.unique(key_in):
        assert np.array_equal(np.asarray(tr.t_issue)[key_in == k],
                              out.t_issue[key_out == k]), k


def test_write_drain_batches_writes():
    n = 12
    tr = pd.Trace(
        t_issue=np.arange(n, dtype=np.int32),
        bank=np.asarray([3, 2, 0, 1, 0, 1, 2, 0, 1, 2, 0, 1], np.int32),
        row=np.arange(n, dtype=np.int32) % 4, col=np.zeros(n, np.int32),
        is_write=np.asarray([0, 1, 0, 1, 0, 1, 0, 1, 0, 0, 0, 0], bool),
        core=np.zeros(n, np.int32))
    out = ppol.schedule(tr, SchedConfig("fcfs", write_drain=True,
                                        drain_batch=4))
    wr = out.is_write
    first = int(np.argmax(wr))
    assert wr[first:first + 4].all() and wr.sum() == 4
    keys = list(zip(out.bank[first:first + 4].tolist(),
                    out.row[first:first + 4].tolist()))
    assert keys == sorted(keys)


# --------------------------------------------------- the carried window

@pytest.mark.parametrize("sid", list(SCHEDS)[1:])
def test_stream_scheduler_matches_schedule(sid):
    """feed/flush over any chunking (1, 13, 64, whole; chunk-interior
    no-ops dropped) emits exactly the monolithic schedule, which is the
    JAX package's."""
    tr = _random_trace(17, n=300, rows=5, noops=20)
    sc = SchedConfig(**SCHEDS[sid])
    ref = jpol.schedule(_jax_trace(tr), JSched(**SCHEDS[sid]))
    real = np.asarray(ref.t_issue) < pd.NOOP_ISSUE
    for L in (1, 13, 64, 320):
        ss = ppol.StreamScheduler(sc)
        parts = [ss.feed(seg) for seg in pst.iter_chunks(tr, L)]
        parts.append(ss.flush())
        for f in pd.Trace._fields:
            got = np.concatenate([getattr(p, f) for p in parts])
            assert np.array_equal(got, np.asarray(getattr(ref, f))[real]), \
                (sid, L, f)


# ------------------------------------------------ the simulator entry points

def _assert_result_equal(ref, got, ctx):
    assert ref.mechanism == got.mechanism, ctx
    for f in ("ipc", "avg_lat_ns"):
        assert np.array_equal(getattr(ref, f), getattr(got, f)), (ctx, f)
    for f in ("row_hit_rate", "cache_hit_rate", "exec_time_ns",
              "dram_energy_nj", "system_energy_nj"):
        assert getattr(ref, f) == getattr(got, f), (ctx, f)
    assert ref.energy_parts == got.energy_parts, ctx
    for name, a, b in zip(got.counters._fields, ref.counters, got.counters):
        assert np.array_equal(np.asarray(a), b), (ctx, name)


def _grid(config, sched):
    """Every controller over three mechanisms, two FTS geometries."""
    return [_cfg(m, sid, config, sched, **kw) for sid in SCHEDS
            for m, kw in (("base", {}), ("figcache_fast", {}),
                          ("lisa_villa", dict(cache_rows=4)))]


def test_sweep_matches_jax_under_every_controller():
    apps = ("libquantum", "mcf")
    tr_p = ptr.build_trace([ptr.app_params(a) for a in apps], 2, 256, 4)
    tr_j = jtr.build_trace([jtr.app_params(a) for a in apps], 2, 256, 4)
    got = psim.sweep(tr_p, _grid(paper_config, SchedConfig),
                     tuple(ptr.app_params(a) for a in apps), device=CPU)
    ref = jsim.sweep(tr_j, _grid(jconfig, JSched),
                     tuple(jtr.app_params(a) for a in apps))
    for i, (r, g) in enumerate(zip(ref, got)):
        _assert_result_equal(r, g, i)


def test_run_mechanism_matches_jax_under_every_controller():
    a_p, a_j = ptr.app_params("mcf"), jtr.app_params("mcf")
    tr = _jax_trace(ptr.build_trace([a_p], 1, 256, 1))
    one = pd.Trace(*[x[0] for x in tr])
    for sid in SCHEDS:
        got = psim.run_mechanism(one, _cfg("figcache_fast", sid),
                                 (a_p,), device=CPU)
        ref = jsim.run_mechanism(jd.Trace(*[x[0] for x in tr]),
                                 _cfg("figcache_fast", sid, jconfig, JSched),
                                 (a_j,))
        _assert_result_equal(ref, got, sid)


def test_sweep_traces_matches_jax_under_every_controller():
    """Ragged single-channel workloads: scheduled before the no-op
    padding, as in the JAX package."""
    specs = (("libquantum", 300, 1), ("mcf", 200, 2))
    trs = [pd.Trace(*[x[0] for x in ptr.build_trace(
        [ptr.app_params(a)], 1, n, s)]) for a, n, s in specs]
    apps_p = [(ptr.app_params(a),) for a, _, _ in specs]
    apps_j = [(jtr.app_params(a),) for a, _, _ in specs]
    grid_p = [_cfg("figcache_fast", sid) for sid in SCHEDS]
    grid_j = [_cfg("figcache_fast", sid, jconfig, JSched) for sid in SCHEDS]
    got = psim.sweep_traces(trs, grid_p, apps_p, device=CPU)
    ref = jsim.sweep_traces([_jax_trace(tr) for tr in trs], grid_j, apps_j)
    for w in range(len(specs)):
        for i in range(len(SCHEDS)):
            _assert_result_equal(ref[w][i], got[w][i], (w, i))


# ------------------------------------------------------------ the goldens

@pytest.mark.parametrize("sid", list(SCHEDS))
@pytest.mark.parametrize("mech", MECHS)
def test_golden_fingerprints(mech, sid):
    """tests/test_obs.py's 24 GOLDEN fingerprints: the chunked (160)
    replay, as that file runs it, and the monolithic replay of the
    scheduled trace."""
    cfg = _cfg(mech, sid)
    tr = _reuse_trace()
    streamed = pst.simulate_stream(pst.iter_chunks(tr, 160), cfg,
                                   device=CPU)
    assert _fingerprint(streamed) == GOLDEN[(mech, sid)]
    mono = pd.run_channel(ppol.schedule(tr, cfg.sched), cfg, device=CPU)
    assert _fingerprint(mono) == GOLDEN[(mech, sid)]


# ---------------------------------------------------------------- the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device to launch the sim_scan kernel")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("sid", list(SCHEDS))
def test_cuda_goldens_through_sim_scan(cuda_device, sid):
    """Each controller's six goldens on the card: one sim_scan launch per
    streamed segment (two) and per monolithic replay."""
    for mech in MECHS:
        cfg = _cfg(mech, sid)
        before = scan.COUNTER.launches
        streamed = pst.simulate_stream(pst.iter_chunks(_reuse_trace(), 160),
                                       cfg, device=cuda_device)
        mono = pd.run_channel(ppol.schedule(_reuse_trace(), cfg.sched), cfg,
                              device=cuda_device)
        assert scan.COUNTER.launches - before == 3
        assert _fingerprint(streamed) == GOLDEN[(mech, sid)]
        assert _fingerprint(mono) == GOLDEN[(mech, sid)]


@pytest.mark.cuda
def test_cuda_sweep_under_every_controller_matches_cpu(cuda_device):
    apps = tuple(ptr.app_params(a) for a in ("libquantum", "mcf"))
    tr = ptr.build_trace(list(apps), 2, 512, 4)
    grid = _grid(paper_config, SchedConfig)
    got = psim.sweep(tr, grid, apps, device=cuda_device)
    ref = psim.sweep(tr, grid, apps, device=CPU)
    for i, (r, g) in enumerate(zip(ref, got)):
        _assert_result_equal(r, g, i)


def test_golden_table_is_test_obs_golden():
    """The table above is tests/test_obs.py's, key for key."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).with_name("test_obs.py")
    spec = importlib.util.spec_from_file_location("_obs_golden", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.GOLDEN == GOLDEN
    assert dataclasses.asdict(mod.SCHEDS["frfcfs+drain"]) == \
        dataclasses.asdict(JSched(**SCHEDS["frfcfs+drain"]))
