"""The whole-trace replay kernel (``kernels/sim_scan``, ``csrc/sim_scan.cu``)
against the eager step loop (``dram._advance_eager``) and the JAX package.

The kernel is CUDA and runs only on the card.  Its per-request code
(``csrc/sim_step.cuh``) is shared with a host build (``csrc/sim_host.cpp``,
the same step with a scalar lookup, compiled here with ``g++``), which these
tests replay over the 18 mechanism x policy cells, a capacity grid up to a
4096-slot bucket, no-op padding and a chunked resume: every state leaf
and counter bitwise equal to the eager loop, and the counters to the JAX
package's ``run_sweep``; with telemetry windows, every telemetry leaf and
frame row too (periods 1, 7 and 32, windows saturating ``LAT_SUM_CAP``,
zero-latency requests).  The ``cuda`` cases hold the kernel itself
against the eager loop on the card (with the ``fts_lookup`` kernel in each
cached step), its telemetry instantiation included, and count launches.
"""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import dram as jd
from repro.core import timing as jt
from repro.core import traces as jtr
from repro_torch.core import dram as pd
from repro_torch.core import timing as pt
from repro_torch.kernels import _build
from repro_torch.kernels.fts_lookup import fts_lookup as lookup_kernel
from repro_torch.kernels.sim_scan import sim_scan as scan

CACHED = ("lisa_villa", "figcache_slow", "figcache_fast", "figcache_ideal")
POLICIES = ("row_benefit", "segment_benefit", "lru", "random")
MATRIX = [(m, "row_benefit") for m in ("base", "lldram")] + \
    [(m, p) for m in CACHED for p in POLICIES]
# fig 12's capacity axis reaches the 4096-slot bucket: 512 cache rows of 8
# segments; beside it the grid of test_torch_dram's capacity test
CAPACITY_GRID = [dict(cache_rows=2), dict(cache_rows=4, seg_blocks=8),
                 dict(cache_rows=16), dict(cache_rows=512)]


def _trace(n=320, bank_mod=4, row_mod=97, seed=None):
    """tests/test_hotloop.py's pressure trace (seed None) or a random one
    with negative-free fields drawn from ``seed``."""
    idx = np.arange(n)
    if seed is None:
        return pd.Trace(t_issue=(idx * 16).astype(np.int32),
                        bank=(idx % bank_mod).astype(np.int32),
                        row=((idx * 7) % row_mod).astype(np.int32),
                        col=((idx * 13) % 128).astype(np.int32),
                        is_write=idx % 5 == 0,
                        core=(idx % 8).astype(np.int32))
    rng = np.random.default_rng(seed)
    return pd.Trace(t_issue=np.sort(rng.integers(0, 40 * n, n)).astype(
        np.int32), bank=rng.integers(0, 16, n).astype(np.int32),
        row=rng.integers(0, 32768, n).astype(np.int32),
        col=rng.integers(0, 128, n).astype(np.int32),
        is_write=rng.random(n) < 0.3, core=rng.integers(0, 8, n).astype(
            np.int32))


def _cfg(mech, policy="row_benefit", cache_rows=2, **kw):
    if mech in CACHED:
        kw["cache_rows"] = cache_rows
    return pt.paper_config(mech, policy=policy, **kw)


def _leaves(state):
    return scan._leaves(state.bank, state.cnt)


def _assert_states_equal(got, want, ctx):
    for (name, a), (_, b) in zip(_leaves(got), _leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype, (ctx, name)
        assert torch.equal(a.cpu(), b.cpu()), (ctx, name)


def _host_replay(trace, static, params, state):
    """The host build of the step over a clone of ``state`` (CPU)."""
    tr, lp, st = pd._prepare(trace, params, state, torch.device("cpu"))
    scan.host_replay(tr, lp, st.bank, st.cnt, static, pd.GEOM)
    return st


@pytest.fixture(scope="module")
def host_build():
    """The host library, built once (skips where no C++ compiler is)."""
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler (g++) to build csrc/sim_host.cpp")
    return scan.host_library()


def _grid(cfgs):
    static = pt.shared_static(cfgs)
    params = pt.stack_params([c.params(device="cpu") for c in cfgs])
    return static, params


@pytest.mark.parametrize("mech,policy", MATRIX)
def test_host_step_matches_eager_loop(host_build, mech, policy):
    """The 18 cells on the pressure trace (cache_rows 2: evictions every
    few steps) and on a random 2-channel trace with 16 banks and a run of
    no-ops: every leaf bitwise."""
    cfg = _cfg(mech, policy)
    p = cfg.params(device="cpu")
    for name, trace in (("pressure", _trace()),
                        ("random", pd.Trace(*[np.stack([a, b]) for a, b in
                                              zip(_trace(200, seed=1),
                                                  _trace(200, seed=2))]))):
        trace = pd.noop_pad(trace, trace.t_issue.shape[-1] + 9)
        C = None if trace.t_issue.ndim == 1 else trace.t_issue.shape[0]
        state = pd.sim_init(cfg.static, channels=C, device="cpu")
        want = pd._advance_eager(trace, cfg.static, p, state, device="cpu")
        got = _host_replay(trace, cfg.static, p, state)
        _assert_states_equal(got, want, (mech, policy, name))
        assert int(got.cnt.reads.sum() + got.cnt.writes.sum()) == \
            trace.t_issue.size - 9 * (1 if C is None else C)


@pytest.mark.parametrize("policy", ["row_benefit", "lru"])
def test_host_step_capacity_grid(host_build, policy):
    """A 4-point capacity grid up to the 4096-slot bucket on a 2-channel
    build_trace: the host build equals the eager loop (every leaf) and the
    JAX package's vmapped run_sweep (every counter)."""
    apps = [jtr.app_params(n) for n in ("libquantum", "mcf", "gcc")]
    jtrace = jtr.build_trace(apps, 2, 256, 4)
    pcfgs = [pt.paper_config("figcache_fast", policy=policy, **kw)
             for kw in CAPACITY_GRID]
    static, params = _grid(pcfgs)
    assert static.max_slots == 4096
    trace = pd.Trace(*[np.asarray(x) for x in jtrace])
    state = pd.sim_init(static, channels=2, batch=len(pcfgs), device="cpu")
    want = pd._advance_eager(trace, static, params, state, device="cpu")
    got = _host_replay(trace, static, params, state)
    _assert_states_equal(got, want, policy)
    jcfgs = [jt.paper_config("figcache_fast", policy=policy, **kw)
             for kw in CAPACITY_GRID]
    jbatch = jax.tree.map(lambda *xs: jnp.stack(xs),
                          *[c.params() for c in jcfgs])
    ref = jd.run_sweep(jax.tree.map(jnp.asarray, jtrace),
                       jt.shared_static(jcfgs), jbatch)
    for f, a in zip(pd.Counters._fields, got.cnt):
        b = np.asarray(getattr(ref, f))
        assert np.array_equal(a.reshape(b.shape).numpy(), b), f


def test_host_step_chunked_resume(host_build):
    """Three chunks, each from the last one's state, equal one replay."""
    cfg = _cfg("figcache_fast", cache_rows=4)
    p, trace = cfg.params(device="cpu"), _trace(300, seed=3)
    state = pd.sim_init(cfg.static, device="cpu")
    whole = _host_replay(trace, cfg.static, p, state)
    for lo, hi in ((0, 7), (7, 150), (150, 300)):
        state = _host_replay(pd.Trace(*[x[lo:hi] for x in trace]),
                             cfg.static, p, state)
    _assert_states_equal(state, whole, "chunks")


def test_lat_sum_saturates_on_every_core(host_build):
    """A resumed state with latency sums past LAT_SUM_CAP on cores the
    trace never touches: the eager loop clamps every core at its first
    step, and so does the host build."""
    cfg = _cfg("base")
    p, trace = cfg.params(device="cpu"), _trace(20)
    trace = trace._replace(core=np.zeros(20, np.int32))
    state = pd.sim_init(cfg.static, device="cpu")
    state.cnt.lat_sum_ns[0, 3] = pd.LAT_SUM_CAP + 100
    state.cnt.lat_sum_ns[0, 0] = pd.LAT_SUM_CAP - 5
    want = pd._advance_eager(trace, cfg.static, p, state, device="cpu")
    got = _host_replay(trace, cfg.static, p, state)
    assert int(want.cnt.lat_sum_ns[0, 3]) == pd.LAT_SUM_CAP
    _assert_states_equal(got, want, "lat-sum")


def _tel_replays(trace, static, params, state):
    """(host build, eager loop) of a telemetry replay: each the new state
    and the lane-layout frames."""
    cpu = torch.device("cpu")
    tr, lp, st = pd._prepare(trace, params, state, cpu)
    tel = pd._open(static, st, tr.t_issue.shape[0])
    scan.host_replay(tr, lp, st.bank, st.cnt, static, pd.GEOM, tel)
    got = pd._close(st, tel, True)
    want = pd._advance_eager(trace, static, params, state, device=cpu,
                             with_frames=True)
    return got, want


def _assert_tel_equal(got, want, ctx):
    """Every state leaf, every telemetry leaf and every frame row (filler
    rows too), bitwise."""
    (gs, gf), (ws, wf) = got, want
    _assert_states_equal(gs, ws, ctx)
    leaves = []
    for tree in (gs.tel, gf, ws.tel, wf):
        leaves.append([])
        pd._map(leaves[-1].append, tree)
    assert len(leaves[0]) == len(leaves[2]) == 16
    for a, b in zip(leaves[0] + leaves[1], leaves[2] + leaves[3]):
        assert a.shape == b.shape and torch.equal(a, b), ctx


@pytest.mark.parametrize("period", [1, 7, 32])
@pytest.mark.parametrize("mech,policy", [("base", "row_benefit"),
                                         ("lldram", "row_benefit"),
                                         ("figcache_fast", "row_benefit"),
                                         ("lisa_villa", "lru"),
                                         ("figcache_slow", "random")])
def test_host_step_telemetry_matches_eager_loop(host_build, mech, policy,
                                                period):
    """The kernel's telemetry (window in registers, planes in a buffer,
    ring rows written at a close and at the end) against the eager loop's
    row-every-step discipline: a 2-channel random trace with a run of
    no-ops, SLO 40 ns, resumed from the first segment's state."""
    cfg = _cfg(mech, policy, telemetry=period, slo_ns=40)
    p = cfg.params(device="cpu")
    trace = pd.noop_pad(pd.Trace(*[np.stack([a, b]) for a, b in zip(
        _trace(150, seed=4), _trace(150, seed=5))]), 161)
    state = pd.sim_init(cfg.static, channels=2, device="cpu")
    for lo, hi in ((0, 40), (40, 161)):
        seg = pd.Trace(*[x[:, lo:hi] for x in trace])
        got, want = _tel_replays(seg, cfg.static, p, state)
        _assert_tel_equal(got, want, (mech, policy, period, lo))
        state = want[0]
    assert int(state.tel.hist.sum()) == 300


def test_host_step_telemetry_saturates_and_buckets_zero(host_build):
    """Windows entering past and near LAT_SUM_CAP (every lane clamps each
    step, no-ops included), and zero-latency requests (cas = bl = 0 on an
    idle bank's open row: bucket 0): host build == eager loop."""
    cfg = _cfg("base", telemetry=16, slo_ns=3)
    n = 64
    idx = np.arange(n)
    trace = pd.noop_pad(pd.Trace(
        t_issue=(idx * 400).astype(np.int32), bank=np.zeros(n, np.int32),
        row=(idx // 8).astype(np.int32), col=(idx % 128).astype(np.int32),
        is_write=idx % 3 == 0, core=(idx % 8).astype(np.int32)), 70)
    p = cfg.params(device="cpu")
    p = p._replace(cas=torch.zeros_like(p.cas), bl=torch.zeros_like(p.bl))
    state = pd.sim_init(cfg.static, device="cpu")
    win = state.tel.win
    win.w_lat_ns[0] = pd.LAT_SUM_CAP - 5
    win.w_mshr_wait[0] = pd.LAT_SUM_CAP + 100
    win.w_bus_wait[0] = pd.LAT_SUM_CAP
    got, want = _tel_replays(trace, cfg.static, p, state)
    _assert_tel_equal(got, want, "saturation")
    frames = want[1]
    assert int(frames.win.w_lat_ns[0, 0]) == pd.LAT_SUM_CAP
    assert int(frames.win.w_mshr_wait[0, 0]) == pd.LAT_SUM_CAP
    hist = want[0].tel.hist[0].sum(dim=(0, 1))
    assert int(hist[0]) > 0 and int(hist.sum()) == n


def test_pack_checks_every_leaf():
    """The wrapper's checks: 50 leaves in the order of make_args, and a
    ValueError for a wrong dtype, shape, layout or device; with a
    telemetry period the 9 TelScan leaves follow (59) and the period and
    ring rows close the dims, and a missing carry or a wrong ring size
    raises."""
    cfg = _cfg("figcache_fast")
    state = pd.sim_init(cfg.static, device="cpu")
    cpu = torch.device("cpu")
    tr, lp, st = pd._prepare(_trace(8), cfg.params(device="cpu"), state, cpu)
    bank, cnt = st.bank, st.cnt
    ptrs, dims = scan.pack(tr, lp, bank, cnt, cfg.static, pd.GEOM, cpu)
    assert len(ptrs) == 50 and list(dims)[:7] == [8, 1, 16, 512, 8, 256, 8]
    bad = [(tr._replace(bank=tr.bank.to(torch.int64)), lp, bank, cnt),
           (tr, lp._replace(rcd=lp.rcd[:0]), bank, cnt),
           (tr, lp, bank._replace(busy=bank.busy.t()), cnt),
           (tr, lp, bank, cnt._replace(reads=cnt.reads.to("meta")))]
    for args in bad:
        with pytest.raises(ValueError, match="sim_scan"):
            scan.pack(*args, cfg.static, pd.GEOM, cpu)
    assert list(dims)[12:] == [0, 0]
    tele = _cfg("figcache_fast", telemetry=8)
    tr, lp, st = pd._prepare(_trace(8), tele.params(device="cpu"),
                             pd.sim_init(tele.static, device="cpu"), cpu)
    tel = pd._open(tele.static, st, 8)
    ptrs, dims = scan.pack(tr, lp, st.bank, st.cnt, tele.static, pd.GEOM,
                           cpu, tel)
    assert len(ptrs) == 59 and list(dims)[12:] == [8, 4]
    with pytest.raises(ValueError, match="TelScan"):
        scan.pack(tr, lp, st.bank, st.cnt, tele.static, pd.GEOM, cpu)
    with pytest.raises(ValueError, match="TelScan"):
        scan.pack(tr, lp, st.bank, st.cnt, cfg.static, pd.GEOM, cpu, tel)
    with pytest.raises(ValueError, match="ring"):
        scan.pack(tr, lp, st.bank, st.cnt, tele.static, pd.GEOM, cpu,
                  tel._replace(buf_scalars=tel.buf_scalars[:, :3]))
    with pytest.raises(ValueError, match="tel.hist"):
        scan.pack(tr, lp, st.bank, st.cnt, tele.static, pd.GEOM, cpu,
                  tel._replace(hist=tel.hist[..., :4].contiguous()))
    with pytest.raises(ValueError, match="CUDA"):
        scan.sim_scan(tr, lp, bank, cnt, cfg.static, pd.GEOM)


def test_cpu_entry_points_run_the_eager_loop():
    """On the CPU run_sweep, simulate and resume take the eager loop: no
    launch of either kernel."""
    before = (scan.COUNTER.launches, lookup_kernel.COUNTER.launches)
    cfg = _cfg("figcache_fast", fts_kernel=True)
    pd.run_channel(_trace(40), cfg, device="cpu")
    assert (scan.COUNTER.launches, lookup_kernel.COUNTER.launches) == before


def test_build_key_follows_the_headers(tmp_path, monkeypatch):
    """An edited csrc header changes the library key of every CUDA source
    (so both fts_lookup and sim_scan rebuild), and of the host build."""
    for f in _build.CSRC.iterdir():
        if f.suffix in (".cu", ".cuh", ".cpp"):
            (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    names = ("fts_lookup", "sim_scan", "figaro_reloc")
    before = {n: _build._lib_path(n) for n in names}
    host = _build._key(tmp_path / "sim_host.cpp", _build.HOST_FLAGS)
    assert before == {n: _build._lib_path(n) for n in names}
    header = tmp_path / "fts_lookup.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build._lib_path(n) for n in names}
    assert all(after[n] != before[n] for n in names)
    assert _build._key(tmp_path / "sim_host.cpp", _build.HOST_FLAGS) != host
    (tmp_path / "sim_step.cuh").write_text("// edited\n")
    assert _build._lib_path("sim_scan") != after["sim_scan"]


# ---------------------------------------------------------------- the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device to launch the sim_scan kernel")
    return torch.device("cuda")


def _on_card(trace, static, params, state, dev):
    """(kernel replay, eager replay) of the same inputs on the card, and
    the launches of each kernel in each."""
    counts = []
    out = []
    for advance in (pd._advance, pd._advance_eager):
        before = (scan.COUNTER.launches, lookup_kernel.COUNTER.launches)
        out.append(advance(trace, static, params, state, "fused", dev))
        torch.cuda.synchronize()
        counts.append((scan.COUNTER.launches - before[0],
                       lookup_kernel.COUNTER.launches - before[1]))
    return out, counts


@pytest.mark.cuda
@pytest.mark.parametrize("mech,policy", MATRIX)
def test_cuda_kernel_matches_eager_loop(cuda_device, mech, policy):
    """The 18 cells: one sim_scan launch and no lookup launch, every leaf
    bitwise equal to the eager loop (one lookup launch a cached step)."""
    cfg = _cfg(mech, policy)
    trace = pd.noop_pad(_trace(), 330)
    p = cfg.params(device=cuda_device)
    state = pd.sim_init(cfg.static, device=cuda_device)
    (got, want), counts = _on_card(trace, cfg.static, p, state, cuda_device)
    _assert_states_equal(got, want, (mech, policy))
    assert counts[0] == (1, 0)
    assert counts[1] == (0, 330 if cfg.has_cache else 0)


@pytest.mark.cuda
def test_cuda_capacity_grid_with_a_4096_slot_bucket(cuda_device):
    apps = [jtr.app_params(n) for n in ("libquantum", "mcf", "gcc")]
    trace = pd.Trace(*[np.asarray(x) for x in
                       jtr.build_trace(apps, 2, 1024, 4)])
    cfgs = [pt.paper_config("figcache_fast", **kw) for kw in CAPACITY_GRID]
    static = pt.shared_static(cfgs)
    assert static.max_slots == 4096
    params = pt.stack_params([c.params(device=cuda_device) for c in cfgs])
    state = pd.sim_init(static, channels=2, batch=len(cfgs),
                        device=cuda_device)
    (got, want), counts = _on_card(trace, static, params, state, cuda_device)
    _assert_states_equal(got, want, "capacity")
    assert counts[0] == (1, 0)
    assert int(got.cnt.insertions.sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("period", [1, 32])
@pytest.mark.parametrize("mech,policy", [("base", "row_benefit"),
                                         ("figcache_fast", "row_benefit"),
                                         ("lisa_villa", "lru")])
def test_cuda_telemetry_kernel_matches_eager_loop(cuda_device, mech, policy,
                                                  period):
    """The kernel's telemetry instantiation (one launch) against the eager
    loop on the card: every state and telemetry leaf and every frame row,
    filler rows included."""
    cfg = _cfg(mech, policy, telemetry=period, slo_ns=40)
    trace = pd.noop_pad(_trace(), 330)
    p = cfg.params(device=cuda_device)
    state = pd.sim_init(cfg.static, device=cuda_device)
    before = scan.COUNTER.launches
    got = pd._advance(trace, cfg.static, p, state, "fused", cuda_device,
                      with_frames=True)
    torch.cuda.synchronize()
    assert scan.COUNTER.launches - before == 1
    want = pd._advance_eager(trace, cfg.static, p, state,
                             device=cuda_device, with_frames=True)
    _assert_tel_equal(got, want, (mech, policy, period))


@pytest.mark.cuda
def test_cuda_chunked_resume_equals_one_replay(cuda_device):
    """resume over three chunks (one launch each) equals one replay and
    the eager loop."""
    cfg = _cfg("figcache_fast", cache_rows=4)
    p, trace = cfg.params(device=cuda_device), _trace(600, seed=3)
    state0 = pd.sim_init(cfg.static, device=cuda_device)
    (whole, eager), _ = _on_card(trace, cfg.static, p, state0, cuda_device)
    _assert_states_equal(whole, eager, "whole")
    before = scan.COUNTER.launches
    state = state0
    for lo, hi in ((0, 1), (1, 333), (333, 600)):
        state = pd.resume(pd.Trace(*[x[lo:hi] for x in trace]), cfg.static,
                          p, state, device=cuda_device)
    torch.cuda.synchronize()
    assert scan.COUNTER.launches - before == 3
    _assert_states_equal(state, whole, "chunks")
    assert int(state0.cnt.reads.sum()) == 0          # resume is pure
