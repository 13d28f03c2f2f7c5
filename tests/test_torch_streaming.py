"""The port's streamed replay (``repro_torch.core.streaming``), chunk codec
(``traces.encode_trace`` / ``decode_chunk``) and checkpoints
(``repro_torch.checkpoint``) against the JAX package and against the
monolithic replay: codec leaves equal to the JAX package's and exact round
trips (delta overflow, negative deltas, cluster-table boundaries); chunk
invariance at {1, 7, 64, full}, scheduled and with ``wavefront_exec``;
the interior no-op goldens of ``tests/test_streaming.py``; checkpoint /
resume bitwise, scheduled and past a corrupt newest step; ``sweep``'s
``chunk_len`` routing; what telemetry still refuses; a mid-stream
checkpoint with the telemetry cursor, and a cursor-free state's field
paths.  ``cuda`` cases run the
streamed and decoded routes on the card (one ``sim_scan`` launch per
segment) and hold them against the CPU route."""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import dram as jd
from repro.core import simulator as jsim
from repro.core import streaming as jst
from repro.core import traces as jtr
from repro.core.timing import SchedConfig as JSched
from repro.core.timing import paper_config as jconfig
from repro_torch import checkpoint as ckpt
from repro_torch.core import dram as pd
from repro_torch.core import simulator as psim
from repro_torch.core import streaming as pst
from repro_torch.core import traces as ptr
from repro_torch.core.sched import policies as ppol
from repro_torch.core.timing import GEOM, SchedConfig, paper_config
from repro_torch.kernels.sim_scan import sim_scan as scan
from repro_torch.obs import WindowCollector

CPU = "cpu"
CACHED = ("lisa_villa", "figcache_slow", "figcache_fast", "figcache_ideal")
CHUNKS = (1, 7, 64, 320)          # 320 == the full pressure trace
SCHEDS = {
    "fcfs": {},
    "frfcfs": dict(policy="frfcfs", queue_depth=8, starve_cap=4),
    "drain": dict(write_drain=True, drain_batch=4),
    "frfcfs+drain": dict(policy="frfcfs", queue_depth=8, starve_cap=4,
                         write_drain=True, drain_batch=4),
}
# tests/test_streaming.py's _GOLDEN: counter sums of _interior_noop_trace()
INTERIOR_GOLDEN = {
    "base": dict(acts_slow=120, acts_fast=0, reads=90, writes=30,
                 reloc_blocks=0, wb_blocks=0, row_hits=0, cache_hits=0,
                 insertions=0, lat_sum_ns=29935, req_cnt=120, t_end=6630),
    "figcache_fast": dict(acts_slow=120, acts_fast=0, reads=90, writes=30,
                          reloc_blocks=1920, wb_blocks=160, row_hits=0,
                          cache_hits=0, insertions=120, lat_sum_ns=50400,
                          req_cnt=120, t_end=10050),
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


def _pressure_trace(n=320):
    idx = np.arange(n)
    return pd.Trace(t_issue=(idx * 16).astype(np.int32),
                    bank=(idx % 5).astype(np.int32),
                    row=((idx * 7) % 97).astype(np.int32),
                    col=((idx * 13) % 128).astype(np.int32),
                    is_write=idx % 5 == 0, core=(idx % 8).astype(np.int32))


def _random_trace(seed, n=160):
    rng = np.random.default_rng(seed)
    return pd.Trace(
        t_issue=np.cumsum(rng.integers(0, 120, n)).astype(np.int32),
        bank=rng.integers(0, GEOM.n_banks, n).astype(np.int32),
        row=rng.integers(0, 50, n).astype(np.int32),
        col=rng.integers(0, 128, n).astype(np.int32),
        is_write=rng.random(n) < 0.3,
        core=rng.integers(0, GEOM.n_cores, n).astype(np.int32))


def _interior_noop_trace():
    """tests/test_streaming.py's three 40-request runs separated by 8-deep
    interior no-op runs."""
    parts = []
    for blk in range(3):
        idx = np.arange(40) + blk * 40
        parts.append(pd.Trace(t_issue=idx * 24, bank=idx % 5,
                              row=(idx * 11) % 97, col=(idx * 3) % 128,
                              is_write=idx % 4 == 0, core=idx % 8))
        if blk < 2:
            parts.append(pd.noop_pad(pd.Trace(*[np.zeros(0, int)] * 4 + [
                np.zeros(0, bool), np.zeros(0, int)]), 8))
    cat = [np.concatenate(xs) for xs in zip(*parts)]
    return pd.Trace(*[x.astype(bool if i == 4 else np.int32)
                      for i, x in enumerate(cat)])


def _jax(tr):
    return jd.Trace(*[np.asarray(x) for x in tr])


def _two_channels(n=384):
    apps = [ptr.app_params(a) for a in ("libquantum", "mcf")]
    return ptr.build_trace(apps, 2, n, 4)


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_counters_equal(ref, got, ctx):
    for name, a, b in zip(pd.Counters._fields, ref, got):
        assert np.array_equal(_host(a), _host(b)), (ctx, name)


def _assert_traces_equal(ref, got, ctx):
    for f in pd.Trace._fields:
        a, b = np.asarray(getattr(ref, f)), np.asarray(getattr(got, f))
        assert np.array_equal(a, b), (ctx, f)


def _mono(tr, cfg):
    run = pd.run_channels if tr.t_issue.ndim == 2 else pd.run_channel
    return run(ppol.schedule(tr, cfg.sched), cfg, device=CPU)


# ------------------------------------------------------------- the codec

@pytest.mark.parametrize("seed,chunk_len,max_clusters", [
    (0, 32, 4), (1, 64, 64), (2, 256, 1024), (3, 7, 4), (4, 64, 1024)])
def test_codec_matches_jax_and_round_trips(seed, chunk_len, max_clusters):
    """encode_trace leaves (values and dtypes) equal the JAX package's;
    decode_trace is the identity on real requests."""
    tr = _random_trace(seed)
    got = ptr.encode_trace(tr, chunk_len, max_clusters)
    ref = jtr.encode_trace(_jax(tr), chunk_len, max_clusters)
    assert len(got) == len(ref)
    for a, b in zip(ref, got):
        for f, x, y in zip(a._fields, a, b):
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype and np.array_equal(x, y), (seed, f)
    _assert_traces_equal(tr, ptr.decode_trace(got, device=CPU), seed)
    for a, b in zip(ref, got):
        _assert_traces_equal(jtr.decode_chunk(a),
                             ptr.decode_chunk(b, device=CPU), "chunk")
    assert ptr.encoded_nbytes(got) == jtr.encoded_nbytes(ref)


def test_codec_delta_overflow():
    """Gaps beyond int16 end a chunk early and restart it on a fresh
    int32 base; the round trip stays exact."""
    idx = np.arange(100)
    gaps = np.where(idx % 10 == 9, 200_000, 16)
    tr = _pressure_trace()._replace(
        t_issue=np.cumsum(gaps).astype(np.int32),
        bank=(idx % 5).astype(np.int32), row=(idx % 7).astype(np.int32),
        col=(idx % 128).astype(np.int32), is_write=idx % 3 == 0,
        core=(idx % 8).astype(np.int32))
    chunks = ptr.encode_trace(tr, chunk_len=64)
    assert len(chunks) > 2
    _assert_traces_equal(tr, ptr.decode_trace(chunks, device=CPU), "gaps")


def test_codec_negative_deltas():
    """A scheduled trace's negative deltas encode in int16; deltas beyond
    -2**15 (and +2**15) end the chunk.  Both round-trip exactly."""
    idx = np.arange(160)
    tr = _pressure_trace()._replace(
        t_issue=(idx * 4).astype(np.int32), bank=np.zeros(160, np.int32),
        row=(idx % 2).astype(np.int32), col=(idx % 128).astype(np.int32),
        is_write=idx % 3 == 0, core=(idx % 8).astype(np.int32))
    sched_tr = ppol.schedule(tr, SchedConfig("frfcfs", queue_depth=8,
                                             starve_cap=4))
    assert np.any(np.diff(sched_tr.t_issue) < 0)
    _assert_traces_equal(sched_tr, ptr.decode_trace(
        ptr.encode_trace(sched_tr, chunk_len=64), device=CPU), "small")
    t = tr.t_issue.copy()
    t[50] += 300_000
    adv = tr._replace(t_issue=t)
    chunks = ptr.encode_trace(adv, chunk_len=64)
    assert len(chunks) == 4
    _assert_traces_equal(adv, ptr.decode_trace(chunks, device=CPU), "large")


@pytest.mark.parametrize("distinct", [8, 9])
def test_codec_cluster_boundary(distinct):
    """Exactly max_clusters distinct pages fill the table; one more ends
    the chunk at the boundary.  Both round-trip exactly, and the uint16
    indices decode above 2**15."""
    idx = np.arange(64)
    tr = _pressure_trace()._replace(
        t_issue=(idx * 16).astype(np.int32), bank=(idx % 2).astype(np.int32),
        row=((idx // 2) % (distinct // 2 + distinct % 2)).astype(np.int32),
        col=(idx % 4).astype(np.int32), is_write=idx % 2 == 0,
        core=(idx % 8).astype(np.int32))
    chunks = ptr.encode_trace(tr, chunk_len=64, max_clusters=8)
    assert (len(chunks) > 1) == (distinct > 8)
    _assert_traces_equal(tr, ptr.decode_trace(chunks, device=CPU), distinct)
    wide = np.arange(40000)
    big = pd.Trace(t_issue=wide.astype(np.int32),
                   bank=(wide % 2).astype(np.int32),
                   row=((wide // 2) % 65536).astype(np.int32),
                   col=np.zeros(40000, np.int32),
                   is_write=np.zeros(40000, bool),
                   core=np.zeros(40000, np.int32))
    enc = ptr.encode_trace(big, chunk_len=40000, max_clusters=1 << 16)
    assert len(enc) == 1 and int(enc[0].cl.max()) > (1 << 15)
    _assert_traces_equal(big, ptr.decode_trace(enc, device=CPU), "uint16")


def test_codec_segments_replay_bitwise():
    """encode -> decoded_segments -> simulate_stream equals the monolithic
    replay, single- and multi-channel (channels fragment differently)."""
    cfg = _cfg("figcache_fast")
    tr = _pressure_trace()
    enc = ptr.encode_trace(tr, chunk_len=64)
    _assert_counters_equal(
        pd.run_channel(tr, cfg, device=CPU),
        pst.simulate_stream(pst.decoded_segments(enc, device=CPU), cfg,
                            device=CPU), "one")
    mtr = _two_channels()
    enc2 = [ptr.encode_trace(pd.Trace(*[x[c] for x in mtr]), chunk_len=64,
                             max_clusters=16 + 48 * c) for c in range(2)]
    assert len(enc2[0]) != len(enc2[1])
    _assert_counters_equal(
        pd.run_channels(mtr, cfg, device=CPU),
        pst.simulate_stream(pst.decoded_segments(enc2, device=CPU), cfg,
                            device=CPU), "multi")


# ------------------------------------------------------ chunk invariance

@pytest.mark.parametrize("mech", ["base", "figcache_fast"])
def test_chunk_invariance(mech):
    tr = _pressure_trace()
    cfg = _cfg(mech)
    mono = pd.run_channel(tr, cfg, device=CPU)
    for L in CHUNKS:
        got = pst.simulate_stream(pst.iter_chunks(tr, L), cfg, device=CPU)
        _assert_counters_equal(mono, got, (mech, L))


@pytest.mark.parametrize("sid", list(SCHEDS))
def test_chunk_invariance_scheduled(sid):
    """The carried StreamScheduler window gives schedule-then-monolithic
    bitwise at every chunking, and equals the JAX package's stream."""
    tr = _pressure_trace()
    cfg = _cfg("figcache_fast", sid)
    mono = _mono(tr, cfg)
    for L in CHUNKS:
        got = pst.simulate_stream(pst.iter_chunks(tr, L), cfg, device=CPU)
        _assert_counters_equal(mono, got, (sid, L))
    ref = jst.simulate_stream(jst.iter_chunks(_jax(tr), 64),
                              _cfg("figcache_fast", sid, jconfig, JSched))
    _assert_counters_equal(ref, got, (sid, "jax"))


@pytest.mark.parametrize("sid", ["fcfs", "frfcfs+drain"])
def test_chunk_invariance_wavefront(sid):
    """wavefront_exec: per-segment waves, equal to the serial replay."""
    tr = _pressure_trace()
    cfg = _cfg("figcache_fast", sid)
    mono = _mono(tr, cfg)
    for L in CHUNKS:
        got = pst.simulate_stream(pst.iter_chunks(tr, L), cfg, device=CPU,
                                  wavefront_exec=True)
        _assert_counters_equal(mono, got, (sid, L))


def test_chunk_invariance_multi_channel_scheduled():
    """(C, T) traces with a ragged tail (384 % 100), a controller in
    front: equal to the monolithic replay and to the JAX stream."""
    tr = _two_channels()
    for sid in ("fcfs", "frfcfs+drain"):
        cfg = _cfg("figcache_fast", sid)
        got = pst.simulate_stream(pst.iter_chunks(tr, 100), cfg, device=CPU)
        _assert_counters_equal(_mono(tr, cfg), got, sid)
    ref = jst.simulate_stream(jst.iter_chunks(_jax(tr), 100),
                              _cfg("figcache_fast", sid, jconfig, JSched))
    _assert_counters_equal(ref, got, "jax")


def test_random_traces_chunk_invariance():
    for seed, L, mech in ((0, 1, "base"), (1, 33, "figcache_ideal"),
                          (2, 160, "figcache_fast"), (3, 7, "lldram")):
        tr = _random_trace(seed)
        cfg = _cfg(mech)
        got = pst.simulate_stream(pst.iter_chunks(tr, L), cfg, device=CPU)
        _assert_counters_equal(pd.run_channel(tr, cfg, device=CPU), got,
                               (seed, L))


# --------------------------------------------------- interior no-ops

@pytest.mark.parametrize("mech", ["base", "figcache_fast"])
def test_interior_noops_golden(mech):
    """Interior no-ops are as inert as terminal padding: the serial, wave
    and chunked replays agree with each other, with the JAX package and
    with tests/test_streaming.py's pinned golden counters."""
    from repro_torch.core.sched import wavefront as pwave
    tr = _interior_noop_trace()
    cfg = _cfg(mech)
    fused = pd.run_channel(tr, cfg, device=CPU)
    _assert_counters_equal(fused, pwave.run_channel_waves(tr, cfg,
                                                          device=CPU), "wave")
    _assert_counters_equal(fused, pst.simulate_stream(
        pst.iter_chunks(tr, 17), cfg, device=CPU), "chunked")
    got = {f: int(x.sum()) for f, x in zip(pd.Counters._fields, fused)}
    assert got == INTERIOR_GOLDEN[mech]
    _assert_counters_equal(jd.run_channel(_jax(tr), _cfg(mech, config=
                                                         jconfig,
                                                         sched=JSched)),
                           fused, "jax")


# ------------------------------------------------------ checkpoints

@pytest.mark.parametrize("sid", ["fcfs", "frfcfs+drain"])
def test_checkpoint_resume_bitwise(tmp_path, sid):
    """A stream snapshotted every 2 (3) segments and resumed from the
    newest snapshot finishes bitwise equal to the monolithic replay; the
    skipped prefix is counted in emitted (scheduled) segments."""
    tr = _pressure_trace()
    cfg = _cfg("figcache_fast", sid)
    mono = _mono(tr, cfg)
    every = 2 if sid == "fcfs" else 3
    full = pst.simulate_stream(pst.iter_chunks(tr, 32), cfg, device=CPU,
                               checkpoint_dir=str(tmp_path),
                               checkpoint_every=every)
    _assert_counters_equal(mono, full, "with snapshots")
    assert ckpt.latest_step(str(tmp_path)) == 10 // every * every
    got = pst.resume_stream(pst.iter_chunks(tr, 32), cfg, str(tmp_path),
                            device=CPU)
    _assert_counters_equal(mono, got, "resumed")


def test_resume_falls_back_past_a_corrupt_newest_step(tmp_path):
    tr = _pressure_trace()
    cfg = _cfg("figcache_fast")
    mono = pd.run_channel(tr, cfg, device=CPU)
    pst.simulate_stream(pst.iter_chunks(tr, 64), cfg, device=CPU,
                        checkpoint_dir=str(tmp_path), checkpoint_every=1)
    assert ckpt.committed_steps(str(tmp_path)) == [5, 4, 3, 2, 1]
    with open(tmp_path / "step_5" / "leaf_3.npy", "wb") as f:
        f.write(b"truncated")
    like = pd.sim_init(cfg.static, device=CPU)
    _, chunk = ckpt.restore_sim_state(str(tmp_path), like)
    assert chunk == 4
    got = pst.resume_stream(pst.iter_chunks(tr, 64), cfg, str(tmp_path),
                            device=CPU)
    _assert_counters_equal(mono, got, "fallback")


def test_checkpoint_validation(tmp_path):
    """Structure, shape and dtype mismatches raise CheckpointError;
    uncommitted and .tmp steps are invisible; a wrong kind is an error."""
    cfg = _cfg("figcache_fast")
    state = pd.sim_init(cfg.static, device=CPU)
    ckpt.save_sim_state(str(tmp_path), 3, state)
    os.makedirs(tmp_path / "step_9.tmp")
    os.makedirs(tmp_path / "step_8")
    assert ckpt.committed_steps(str(tmp_path)) == [3]
    with pytest.raises(ckpt.CheckpointError, match="leaves"):
        ckpt.restore_sim_state(str(tmp_path),
                               pd.sim_init(_cfg("base").static, device=CPU)
                               ._replace(cnt=state.cnt[:-1]), step=3)
    with pytest.raises(ckpt.CheckpointError, match="shape"):
        ckpt.restore_sim_state(str(tmp_path), pd.sim_init(
            cfg.static, channels=2, device=CPU), step=3)
    bad = state._replace(cnt=state.cnt._replace(
        t_end=state.cnt.t_end.to(torch.int64)))
    with pytest.raises(ckpt.CheckpointError, match="dtype"):
        ckpt.restore_checkpoint(str(tmp_path), 3, bad)
    swapped = state._replace(cnt=type(state.cnt)(*state.cnt))
    meta = json.loads((tmp_path / "step_3" / "manifest.json").read_text())
    meta["paths"][0] = "bank.closed_row"
    (tmp_path / "step_3" / "manifest.json").write_text(json.dumps(meta))
    with pytest.raises(ckpt.CheckpointError, match="structure"):
        ckpt.restore_checkpoint(str(tmp_path), 3, swapped)
    ckpt.save_checkpoint(str(tmp_path), 4, state, {"kind": "other"})
    with pytest.raises(ckpt.CheckpointError, match="kind"):
        ckpt.restore_sim_state(str(tmp_path), state)


def test_checkpoint_with_telemetry_resumes_bitwise(tmp_path):
    """A telemetry stream checkpointed mid-way (every ``tel`` leaf saved)
    and resumed with a fresh collector finishes bitwise: counters, final
    cursor and cumulative planes, and the resumed windows equal the
    uninterrupted run's windows of the same ordinals."""
    tr = _pressure_trace()
    cfg = dataclasses.replace(_cfg("figcache_fast", "frfcfs+drain"),
                              telemetry=16, slo_ns=40)
    full = WindowCollector()
    want = pst.simulate_stream(pst.iter_chunks(tr, 32), cfg, device=CPU,
                               telemetry=full, checkpoint_dir=str(tmp_path),
                               checkpoint_every=3)
    meta = json.loads((tmp_path / "step_9" / "manifest.json").read_text())
    assert [p for p in meta["paths"] if p.startswith("tel.")] == \
        [f"tel.win.{f}" for f in pd.TelemetryWindows._fields] + \
        ["tel.hist", "tel.slo"]
    col = WindowCollector()
    got = pst.resume_stream(pst.iter_chunks(tr, 32), cfg, str(tmp_path),
                            device=CPU, telemetry=col)
    _assert_counters_equal(want, got, "resumed")
    for k in ("hist", "slo"):
        assert np.array_equal(full.cumulative()[k], col.cumulative()[k]), k
    for a, b in zip(full._final.win, col._final.win):
        assert torch.equal(a, b)
    a, b = full.series(), col.series()
    rows = np.isin(a["win_idx"], b["win_idx"])
    assert 0 < rows.sum() < len(rows)
    for k in a:
        assert np.array_equal(a[k][rows], b[k], equal_nan=True), k


def test_checkpoint_without_telemetry_keeps_its_field_paths(tmp_path):
    """A ``tel=None`` state flattens to exactly the bank and counter
    paths it had before the telemetry cursor existed (no ``tel`` leaf),
    and restores from them."""
    cfg = _cfg("figcache_fast")
    state = pd.sim_init(cfg.static, device=CPU)
    assert state.tel is None
    ckpt.save_sim_state(str(tmp_path), 1, state)
    meta = json.loads((tmp_path / "step_1" / "manifest.json").read_text())
    bank = [f for f in pd.BankState._fields if f != "fts"]
    want = [f"bank.{f}" for f in bank[:2]] + \
        [f"bank.fts.{f}" for f in state.bank.fts._fields] + \
        [f"bank.{f}" for f in bank[2:]] + \
        [f"cnt.{f}" for f in pd.Counters._fields]
    assert meta["paths"] == want and meta["n_leaves"] == 12 + 5 + 12
    got, chunk = ckpt.restore_sim_state(str(tmp_path), state)
    assert chunk == 1 and got.tel is None
    for a, b in zip(scan._leaves(got.bank, got.cnt),
                    scan._leaves(state.bank, state.cnt)):
        assert torch.equal(a[1], b[1]), a[0]


def test_checkpoint_leaf_types(tmp_path):
    """bf16 leaves are written as f32 and restored as bf16; numpy, dict and
    list leaves round-trip; the async writer snapshots at save()."""
    x = torch.randn(3, 5).to(torch.bfloat16)
    tree = {"a": x, "b": [np.arange(4, dtype=np.int16), torch.ones(2, 2)]}
    ckpt.save_checkpoint(str(tmp_path), 1, tree)
    meta = json.loads((tmp_path / "step_1" / "manifest.json").read_text())
    assert meta["paths"] == ["a", "b.0", "b.1"]
    assert meta["leaves"][0]["dtype"] == "bfloat16"
    assert np.load(tmp_path / "step_1" / "leaf_0.npy").dtype == np.float32
    got, _ = ckpt.restore_checkpoint(str(tmp_path), 1, tree)
    assert got["a"].dtype == torch.bfloat16 and torch.equal(got["a"], x)
    assert got["b"][0].dtype == np.int16 and \
        np.array_equal(got["b"][0], tree["b"][0])
    w = ckpt.AsyncCheckpointer(str(tmp_path))
    y = torch.zeros(4, dtype=torch.int32)
    w.save(2, (y,))
    y += 7                                   # after save(): not in step 2
    w.wait()
    (z,), _ = ckpt.restore_checkpoint(str(tmp_path), 2, (y,))
    assert int(z.sum()) == 0


# ---------------------------------------------------- the sweep layer

def test_sweep_chunk_len_matches_jax():
    """sweep(..., chunk_len=) and sweep_traces(..., chunk_len=) stream
    every group and stay bitwise equal to the monolithic dispatch and to
    the JAX package, with controllers in the grid."""
    a_p, a_j = ptr.app_params("mcf"), jtr.app_params("mcf")
    tr = _pressure_trace()
    grid = [("figcache_fast", "fcfs", 1), ("figcache_fast", "fcfs", 4),
            ("base", "frfcfs+drain", 1)]
    cfgs_p = [_cfg(m, s, insert_threshold=th) for m, s, th in grid]
    cfgs_j = [_cfg(m, s, jconfig, JSched, insert_threshold=th)
              for m, s, th in grid]
    mono = psim.sweep(tr, cfgs_p, (a_p,), device=CPU)
    got = psim.sweep(tr, cfgs_p, (a_p,), chunk_len=64, device=CPU)
    ref = jsim.sweep(_jax(tr), cfgs_j, (a_j,), chunk_len=64)
    for m, g, r in zip(mono, got, ref):
        _assert_counters_equal(m.counters, g.counters, "mono")
        assert np.array_equal(r.ipc, g.ipc) and \
            r.system_energy_nj == g.system_energy_nj
    two = [_random_trace(1, 200), _random_trace(2, 150)]
    res = psim.sweep_traces(two, cfgs_p, [(a_p,)] * 2, chunk_len=48,
                            device=CPU)
    for w, t in enumerate(two):
        for i, r in enumerate(psim.sweep(t, cfgs_p, (a_p,), device=CPU)):
            _assert_counters_equal(r.counters, res[w][i].counters, (w, i))


def test_telemetry_is_still_refused():
    """Telemetry streams now (tests/test_torch_obs.py); what the JAX
    package refuses stays refused: a collector without a telemetry
    config, and telemetry under wavefront execution, with a collector or
    without."""
    tr = _pressure_trace()
    cfg = paper_config("base", telemetry=32)
    with pytest.raises(ValueError, match="telemetry-enabled"):
        pst.simulate_stream(pst.iter_chunks(tr, 64), _cfg("base"),
                            device=CPU, telemetry=WindowCollector())
    with pytest.raises(ValueError, match="wavefront"):
        pst.simulate_stream(pst.iter_chunks(tr, 64), cfg, device=CPU,
                            telemetry=WindowCollector(), wavefront_exec=True)
    with pytest.raises(ValueError, match="wavefront"):
        pst.simulate_stream(pst.iter_chunks(tr, 64), cfg, device=CPU,
                            wavefront_exec=True)


# ---------------------------------------------------------------- the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device to launch the sim_scan kernel")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("sid", list(SCHEDS))
def test_cuda_stream_matches_cpu(cuda_device, sid):
    """On the card: one sim_scan launch per streamed segment, serial and
    wavefront; the codec decodes there; counters equal the CPU route."""
    tr = _two_channels(320)
    cfg = _cfg("figcache_fast", sid)
    want = pst.simulate_stream(pst.iter_chunks(tr, 64), cfg, device=CPU)
    # the scheduler re-packs the two channels' requests, which its windows
    # hold back by different amounts
    n_seg = len(list(pst.scheduled_segments(pst.iter_chunks(tr, 64),
                                            cfg.sched)))
    for wave in (False, True):
        before = scan.COUNTER.launches
        got = pst.simulate_stream(pst.iter_chunks(tr, 64), cfg,
                                  wavefront_exec=wave, device=cuda_device)
        assert scan.COUNTER.launches - before == n_seg
        _assert_counters_equal(want, got, (sid, wave))
    enc = [ptr.encode_trace(ppol.schedule(pd.Trace(*[x[c] for x in tr]),
                                          cfg.sched), chunk_len=64)
           for c in range(2)]
    fcfs = _cfg("figcache_fast")
    got = pst.simulate_stream(pst.decoded_segments(enc, cuda_device), fcfs,
                              device=cuda_device)
    _assert_counters_equal(want, got, (sid, "codec"))


@pytest.mark.cuda
def test_cuda_checkpoint_resume(cuda_device, tmp_path):
    tr = _pressure_trace()
    cfg = _cfg("figcache_fast", "frfcfs+drain")
    want = _mono(tr, cfg)
    pst.simulate_stream(pst.iter_chunks(tr, 32), cfg, device=cuda_device,
                        checkpoint_dir=str(tmp_path), checkpoint_every=3)
    got = pst.resume_stream(pst.iter_chunks(tr, 32), cfg, str(tmp_path),
                            device=cuda_device)
    assert got.t_end.is_cuda
    _assert_counters_equal(want, got, "resumed")
