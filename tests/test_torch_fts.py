"""The port's FTS transaction API (``repro_torch.core.fts``: lookup, touch,
should_insert, insert with and without ``recompute``, invalidate) against
the JAX package's ``repro.core.fts``.

Both packages replay the same seeded random transactions, lane by lane:
the JAX side vmaps one store per lane, the port carries the lanes as its
leading axis.  Every FTS leaf and every returned value is compared bitwise
after every transaction, over the four replacement policies, with padding
(``n_slots < max_slots``), out-of-order invalidations and an insertion
threshold.

The hypothesis properties of ``tests/test_fts.py`` (the store's
invariants under a random workload, per policy) and
``tests/test_padded_fts.py`` (a padded store equals an unpadded one) run
on the port, and each drawn sequence is also replayed through the JAX
package's store: every step's outcome and the final store equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

from repro.core import fts as jfts
from repro_torch.core import fts as tfts

LANES = 3
BMAX = 31
POLICIES = ("row_benefit", "segment_benefit", "lru", "random")
SLOTS, SPR = 16, 4            # 4 rows x 4 segments
MAX_SLOTS, MAX_SEGS = 48, 8   # tests/test_padded_fts.py's padded store


def _np(fts):
    return [np.asarray(x) for x in fts]


def _assert_fts_equal(jax_fts, port_fts, msg):
    for name, a, b in zip(tfts.FTS._fields, _np(jax_fts), port_fts):
        np.testing.assert_array_equal(a, b.numpy(), err_msg=f"{msg} {name}")


def _jax_tx(policy, recompute, spr, n_slots, thr):
    """One transaction per lane: lookup; a hit touches, a miss advances the
    tracker and inserts if the policy wants; then an optional invalidate."""
    def tx(f, seg, is_write, step, inv_slot, do_inv):
        hit, slot = jfts.lookup(f, seg)
        f_t = jfts.touch(f, slot, is_write, step, BMAX, spr)
        ok, f_s = jfts.should_insert(f, seg, thr)
        res = jfts.insert(f_s, seg, is_write, step, policy=policy,
                          segs_per_row=spr, n_slots=n_slots,
                          recompute=recompute)
        ins = ~hit & ok
        f2 = jax.tree.map(lambda a, b, c: jnp.where(hit, a, jnp.where(ins, b,
                                                                      c)),
                          f_t, res.fts, f_s)
        f3 = jfts.invalidate(f2, inv_slot, spr)
        f4 = jax.tree.map(lambda a, b: jnp.where(do_inv, a, b), f3, f2)
        return f4, (hit, slot, ok, res.slot, res.evicted_valid,
                    res.evicted_dirty, res.evicted_tag)
    return jax.jit(jax.vmap(tx))


def _port_tx(f, seg, is_write, step, inv_slot, do_inv, *, policy, recompute,
             spr, n_slots, thr):
    hit, slot = tfts.lookup(f, seg)
    f_t = tfts.touch(f, slot, is_write, step, BMAX, spr)
    ok, f_s = tfts.should_insert(f, seg, thr)
    res = tfts.insert(f_s, seg, is_write, step, policy=policy,
                      segs_per_row=spr, n_slots=n_slots, recompute=recompute)
    ins = ~hit & ok
    f2 = tfts.select(hit, f_t, tfts.select(ins, res.fts, f_s))
    f3 = tfts.invalidate(f2, inv_slot, spr)
    f4 = tfts.select(do_inv, f3, f2)
    return f4, (hit, slot, ok, res.slot, res.evicted_valid,
                res.evicted_dirty, res.evicted_tag)


@pytest.mark.parametrize("policy", ["row_benefit", "segment_benefit", "lru",
                                    "random"])
@pytest.mark.parametrize("recompute", [False, True])
@pytest.mark.parametrize("geom", [(16, 4, 4, 12, 1), (16, 4, 2, 16, 2)],
                         ids=["padded", "full-thr2"])
def test_transactions_match_jax(policy, recompute, geom):
    max_slots, max_segs, spr, n_slots, thr = geom
    rng = np.random.default_rng(sum(map(ord, policy)) * 10 + 2 * recompute
                                + geom[2])
    n_steps = 60
    segs = rng.integers(0, 3 * n_slots, (n_steps, LANES)).astype(np.int32)
    segs[rng.random((n_steps, LANES)) < 0.4] = 5       # a hot segment
    writes = rng.random((n_steps, LANES)) < 0.3
    inv_slot = rng.integers(0, n_slots, (n_steps, LANES)).astype(np.int32)
    do_inv = rng.random((n_steps, LANES)) < 0.15

    jtx = _jax_tx(policy, recompute, spr, n_slots, thr)
    j = jax.tree.map(lambda a: jnp.broadcast_to(a, (LANES,) + a.shape),
                     jfts.init(max_slots, max_segs, n_track=8))
    p = tfts.init_lanes(LANES, max_slots, max_segs, n_track=8, device="cpu")
    for t in range(n_steps):
        step = np.full(LANES, t, np.int32)
        j, jout = jtx(j, segs[t], writes[t], step, inv_slot[t], do_inv[t])
        p, pout = _port_tx(p, torch.from_numpy(segs[t]),
                           torch.from_numpy(writes[t]), torch.from_numpy(step),
                           torch.from_numpy(inv_slot[t]),
                           torch.from_numpy(do_inv[t]), policy=policy,
                           recompute=recompute, spr=spr, n_slots=n_slots,
                           thr=thr)
        for name, a, b in zip(("hit", "slot", "ok", "ins_slot", "ev_valid",
                               "ev_dirty", "ev_tag"), jout, pout):
            np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                          err_msg=f"step {t} {name}")
        _assert_fts_equal(j, p, f"step {t}")
    # the sequence really exercised eviction and invalidation
    assert int(p.n_valid.min()) > 0 and bool(do_inv.any())


def test_touch_counts_match_sequential_touches():
    """Repeated and zero-count entries (the embedding cache's batch of
    hits) equal the JAX package's one-by-one touches."""
    rng = np.random.default_rng(3)
    j = jfts.init(16, 4)
    j = j._replace(benefit=jnp.asarray(rng.integers(0, 30, 16), jnp.int32),
                   valid=jnp.ones(16, bool))
    j = j._replace(row_sum=jnp.asarray(
        np.asarray(j.benefit).reshape(4, 4).sum(1).tolist() + [0] * 12,
        jnp.int32))
    p = tfts.FTS(*[torch.from_numpy(np.array(x))[None] for x in j])
    slots = rng.integers(0, 16, 20).astype(np.int32)
    count = rng.integers(0, 3, 20).astype(np.int32)
    writes = rng.random(20) < 0.3
    for s, c, w in zip(slots, count, writes):
        for _ in range(c):
            j = jfts.touch(j, jnp.int32(s), jnp.bool_(w), jnp.int32(7), BMAX,
                           4)
    p = tfts.touch(p, torch.from_numpy(slots)[None],
                   torch.from_numpy(writes)[None], 7, BMAX, 4,
                   count=torch.from_numpy(count)[None])
    _assert_fts_equal(jax.tree.map(lambda a: a[None], j), p, "touch")


def test_lookup_many_ids_per_lane():
    """``lookup`` with (N, K) ids equals K vmapped JAX lookups per lane."""
    rng = np.random.default_rng(5)
    tags = rng.permutation(40)[:16].astype(np.int32)
    valid = rng.random(16) < 0.7
    one = jfts.init(16, 4)._replace(tags=jnp.asarray(tags),
                                   valid=jnp.asarray(valid))
    segs = rng.integers(0, 40, (2, 9)).astype(np.int32)
    p = tfts.FTS(*[torch.from_numpy(np.array(x)).expand(
        (2,) + x.shape).clone() for x in one])
    hit, slot = tfts.lookup(p, torch.from_numpy(segs))
    jh, js = jax.vmap(jax.vmap(jfts.lookup, (None, 0)), (None, 0))(
        one, jnp.asarray(segs))
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(slot.numpy(), np.asarray(js))


def test_gather_row_clips_like_jax():
    benefit = np.arange(12, dtype=np.int32)
    rows = np.array([0, 2, 5], np.int32)          # row 5 reads past the end
    got = tfts.gather_row(torch.from_numpy(np.tile(benefit, (3, 1))),
                          torch.from_numpy(rows), 4, 3)
    want = [np.asarray(jfts.gather_row(jnp.asarray(benefit), jnp.int32(r),
                                       4, 3)) for r in rows]
    np.testing.assert_array_equal(got.numpy(), np.stack(want))


# ---------------------------------------------------------------------------
# hypothesis properties (tests/test_fts.py, tests/test_padded_fts.py)

def _seg(s):
    return torch.tensor([s], dtype=torch.int32)


@settings(max_examples=25, deadline=None)
@given(st.lists(st.integers(0, 200), min_size=1, max_size=80),
       st.sampled_from(POLICIES))
def test_fts_invariants_under_random_workload_match_jax(segs, policy):
    """Valid tags stay unique, a lookup after an insert hits, benefit
    saturates at 31; each step's hit and slot, and the final store,
    equal the JAX package's on the same sequence."""
    j = jfts.init(SLOTS, SPR)
    p = tfts.init_lanes(1, SLOTS, SPR, device="cpu")
    for step, s in enumerate(segs):
        jhit, jslot = jfts.lookup(j, jnp.int32(s))
        hit, slot = tfts.lookup(p, _seg(s))
        assert (bool(hit[0]), int(slot[0])) == (bool(jhit), int(jslot)), step
        if bool(hit[0]):
            j = jfts.touch(j, jslot, jnp.bool_(False), jnp.int32(step), BMAX,
                           SPR)
            p = tfts.touch(p, slot, False, step, BMAX, SPR)
        else:
            j = jfts.insert(j, jnp.int32(s), jnp.bool_(False),
                            jnp.int32(step), policy=policy,
                            segs_per_row=SPR).fts
            p = tfts.insert(p, _seg(s), False, step, policy=policy,
                            segs_per_row=SPR).fts
            assert bool(tfts.lookup(p, _seg(s))[0][0])
    tags = p.tags[0][p.valid[0]].tolist()
    assert len(set(tags)) == len(tags)
    assert int(p.benefit.max()) <= BMAX
    _assert_fts_equal(jax.tree.map(lambda a: a[None], j), p, policy)


def _port_replay(segs, policy, max_slots, max_segs):
    """``tests/test_padded_fts.py``'s replay (threshold 1, ``SLOTS`` active
    slots of ``SPR`` a row) on the port -> (store, event log)."""
    p = tfts.init_lanes(1, max_slots, max_segs, device="cpu")
    log = []
    for step, s in enumerate(segs):
        hit, slot = tfts.lookup(p, _seg(s))
        if bool(hit[0]):
            p = tfts.touch(p, slot, step % 3 == 0, step, BMAX, SPR)
            log.append(("hit", int(slot[0])))
            continue
        want, p = tfts.should_insert(p, _seg(s), 1)
        if not bool(want[0]):
            log.append(("defer",))
            continue
        res = tfts.insert(p, _seg(s), False, step, policy=policy,
                          segs_per_row=SPR, n_slots=SLOTS)
        p = res.fts
        log.append(("ins", int(res.slot[0]), bool(res.evicted_valid[0]),
                    bool(res.evicted_dirty[0]), int(res.evicted_tag[0])))
    return p, log


def _jax_replay(segs, policy):
    """The same replay on the JAX package's padded store."""
    j = jfts.init(MAX_SLOTS, MAX_SEGS)
    log = []
    for step, s in enumerate(segs):
        hit, slot = jfts.lookup(j, jnp.int32(s))
        if bool(hit):
            j = jfts.touch(j, slot, jnp.bool_(step % 3 == 0),
                           jnp.int32(step), BMAX, SPR)
            log.append(("hit", int(slot)))
            continue
        want, j = jfts.should_insert(j, jnp.int32(s), 1)
        if not bool(want):
            log.append(("defer",))
            continue
        res = jfts.insert(j, jnp.int32(s), jnp.bool_(False), jnp.int32(step),
                          policy=policy, segs_per_row=SPR, n_slots=SLOTS)
        j = res.fts
        log.append(("ins", int(res.slot), bool(res.evicted_valid),
                    bool(res.evicted_dirty), int(res.evicted_tag)))
    return j, log


@settings(max_examples=10, deadline=None)
@given(st.lists(st.integers(0, 60), min_size=1, max_size=50),
       st.sampled_from(POLICIES))
def test_padded_fts_equivalence_property_matches_jax(segs, policy):
    """A padded port store (48 slots, 8 a row) equals an unpadded one of
    ``SLOTS`` on the same sequence: the same events, the same active
    slots and eviction state, the padding untouched; and the padded
    store equals the JAX package's padded store, event and leaf."""
    pad, log_pad = _port_replay(segs, policy, MAX_SLOTS, MAX_SEGS)
    ref, log_ref = _port_replay(segs, policy, SLOTS, SPR)
    jpad, jlog = _jax_replay(segs, policy)
    assert log_pad == log_ref == jlog
    for name in ("tags", "valid", "dirty", "benefit", "last_use"):
        a, r = getattr(pad, name)[0], getattr(ref, name)[0]
        assert torch.equal(a[:SLOTS], r), name
    assert not pad.valid[0, SLOTS:].any()
    assert (pad.tags[0, SLOTS:] == -1).all()
    assert int(pad.evict_row[0]) == int(ref.evict_row[0])
    assert torch.equal(pad.evict_mask[0, :SPR], ref.evict_mask[0])
    assert not pad.evict_mask[0, SPR:].any()
    _assert_fts_equal(jax.tree.map(lambda a: a[None], jpad), pad, policy)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device to launch the fts_lookup kernel")
    return torch.device("cuda")


@pytest.mark.cuda
def test_simulator_default_launches_lookup_kernel(cuda_device):
    """With the default config (``fts_kernel=False``) a cached replay on the
    card runs the lookup kernel on every step: inlined in the one sim_scan
    launch of the replay, and as the fts_lookup kernel once per step in
    the eager loop; both equal the CPU's counters."""
    from repro_torch.core import dram, timing
    from repro_torch.kernels.fts_lookup import fts_lookup as kernel
    from repro_torch.kernels.sim_scan import sim_scan
    idx = np.arange(64)
    tr = dram.Trace(t_issue=(idx * 16).astype(np.int32),
                    bank=(idx % 3).astype(np.int32),
                    row=((idx * 7) % 13).astype(np.int32),
                    col=((idx * 13) % 128).astype(np.int32),
                    is_write=idx % 5 == 0, core=(idx % 8).astype(np.int32))
    cfg = timing.paper_config("figcache_fast", cache_rows=2)
    assert not cfg.fts_kernel
    before = kernel.COUNTER.launches, sim_scan.COUNTER.launches
    got = dram.run_channel(tr, cfg, device=cuda_device)
    assert (kernel.COUNTER.launches - before[0],
            sim_scan.COUNTER.launches - before[1]) == (0, 1)
    before = kernel.COUNTER.launches
    state = dram._advance_eager(tr, cfg.static,
                                cfg.params(device=cuda_device),
                                dram.sim_init(cfg.static, device=cuda_device),
                                device=cuda_device)
    assert kernel.COUNTER.launches - before == 64
    want = dram.run_channel(tr, cfg, device="cpu")
    for a, b, c in zip(got, state.cnt, want):
        assert torch.equal(a.cpu(), c)
        assert torch.equal(b[0].cpu(), c)
