"""The FIGCache-KV decode step's transaction kernel (``kernels/figkv_tx``)
against its plain version and the JAX package.

On the CPU: the host build of the kernel's per-sequence code
(``csrc/figkv_tx.cuh`` with scalar scans, ``csrc/figkv_tx_host.cpp``)
against the plain version (``ref.figkv_tx_ref``) on every FTS leaf, the
slot map, the inserted segment and slot and both fast pools; the plain
version against the JAX package's ``_fts_step`` and its ``reloc_one``; and
the repair of a hit whose slot the same step's insert takes, end to end
through ``figkv_decode_step``.  On the card (``cuda``): the kernel against
the plain version, bitwise.

Selections are drawn with numpy from a skewed distribution, so that ids
recur (hits), stores of 16 slots fill within a few steps and then evict."""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import FIGKVConfig as JFIG
from repro.figkv import kv_cache as jkv
from repro_torch.configs import FIGKVConfig as TFIG
from repro_torch.core import fts as fts_lib
from repro_torch.figkv import kv_cache as tkv
from repro_torch.kernels.figkv_tx import figkv_tx as tx_kernel
from repro_torch.kernels.figkv_tx import ops, ref

POLICIES = tx_kernel.POLICIES
GEOM = dict(seg_tokens=8, fast_rows=4, segs_per_row=4)       # 16 slots
B, HKV, D = 3, 2, 8
N_SEGS = 24
# Policies whose victim can be a slot that the same step touched.  Under LRU
# it cannot: a touched slot carries the newest stamp, and a full store of
# 16 slots never has all of them touched in one step.
TAKES_HIT_SLOTS = {"row_benefit": True, "segment_benefit": True,
                   "lru": False, "random": True}


def _fig(cls, policy, **kw):
    return cls(**{**GEOM, **kw}, policy=policy)


def _selections(seed, steps, n_sel, n_segs=N_SEGS, b=B):
    """(steps, b, n_sel) int32: distinct ids a row, low ids far likelier
    (a Zipf-like weight), so that selections recur."""
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, n_segs + 1) ** 0.8
    keys = rng.gumbel(size=(steps, b, n_segs)) + np.log(w)
    return np.argsort(-keys, axis=-1, kind="stable")[..., :n_sel].astype(
        np.int32)


def _state(policy, seed, dtype=torch.float32, b=B, **kw):
    """A port FIGCache-KV state with random slow pools of N_SEGS segments
    and an empty tag store."""
    fig = _fig(TFIG, policy, **kw)
    st = tkv.figkv_init(b, N_SEGS * fig.seg_tokens, HKV, D, fig, dtype=dtype,
                        device="cpu")
    g = torch.Generator().manual_seed(seed)
    st.pool_k.copy_(torch.randn(st.pool_k.shape, generator=g))
    st.pool_v.copy_(torch.randn(st.pool_v.shape, generator=g))
    return st, fig


def _views(st, fig):
    n, t = N_SEGS, fig.seg_tokens
    shape = (st.pool_k.shape[0], n, t) + tuple(st.pool_k.shape[2:])
    return (st.pool_k[:, :n * t].view(shape), st.pool_v[:, :n * t].view(shape),
            st.fast_k, st.fast_v)


def _clone(st):
    return st._replace(fast_k=st.fast_k.clone(), fast_v=st.fast_v.clone(),
                       fts=fts_lib.FTS(*[x.clone() for x in st.fts]))


def _taken(fts_before, sel, ins_slot):
    """(B, n_sel): the selected ids that hit before the step at the slot
    the step's insert took (the entries the repair sends to the slow
    pool)."""
    hits, slots = fts_lib.lookup(fts_before, sel)
    return hits & (slots == ins_slot[:, None])


def _assert_equal(a, b, ctx):
    for name, x, y in zip(a.fts._fields, a.fts, b.fts):
        assert torch.equal(x, y), f"{ctx}: fts.{name}"
    for name in ("fast_k", "fast_v"):
        assert torch.equal(getattr(a, name), getattr(b, name)), \
            f"{ctx}: {name}"


@pytest.fixture(scope="module")
def host_build():
    """The host library, built once (skips where no C++ compiler is)."""
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler (g++) to build "
                    "csrc/figkv_tx_host.cpp")
    return tx_kernel.host_library()


@pytest.mark.parametrize("policy,fast_rows", [(p, 4) for p in POLICIES] + [
    ("random", 3), ("row_benefit", 3)],
    ids=list(POLICIES) + ["random-12-slots", "row_benefit-12-slots"])
def test_host_build_matches_plain(host_build, policy, fast_rows):
    """48 steps over 16 slots (12: a slot count that is no power of two,
    where the Random hash's high bits count), some selected ids not yet
    insertable (n_live below them): the host build equals the plain version
    on every FTS leaf, both fast pools, the slot map and the inserted
    segment and slot."""
    st, fig = _state(policy, seed=1, fast_rows=fast_rows)
    slots = fast_rows * GEOM["segs_per_row"]
    sels = _selections(2, 48, 6)
    taken = evictions = 0
    for t, s in enumerate(sels):
        sel = torch.from_numpy(s)
        n_live = N_SEGS - t % 4
        host = _clone(st)
        before = fts_lib.FTS(*[x.clone() for x in st.fts])
        got = tx_kernel.host_tx(sel, t, n_live, host.fts,
                                *[ops.as_rows(x) for x in
                                  _views(host, fig)], fig)
        want = ops.figkv_tx(sel, t, n_live, st.fts, *_views(st, fig), fig)
        for name, x, y in zip(("slots", "ins_seg", "ins_slot"), got, want):
            assert torch.equal(x, y), f"step {t}: {name}"
        _assert_equal(host, st, f"step {t}")
        full = before.n_valid == before.tags.shape[-1]
        evictions += int((full & (want[2] >= 0)).sum())
        taken += int(_taken(before, sel, want[2]).sum())
        assert not bool((want[1] >= n_live).any())
    assert bool((st.fts.n_valid == slots).all()) and evictions > 0
    assert (taken > 0) == TAKES_HIT_SLOTS[policy], f"{taken} hit slots taken"


def _jax_tx(jfig):
    """The JAX package's transaction (``_fts_step``, vmapped) and
    relocation (``reloc_one``, as written in its ``figkv_decode_step``)."""
    st = jfig.seg_tokens

    def reloc_one(fk, fv, pk, pv, seg, slot):
        kseg, vseg = jkv._gather_segment(pk, pv, jnp.maximum(seg, 0), st)
        ok = (seg >= 0) & (slot >= 0)
        sl = jnp.where(ok, slot, 0)
        fk = fk.at[sl].set(jnp.where(ok, kseg, fk[sl]))
        fv = fv.at[sl].set(jnp.where(ok, vseg, fv[sl]))
        return fk, fv

    def tx(fts, fk, fv, pk, pv, sel, step):
        fts, slots, ins_seg, ins_slot = jax.vmap(
            lambda f, s: jkv._fts_step(f, s, step, jfig))(fts, sel)
        fk, fv = jax.vmap(reloc_one)(fk, fv, pk, pv, ins_seg, ins_slot)
        return fts, fk, fv, slots, ins_seg, ins_slot

    return jax.jit(tx)


@pytest.mark.parametrize("policy", POLICIES)
def test_plain_matches_jax_transaction(policy):
    """48 steps, every selected id live: the plain version equals the JAX
    package's transaction and relocation on every FTS leaf and fast pool,
    the inserted segment and slot, and the slot map except the entries the
    repair sends to the slow pool (JAX keeps their taken slot)."""
    st, fig = _state(policy, seed=3)
    jfig = _fig(JFIG, policy)
    js = jkv.figkv_init(B, N_SEGS * fig.seg_tokens, HKV, D, jfig,
                        dtype=jnp.float32)
    jfts, jfk, jfv = js.fts, js.fast_k, js.fast_v
    pk, pv = jnp.asarray(st.pool_k.numpy()), jnp.asarray(st.pool_v.numpy())
    tx = _jax_tx(jfig)
    repaired = 0
    for t, s in enumerate(_selections(4, 48, 5)):
        sel = torch.from_numpy(s)
        before = fts_lib.FTS(*[x.clone() for x in st.fts])
        slots, ins_seg, ins_slot = ops.figkv_tx(sel, t, N_SEGS, st.fts,
                                                *_views(st, fig), fig)
        jfts, jfk, jfv, jslots, jseg, jslot = tx(
            jfts, jfk, jfv, pk, pv, jnp.asarray(s), jnp.int32(t))
        for name, x, y in zip(st.fts._fields, st.fts, jfts):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y),
                                          err_msg=f"step {t} fts.{name}")
        np.testing.assert_array_equal(st.fast_k.numpy(), np.asarray(jfk))
        np.testing.assert_array_equal(st.fast_v.numpy(), np.asarray(jfv))
        np.testing.assert_array_equal(ins_seg.numpy(), np.asarray(jseg))
        np.testing.assert_array_equal(ins_slot.numpy(), np.asarray(jslot))
        taken = _taken(before, sel, ins_slot)
        np.testing.assert_array_equal(
            slots.numpy(), np.where(taken.numpy(), -1, np.asarray(jslots)),
            err_msg=f"step {t} slots")
        repaired += int(taken.sum())
    assert (repaired > 0) == TAKES_HIT_SLOTS[policy], \
        f"{repaired} slot map entries repaired"


def _plain_step(q, K, V, sel, pos, recent, smax, st):
    """What a decode step at ``pos`` attends, recomputed from the whole
    K/V (B, pos+1, Hkv, D): the selected segments' tokens before the
    recent window and the window's tokens up to ``pos``, exact f32."""
    start = min(max(pos + 1 - recent, 0), smax - recent)
    tok = torch.arange(pos + 1)
    in_sel = ((tok // st)[None, None] == sel.long()[..., None]).any(dim=1)
    valid = (in_sel & (tok < start)) | (tok >= start)
    rep = q.shape[2] // K.shape[2]
    return tkv._masked_attend(q, K.repeat_interleave(rep, dim=2),
                              V.repeat_interleave(rep, dim=2), valid)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
def test_same_step_eviction_reads_the_slow_pool(dtype, tol):
    """A fast pool of 2 slots and 3 selected segments: the insert often
    evicts a slot that another selected segment hit in the same step.  The
    test asserts such steps occur; at every step the port's output equals
    exact attention over its own selection, where the JAX package's (the
    same state and selection until then) is off by far more."""
    fig = TFIG(seg_tokens=8, fast_rows=1, segs_per_row=2)
    jfig = JFIG(seg_tokens=8, fast_rows=1, segs_per_row=2)
    H, S0, smax, steps, n_sel, recent = 4, 64, 128, 40, 3, 16
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    rng = np.random.default_rng(11)
    k0, v0 = (rng.normal(size=(B, S0, HKV, D)) for _ in range(2))
    qs = rng.normal(size=(steps, B, 1, H, D))
    ks, vs = (rng.normal(size=(steps, B, 1, HKV, D)) for _ in range(2))

    def t(x):
        return torch.from_numpy(np.asarray(x, np.float32)).to(dtype)

    ts = tkv.figkv_prefill(tkv.figkv_init(B, smax, HKV, D, fig, dtype=dtype,
                                          device="cpu"), t(k0), t(v0))
    js = jkv.figkv_prefill(jkv.figkv_init(B, smax, HKV, D, jfig, dtype=jdt),
                           jnp.asarray(k0, jdt), jnp.asarray(v0, jdt))
    jstep = jax.jit(lambda s, q, k, v: jkv.figkv_decode_step(
        s, q, k, v, jfig, n_sel=n_sel, recent=recent))
    K, V = [t(k0)], [t(v0)]
    repaired_steps, jax_err = [], 0.0
    for i in range(steps):
        pos = ts.length
        q = t(qs[i])
        K.append(t(ks[i]))
        V.append(t(vs[i]))
        before = fts_lib.FTS(*[x.clone() for x in ts.fts])
        ts, out = tkv.figkv_decode_step(ts, q, t(ks[i]), t(vs[i]), fig,
                                        n_sel=n_sel, recent=recent)
        js, jout = jstep(js, jnp.asarray(qs[i], jdt), jnp.asarray(ks[i], jdt),
                         jnp.asarray(vs[i], jdt))
        for name, x, y in zip(ts.fts._fields, ts.fts, js.fts):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y),
                                          err_msg=f"step {i} fts.{name}")
        sel = tkv._select_segments(q, ts.seg_key, (pos + 1) // 8, n_sel)
        plain = _plain_step(q, torch.cat(K, 1), torch.cat(V, 1), sel, pos,
                            recent, smax, 8)
        np.testing.assert_allclose(out.float().numpy(), plain.float().numpy(),
                                   atol=tol, err_msg=f"step {i} output")
        hits, slots = fts_lib.lookup(before, sel)
        now = ts.fts.tags.gather(1, slots.long())
        if bool((hits & (now != sel)).any()):
            repaired_steps.append(i)
            jax_err = max(jax_err, float(np.abs(
                np.asarray(jout, np.float32) - plain.float().numpy()).max()))
    print(f"repaired steps {repaired_steps}; JAX output off by {jax_err:.3g}")
    assert len(repaired_steps) >= 3
    assert jax_err > 10 * max(tol, 2e-2)


def test_figkv_tx_refuses_what_the_kernel_does_not_take():
    """``pack`` checks the layout the kernel needs, on any device."""
    st, fig = _state("row_benefit", seed=0)
    rows = [ops.as_rows(x) for x in _views(st, fig)]
    sel = torch.zeros((B, 2), dtype=torch.int32)
    cpu = torch.device("cpu")
    tx_kernel.pack(sel, 0, 4, st.fts, *rows, fig, cpu)
    with pytest.raises(ValueError, match="sel"):
        tx_kernel.pack(sel.long(), 0, 4, st.fts, *rows, fig, cpu)
    with pytest.raises(ValueError, match="at most"):
        tx_kernel.pack(torch.zeros((B, 300), dtype=torch.int32), 0, 4,
                       st.fts, *rows, fig, cpu)
    with pytest.raises(ValueError, match="fts.row_sum"):
        tx_kernel.pack(sel, 0, 4, st.fts._replace(
            row_sum=st.fts.row_sum.t().contiguous().t()[:, :8]), *rows, fig,
            cpu)
    with pytest.raises(ValueError, match="whole rows"):
        tx_kernel.pack(sel, 0, 4, st.fts, *rows,
                       _fig(TFIG, "lru", segs_per_row=3), cpu)
    with pytest.raises(ValueError, match="policy"):
        tx_kernel.pack(sel, 0, 4, st.fts, *rows, _fig(TFIG, "fifo"), cpu)
    with pytest.raises(ValueError, match="do not match"):
        tx_kernel.pack(sel, 0, 4, st.fts, *rows[:2], rows[2][:, :8],
                       rows[3], fig, cpu)
    with pytest.raises(ValueError, match="CUDA"):
        tx_kernel.figkv_tx(sel, 0, 4, st.fts, *rows, fig)


# ---------------------------------------------------------------- the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device to launch the figkv_tx kernel")
    return torch.device("cuda")


def _run_on_card(dev, policy, steps, dtype, b=4, n_sel=6, pad=0, seg_tokens=8,
                 hkv=HKV, d=D):
    """``steps`` steps of the kernel and of the plain version, side by
    side on the card from the same state, compared bitwise after each;
    ``pad`` extra elements between segments make the slow pools' rows
    unaligned.  Returns the repaired entries seen."""
    fig = TFIG(seg_tokens=seg_tokens, fast_rows=4, segs_per_row=4,
               policy=policy)
    st = tkv.figkv_init(b, N_SEGS * seg_tokens, hkv, d, fig, dtype=dtype,
                        device=dev)
    e = seg_tokens * hkv * d
    g = torch.Generator(device=dev).manual_seed(5)
    flat_k = torch.randn((b, N_SEGS, e + pad), generator=g, device=dev).to(
        dtype)
    flat_v = torch.randn((b, N_SEGS, e + pad), generator=g, device=dev).to(
        dtype)
    pools = (flat_k[..., :e], flat_v[..., :e])
    plain = _clone(st)
    taken = 0
    for t, s in enumerate(_selections(6, steps, n_sel, b=b)):
        sel = torch.from_numpy(s).to(dev)
        before = fts_lib.FTS(*[x.clone() for x in st.fts])
        got = tx_kernel.figkv_tx(sel, t, N_SEGS - t % 3, st.fts, *pools,
                                 ops.as_rows(st.fast_k),
                                 ops.as_rows(st.fast_v), fig)
        want = ref.figkv_tx_ref(sel, t, N_SEGS - t % 3, plain.fts, *pools,
                                ops.as_rows(plain.fast_k),
                                ops.as_rows(plain.fast_v), fig)
        torch.cuda.synchronize()
        for name, x, y in zip(("slots", "ins_seg", "ins_slot"), got, want):
            assert torch.equal(x, y), f"step {t}: {name}"
        _assert_equal(st, plain, f"{policy} step {t}")
        taken += int(_taken(before, sel, want[2]).sum())
    return taken


@pytest.mark.cuda
@pytest.mark.parametrize("policy", POLICIES)
def test_cuda_kernel_matches_plain(cuda_device, policy):
    taken = _run_on_card(cuda_device, policy, 40, torch.bfloat16)
    assert (taken > 0) == TAKES_HIT_SLOTS[policy]


@pytest.mark.cuda
def test_cuda_kernel_unaligned_payload(cuda_device):
    """Rows of 3 x 1 x 5 bf16 (30 bytes) at a padded stride: the kernel's
    global-to-global path."""
    _run_on_card(cuda_device, "row_benefit", 24, torch.bfloat16, pad=1,
                 seg_tokens=3, hkv=1, d=5)


@pytest.mark.cuda
def test_cuda_kernel_ring_of_chunks(cuda_device):
    """Rows of 40 KiB + 128 bytes (f32): three chunks a row through the
    two-buffer ring."""
    _run_on_card(cuda_device, "lru", 20, torch.float32, seg_tokens=8,
                 hkv=4, d=321)
