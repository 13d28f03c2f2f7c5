"""The port's FIGCache-KV path (``repro_torch.figkv``, ``launch/serve.py``,
``convert.py``) against the JAX package's ``repro.figkv``.

The same numpy inputs drive both packages' ``figkv_init`` / ``figkv_prefill``
/ ``figkv_decode_step`` (and ``embed_cache_lookup``).  After every step the
selections, every FTS leaf, the slow and fast pools must be bitwise equal;
the attention outputs agree to f32 atol 1e-5 / bf16 atol 2e-2 (summation
order, and one bf16 rounding).  Segment scores are f32 sums of D-wide dot
products in both packages; the cases are seeded so that no two live
segments tie to within rounding."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs
from repro.configs import FIGKVConfig as JFIG
from repro.figkv import embed_cache as jembed
from repro.figkv import kv_cache as jkv
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.configs import FIGKVConfig as TFIG
from repro_torch.core import fts as fts_lib
from repro_torch.figkv import embed_cache as tembed
from repro_torch.figkv import kv_cache as tkv
from repro_torch.launch import serve

FIG = dict(seg_tokens=8, fast_rows=4, segs_per_row=4)
B, H, HKV, D = 2, 8, 4, 16
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(seed, S0, steps):
    rng = np.random.default_rng(seed)
    n = rng.normal
    return (n(size=(B, S0, HKV, D)), n(size=(B, S0, HKV, D)),
            n(size=(steps, B, 1, H, D)), n(size=(steps, B, 1, HKV, D)),
            n(size=(steps, B, 1, HKV, D)))


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x, np.float32)


def _t(x, tdt):
    return torch.from_numpy(np.array(x, np.float32)).to(tdt)


def _assert_state_equal(js, ts, msg):
    for name in ("pool_k", "pool_v", "fast_k", "fast_v"):
        np.testing.assert_array_equal(_f32(getattr(js, name)),
                                      _f32(getattr(ts, name)),
                                      err_msg=f"{msg} {name}")
    for name, a, b in zip(ts.fts._fields, js.fts, ts.fts):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                      err_msg=f"{msg} fts.{name}")
    np.testing.assert_allclose(_f32(js.seg_key), _f32(ts.seg_key), rtol=1e-6,
                               atol=1e-5, err_msg=f"{msg} seg_key")
    assert int(js.length) == ts.length


def _plain_step(q, K, V, sel, pos, recent, smax):
    """What a decode step at ``pos`` attends, recomputed from the whole
    K/V (B, pos+1, Hkv, D) instead of the pools: the tokens of the
    selected segments ``sel`` (B, n_sel) before the recent window, and the
    window's tokens up to ``pos``, in exact f32 attention."""
    st = FIG["seg_tokens"]
    start = min(max(pos + 1 - recent, 0), smax - recent)
    tok = torch.arange(pos + 1)
    in_sel = ((tok // st)[None, None] == sel.long()[..., None]).any(dim=1)
    valid = (in_sel & (tok < start)) | (tok >= start)
    kr = K.repeat_interleave(H // HKV, dim=2)
    vr = V.repeat_interleave(H // HKV, dim=2)
    return tkv._masked_attend(q, kr, vr, valid)


def _run_both(dtype, S0, smax, steps, n_sel, recent, seed, handover=None):
    """Decode ``steps`` steps in both packages; with ``handover=t`` the port
    starts from the JAX state converted after step t (and the JAX run goes
    on alone until then).  Returns the port's state, the number of steps
    whose state was compared with the JAX package, the number whose
    selections were and the number whose outputs were.

    With fewer complete segments than ``n_sel`` the JAX package caches the
    dead ids that pad the selection, and the port does not: from the first
    step at which the reference holds such an id on, only the selections
    are held against it.  When a step's insert takes the slot of a segment
    the same step selected and hit, the port reads that segment from the
    slow pool and the JAX package reads the inserted segment's copy: from
    the first such step on, the outputs are no longer held against the
    reference (the state still is).  Every step the port caches no
    incomplete segment, and its output is held against ``_plain_step`` over
    its own selection (the same tolerance)."""
    jdt, tdt, tol = DTYPES[dtype]
    jfig, tfig = JFIG(**FIG), TFIG(**FIG)
    k0, v0, qs, ks, vs = _inputs(seed, S0, steps)
    js = jkv.figkv_prefill(jkv.figkv_init(B, smax, HKV, D, jfig, dtype=jdt),
                           jnp.asarray(k0, jdt), jnp.asarray(v0, jdt))
    ts = tkv.figkv_prefill(tkv.figkv_init(B, smax, HKV, D, tfig, dtype=tdt,
                                          device="cpu"),
                           _t(k0, tdt), _t(v0, tdt))
    step = jax.jit(lambda s, q, k, v: jkv.figkv_decode_step(
        s, q, k, v, jfig, n_sel=n_sel, recent=recent))
    jsel = jax.jit(jkv._select_segments, static_argnums=3)
    compared = selections = outputs = 0
    dead_insert = repaired = False
    K, V = [_t(k0, tdt)], [_t(v0, tdt)]
    for t in range(steps):
        pos = int(js.length)
        K.append(_t(ks[t], tdt))
        V.append(_t(vs[t], tdt))
        if handover is not None and t <= handover:
            js, _ = step(js, jnp.asarray(qs[t], jdt), jnp.asarray(ks[t], jdt),
                         jnp.asarray(vs[t], jdt))
            if t == handover:
                ts = convert.figkv_state_from_numpy(
                    [np.asarray(x) for x in jax.tree.leaves(js)],
                    device="cpu")
                _assert_state_equal(js, ts, "handover")
            continue
        js, jout = step(js, jnp.asarray(qs[t], jdt), jnp.asarray(ks[t], jdt),
                        jnp.asarray(vs[t], jdt))
        q = _t(qs[t], tdt)
        before = (ts.fts.tags.clone(), ts.fts.valid.clone())
        ts, tout = tkv.figkv_decode_step(ts, q, _t(ks[t], tdt),
                                         _t(vs[t], tdt), tfig, n_sel=n_sel,
                                         recent=recent)
        n_live = (pos + 1) // FIG["seg_tokens"]
        sel = tkv._select_segments(q, ts.seg_key, n_live, n_sel)
        np.testing.assert_array_equal(
            np.asarray(jsel(jnp.asarray(qs[t], jdt), js.seg_key,
                            jnp.int32(n_live), n_sel)), sel.numpy(),
            err_msg=f"step {t} selection")
        selections += 1
        assert not bool((ts.fts.valid & (ts.fts.tags >= n_live)).any()), \
            f"step {t}: the port cached an incomplete segment"
        assert tout.dtype == tdt and tout.shape == (B, 1, H, D)
        plain = _plain_step(q, torch.cat(K, 1), torch.cat(V, 1), sel, pos,
                            recent, smax)
        np.testing.assert_allclose(_f32(tout), _f32(plain), atol=tol,
                                   err_msg=f"step {t} output vs recomputed")
        dead_insert |= bool((np.asarray(js.fts.valid)
                             & (np.asarray(js.fts.tags) >= n_live)).any())
        # a selected id that hit before the step and whose slot now holds
        # another segment: the step's insert took it
        hits, slot = fts_lib.lookup(ts.fts._replace(tags=before[0],
                                                    valid=before[1]), sel)
        repaired |= bool((hits & (ts.fts.tags.gather(1, slot.long()) != sel))
                         .any())
        if dead_insert:
            continue
        _assert_state_equal(js, ts, f"step {t}")
        compared += 1
        if repaired:
            continue
        np.testing.assert_allclose(_f32(tout), _f32(jout), atol=tol,
                                   err_msg=f"step {t} output")
        outputs += 1
    return ts, compared, selections, outputs


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("S0,smax,steps,n_sel", [
    (160, 200, 24, 4),      # 20 live segments > 16 slots: RowBenefit evicts
    (160, 220, 56, 4),      # ... long enough to take a hit segment's slot
    (9, 100, 10, 6),        # n_live < n_sel: dead ids tie at -inf
    (21, 61, 12, 5),        # s_max and prompt not multiples of seg_tokens
], ids=["evicting", "evicting-long", "short-prompt", "ragged"])
def test_decode_steps_match_jax(dtype, S0, smax, steps, n_sel):
    ts, compared, selections, outputs = _run_both(
        dtype, S0, smax, steps, n_sel, recent=16, seed=S0 + smax)
    assert selections == steps
    print(f"state compared on {compared}, output on {outputs} of {steps} "
          "steps")
    if S0 == 160:
        assert compared == steps
        if steps > 24:      # a step's insert took a hit segment's slot
            assert 1 <= outputs < steps
        else:
            assert outputs == steps
    else:                   # the reference caches a dead id from a step on
        assert 1 <= compared < steps and outputs == compared
    assert int(ts.fts.valid.sum()) > 0
    if S0 == 160:                       # the pool filled and RowBenefit ran
        assert bool((ts.fts.evict_row >= 0).all())


def test_short_prompt_selects_dead_ids_lowest_first():
    """With fewer live segments than n_sel, the -inf ties are ranked by id,
    as ``jax.lax.top_k`` ranks them."""
    seg_key = torch.randn(1, 10, HKV, D, generator=torch.Generator()
                          .manual_seed(0))
    q = torch.randn(1, 1, H, D, generator=torch.Generator().manual_seed(1))
    got = tkv._select_segments(q, seg_key, 2, 6)
    want = jkv._select_segments(jnp.asarray(q.numpy()),
                                jnp.asarray(seg_key.numpy()), 2, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[0, 2:].tolist() == [2, 3, 4, 5]


def test_handover_from_jax_midway():
    """A decode started in the JAX package continues in the port."""
    _, compared, _, outputs = _run_both("bf16", 160, 200, 14, 4, recent=16,
                                        seed=5, handover=6)
    assert compared == outputs == 7


def test_full_coverage_equals_exact_attention():
    """n_sel covering every segment is exact attention (tests/test_figkv.py,
    in the port): the step equals ``_masked_attend`` over the whole prefix."""
    S0, smax, fig = 64, 128, TFIG(**FIG)
    k0, v0, qs, ks, vs = _inputs(0, S0, 6)
    st = tkv.figkv_prefill(tkv.figkv_init(B, smax, HKV, D, fig,
                                          dtype=torch.float32, device="cpu"),
                           _t(k0, torch.float32), _t(v0, torch.float32))
    K, V = [_t(k0, torch.float32)], [_t(v0, torch.float32)]
    for t in range(6):
        q, kn, vn = (_t(x[t], torch.float32) for x in (qs, ks, vs))
        st, out = tkv.figkv_decode_step(st, q, kn, vn, fig,
                                        n_sel=smax // fig.seg_tokens,
                                        recent=16)
        K.append(kn)
        V.append(vn)
        kr = torch.cat(K, 1).repeat_interleave(H // HKV, dim=2)
        vr = torch.cat(V, 1).repeat_interleave(H // HKV, dim=2)
        exact = tkv._masked_attend(q, kr, vr, torch.ones(B, kr.shape[1],
                                                         dtype=torch.bool))
        torch.testing.assert_close(out, exact, atol=1e-5, rtol=0)


def test_full_coverage_stays_exact_past_short_selections():
    """The full-coverage setup decoded for 48 steps: the selection is padded
    with dead ids for every step (8-14 complete segments of 16), which the
    port never caches, so the step stays exact attention.  (The JAX
    package caches them and drifts up to ~0.6 from exact from step ~26.)"""
    S0, smax, fig, steps = 64, 128, TFIG(**FIG), 48
    k0, v0, qs, ks, vs = _inputs(0, S0, steps)
    st = tkv.figkv_prefill(tkv.figkv_init(B, smax, HKV, D, fig,
                                          dtype=torch.float32, device="cpu"),
                           _t(k0, torch.float32), _t(v0, torch.float32))
    K, V = [_t(k0, torch.float32)], [_t(v0, torch.float32)]
    for t in range(steps):
        q, kn, vn = (_t(x[t], torch.float32) for x in (qs, ks, vs))
        st, out = tkv.figkv_decode_step(st, q, kn, vn, fig,
                                        n_sel=smax // fig.seg_tokens,
                                        recent=16)
        K.append(kn)
        V.append(vn)
        kr = torch.cat(K, 1).repeat_interleave(H // HKV, dim=2)
        vr = torch.cat(V, 1).repeat_interleave(H // HKV, dim=2)
        exact = tkv._masked_attend(q, kr, vr, torch.ones(B, kr.shape[1],
                                                         dtype=torch.bool))
        torch.testing.assert_close(out, exact, atol=2e-2, rtol=0,
                                   msg=f"step {t}")
        n_live = st.length // fig.seg_tokens
        assert not bool((st.fts.valid & (st.fts.tags >= n_live)).any())
    assert int(st.fts.valid.sum()) > 0


def _embed_both(V, d, steps, T, seed, hand_over_at=None):
    jfig, tfig = JFIG(**FIG), TFIG(**FIG)
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(V, d)).astype(np.float32)
    jt, tt = jnp.asarray(table), torch.from_numpy(table)
    jc = jembed.embed_cache_init(d, jfig, dtype=jnp.float32)
    tc = tembed.embed_cache_init(d, tfig, dtype=torch.float32, device="cpu")
    look = jax.jit(lambda c, t, s: jembed.embed_cache_lookup(c, jt, t, jfig,
                                                             s))
    for step in range(steps):
        toks = (rng.zipf(1.3, T) - 1) % V                # hot low ids
        jc, jout = look(jc, jnp.asarray(toks, jnp.int32), step)
        if hand_over_at is not None and step < hand_over_at:
            continue
        if step == hand_over_at:
            tc = convert.embed_cache_from_numpy(
                [np.asarray(x) for x in jax.tree.leaves(jc)], device="cpu")
        else:
            tc, tout = tembed.embed_cache_lookup(
                tc, tt, torch.from_numpy(toks.astype(np.int32)), tfig, step)
            np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
            np.testing.assert_array_equal(tout.numpy(), table[toks])
        np.testing.assert_array_equal(tc.fast.numpy(), np.asarray(jc.fast))
        for name, a, b in zip(tc.fts._fields, jc.fts, tc.fts):
            np.testing.assert_array_equal(np.asarray(a), b[0].numpy(),
                                          err_msg=f"step {step} {name}")
        assert int(tc.hits) == int(jc.hits)
        assert int(tc.lookups) == int(jc.lookups)
    return tc


@pytest.mark.parametrize("T", [16, 80], ids=["T16", "T80-touch-bound"])
def test_embed_cache_matches_jax(T):
    tc = _embed_both(512, 32, 12, T, seed=T)
    assert int(tc.hits) > 0


def test_embed_cache_handover_from_jax():
    tc = _embed_both(512, 32, 10, 16, seed=1, hand_over_at=4)
    assert int(tc.hits) > 0


def test_embed_cache_ragged_vocabulary_raises():
    """V % seg_tokens != 0 (whisper-tiny's 51865) is refused: the JAX
    package's clamped slice would serve a wrong row from the last segment."""
    fig = TFIG(**FIG)
    cache = tembed.embed_cache_init(4, fig, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="multiple of seg_tokens"):
        tembed.embed_cache_lookup(cache, torch.zeros(515, 4),
                                  torch.tensor([1, 2]), fig, 0)


def test_configs_are_a_copy_of_the_jax_package():
    for arch in jconfigs.list_archs():
        for get in ("get", "get_reduced"):
            a = getattr(jconfigs, get)(arch)
            b = getattr(tconfigs, get)(arch)
            assert dataclasses.asdict(a) == dataclasses.asdict(b), arch
            assert (a.hd, a.attn_free, a.subquadratic, a.n_params()) == \
                (b.hd, b.attn_free, b.subquadratic, b.n_params())
    assert tconfigs.get("qwen2-7b").figkv == TFIG()


def test_demo_figkv_runs_on_cpu():
    """``demo_figkv`` at a reduced Qwen2-7B width on the CPU: shapes, finite
    outputs, a warm fast pool and the relocated copies equal to the pool."""
    cfg = tconfigs.get_reduced("qwen2-7b")
    run = serve.demo_figkv(cfg, torch.Generator().manual_seed(0),
                           prompt_len=32, gen=12, batch=2, device="cpu")
    fig = cfg.figkv
    assert run.out.shape == (12, 2, 1, cfg.n_heads, cfg.hd)
    assert torch.isfinite(run.out.float()).all() and run.warm > 0
    assert run.state.length == 44 and run.timings["decode_s"] > 0
    st = run.state
    for b in range(2):
        for slot in torch.nonzero(st.fts.valid[b]).flatten().tolist():
            seg = int(st.fts.tags[b, slot])
            if (seg + 1) * fig.seg_tokens <= st.length - 1:   # complete
                assert torch.equal(st.fast_k[b, slot], st.pool_k[
                    b, seg * fig.seg_tokens:(seg + 1) * fig.seg_tokens])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device to launch the figkv kernels")
    return torch.device("cuda")


@pytest.mark.cuda
def test_demo_figkv_launches_both_kernels(cuda_device):
    """One figkv_tx (transaction and both moves) and one figcache_decode
    launch a step; figaro_reloc no more on this path."""
    from repro_torch.kernels.figaro_reloc import figaro_reloc
    from repro_torch.kernels.figcache_decode import figcache_decode
    from repro_torch.kernels.figkv_tx import figkv_tx
    cfg = tconfigs.get_reduced("qwen2-7b")
    r0, d0, t0 = (figaro_reloc.COUNTER.launches,
                  figcache_decode.COUNTER.launches, figkv_tx.COUNTER.launches)
    run = serve.demo_figkv(cfg, torch.Generator(cuda_device).manual_seed(0),
                           prompt_len=64, gen=8, batch=2, device=cuda_device)
    assert figcache_decode.COUNTER.launches - d0 == 8
    assert figkv_tx.COUNTER.launches - t0 == 8
    assert figaro_reloc.COUNTER.launches - r0 == 0
    assert torch.isfinite(run.out.float()).all()
