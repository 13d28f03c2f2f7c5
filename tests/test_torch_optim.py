"""The port's optimizer, LR schedule, gradient compression, data pipeline
and cross-entropy (``repro_torch.optim``, ``repro_torch.data``,
``models.layers.cross_entropy`` / ``chunked_ce``) against the JAX
package's, on the same numpy-seeded inputs, plus the ports of
``tests/test_infra.py``'s optimizer and pipeline tests.

The JAX side runs op by op (no ``jit``), as the reference's functions
are called outside a compiled step.  Where every operation is exactly
rounded the same way (the schedule, the compression, the bias
corrections, the moments) the port is held bitwise; the global norm sums
its squares in another order, so AdamW's clip scale and what follows it
are held to one ulp and what that ulp moves."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

from repro import configs as jconfigs
from repro.data import DataPipeline as JPipeline
from repro.models import layers as jlayers
from repro.optim import adamw_init as j_adamw_init
from repro.optim import adamw_update as j_adamw_update
from repro.optim import cosine_schedule as j_cosine
from repro.optim.compress import ef_init as j_ef_init
from repro.optim.compress import ef_int8_compress as j_ef
from repro_torch import configs as tconfigs
from repro_torch.data import DataPipeline
from repro_torch.models import layers as tlayers
from repro_torch.optim import (adamw_init, adamw_update, cosine_schedule,
                               ef_init, ef_int8_compress)
from repro_torch.optim.adamw import global_norm

SHAPES = {"a.w": (3, 5), "b.w": (7,), "c.w": (4, 2, 3)}



@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The tensors here are small: one intra-op thread runs them as fast
    and leaves the other cores to the test run's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _ulps(a, b):
    """Largest distance in f32 ulps between two f32 arrays."""
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7fffffff), ia)
    ib = np.where(ib < 0, -(ib & 0x7fffffff), ib)
    return int(np.abs(ia - ib).max())


def _trees(seed, dtype):
    """The same numpy draws as a JAX dict and a torch dict of ``dtype``."""
    rng = np.random.default_rng(seed)
    arrs = {n: rng.normal(0, 1, s).astype(np.float32)
            for n, s in SHAPES.items()}
    jt = {n: jnp.asarray(a, dtype) for n, a in arrs.items()}
    tt = {n: torch.tensor(_np(jt[n])).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
        for n in arrs}
    return jt, tt


# ---------------- against the JAX package ----------------

def test_cosine_schedule_matches_jax_bitwise():
    kw = dict(peak=1e-3, warmup=10, total=50)
    steps = np.arange(0, 56, dtype=np.int32)
    with jax.disable_jit():
        ref = np.asarray(j_cosine(jnp.asarray(steps), **kw))
    out = cosine_schedule(torch.from_numpy(steps), **kw).numpy()
    np.testing.assert_array_equal(out, ref)
    for s in (0, 9, 10, 37, 55):         # an int step (the port's CPU form)
        assert float(cosine_schedule(s, **kw)) == float(ref[s])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ef_int8_compress_matches_jax_bitwise(dtype):
    jdt = getattr(jnp, dtype)
    jerr, terr = j_ef_init(_trees(0, jdt)[0]), ef_init(_trees(0, jdt)[1])
    for step in range(3):
        jg, tg = _trees(step + 1, jdt)
        with jax.disable_jit():
            jdeq, jerr = j_ef(jg, jerr)
        tdeq, terr = ef_int8_compress(tg, terr)
        for n in SHAPES:
            np.testing.assert_array_equal(_np(tdeq[n]), _np(jdeq[n]))
            np.testing.assert_array_equal(_np(terr[n]), _np(jerr[n]))


@pytest.mark.parametrize("clip", [1e9, 1.0], ids=["unclipped", "clipped"])
def test_adamw_update_matches_jax(clip):
    """Three steps from the same bf16 params and gradients at the
    schedule's rates.  Unclipped, every leaf (bf16 params, m, v, master)
    and the count are bitwise the reference's.  Clipped (the global norm
    is ~7.9), the norm sums its squares in another order and lands within
    one ulp of the reference's, and that ulp in the clip scale moves m, v
    and master by at most 1e-6 of each leaf's largest value."""
    jp, tp = _trees(10, jnp.bfloat16)
    jst, tst = j_adamw_init(jp), adamw_init(tp)
    for step in range(3):
        jg, tg = _trees(20 + step, jnp.bfloat16)
        with jax.disable_jit():
            jlr = j_cosine(jst.count, peak=0.05, warmup=1, total=5)
            jp, jst = j_adamw_update(jg, jst, lr=jlr, grad_clip=clip)
            jn = jnp.sqrt(sum(jnp.sum(jnp.square(g.astype(jnp.float32)))
                              for g in jax.tree.leaves(jg)))
        tlr = cosine_schedule(tst.count, peak=0.05, warmup=1, total=5)
        tp, tst = adamw_update(tg, tst, lr=tlr, grad_clip=clip)
        assert float(tlr) == float(jlr)
        assert int(tst.count) == int(jst.count) == step + 1
        assert _ulps(_np(global_norm(tg)), _np(jn)) <= 1
        for n in SHAPES:
            for a, b in ((tst.m, jst.m), (tst.v, jst.v),
                         (tst.master, jst.master), (tp, jp)):
                a, b = _np(a[n]), _np(b[n])
                if clip > 100:
                    np.testing.assert_array_equal(a, b)
                else:
                    np.testing.assert_allclose(
                        a, b, rtol=0, atol=1e-6 * np.abs(b).max())


# ---------------- ports of tests/test_infra.py ----------------

def test_adamw_converges_quadratic():
    params = {"w": torch.tensor([5.0, -3.0], dtype=torch.bfloat16)}
    opt = adamw_init(params)
    target = torch.tensor([1.0, 2.0])
    for _ in range(300):
        g = {"w": (params["w"].float() - target).to(torch.bfloat16)}
        params, opt = adamw_update(g, opt, lr=torch.tensor(0.05),
                                   weight_decay=0.0)
    np.testing.assert_allclose(_np(params["w"]), target.numpy(), atol=0.1)


def test_cosine_schedule_shape():
    s = lambda t: float(cosine_schedule(torch.tensor(t, dtype=torch.int32),
                                        peak=1.0, warmup=10, total=100))
    assert s(0) == 0.0
    assert abs(s(10) - 1.0) < 0.11
    assert s(50) < s(10)
    assert s(100) >= 0.099   # floor


@settings(max_examples=20, deadline=None)
@given(st.lists(st.floats(-10, 10), min_size=4, max_size=16))
def test_ef_compression_error_feedback(vals):
    """Accumulated compressed updates converge to accumulated true grads
    (the error-feedback property)."""
    g = {"w": torch.tensor(vals, dtype=torch.float32)}
    err = ef_init(g)
    total_true = torch.zeros_like(g["w"])
    total_sent = torch.zeros_like(g["w"])
    for _ in range(20):
        deq, err = ef_int8_compress(g, err)
        total_true += g["w"]
        total_sent += deq["w"]
    resid = (total_sent - total_true).abs().numpy()
    scale = max(1e-6, float(g["w"].abs().max()))
    assert resid.max() <= scale / 127 + 1e-5   # bounded by one quantum


# ---------------- data pipeline ----------------

def _shape(S=32, B=2):
    return jconfigs.ShapeConfig("t", "train", S, B), \
        tconfigs.ShapeConfig("t", "train", S, B)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "qwen2-vl-72b",
                                  "whisper-tiny"])
def test_pipeline_matches_jax_bitwise(arch):
    """The port's batches equal the reference's, leaf by leaf and dtype by
    dtype, at S 512 (two copy motifs a row); a pipeline resumed from a
    cursor and a prefetching one hand out the same batches."""
    js, ts = _shape(S=512)
    jp = JPipeline(jconfigs.get_reduced(arch), js, seed=4)
    tp = DataPipeline(tconfigs.get_reduced(arch), ts, seed=4)
    ref = [next(jp) for _ in range(3)]
    got = [next(tp) for _ in range(3)]
    resumed = DataPipeline(tconfigs.get_reduced(arch), ts,
                           cursor=type(tp.cursor)(step=2, seed=4))
    pre = DataPipeline(tconfigs.get_reduced(arch), ts, seed=4)
    pre.start_prefetch()
    fetched = [pre.get() for _ in range(3)]
    pre.stop()
    assert pre.next_step == 3
    for r, g, f in zip(ref, got, fetched):
        assert sorted(r) == sorted(g) == sorted(f)
        for k in r:
            assert r[k].dtype == g[k].dtype, k
            np.testing.assert_array_equal(g[k], r[k])
            np.testing.assert_array_equal(f[k], r[k])
    for k, v in next(resumed).items():
        np.testing.assert_array_equal(v, ref[2][k])


def test_pipeline_determinism_and_resume():
    cfg = tconfigs.get_reduced("qwen1.5-0.5b")
    shape = _shape()[1]
    p1 = DataPipeline(cfg, shape, seed=5)
    batches = [next(p1) for _ in range(5)]
    p2 = DataPipeline(cfg, shape, seed=5)
    p2.cursor.step = 3
    b3 = next(p2)
    np.testing.assert_array_equal(b3["tokens"], batches[3]["tokens"])


def test_pipeline_prefetch():
    cfg = tconfigs.get_reduced("qwen1.5-0.5b")
    p = DataPipeline(cfg, _shape()[1], seed=1)
    p.start_prefetch()
    b = p.get()
    assert b["tokens"].shape == (2, 32)
    p.stop()


# ---------------- cross-entropy ----------------

@pytest.mark.parametrize("S", [2048, 96], ids=["chunked", "whole"])
def test_cross_entropy_matches_jax(S):
    """``chunked_ce`` (two 1024-position chunks at S 2048; the whole
    logits at S 96) and ``cross_entropy`` of the logits against the JAX
    package's, value and the gradients of x and of the tied head, on bf16
    inputs with a padded vocab and ignored (-1) targets: values within
    1e-5, gradients bitwise up to one bf16 rounding (2e-3 relative L2)."""
    rng = np.random.default_rng(S)
    B, D, V, Vp = 2, 32, 300, 512
    x = rng.normal(0, 1, (B, S, D)).astype(np.float32)
    head = rng.normal(0, 0.5, (Vp, D)).astype(np.float32)
    tgt = rng.integers(0, V, (B, S)).astype(np.int32)
    tgt[:, ::7] = -1
    jx, jh = jnp.asarray(x, jnp.bfloat16), jnp.asarray(head, jnp.bfloat16)

    def jf(xx, hh):
        return jlayers.chunked_ce(xx, hh, jnp.asarray(tgt), V,
                                  transpose=True)

    def jf_whole(xx, hh):
        return jlayers.cross_entropy(
            jlayers.lm_logits(xx, hh, V, transpose=True), jnp.asarray(tgt))

    tx = torch.from_numpy(_np(jx)).bfloat16().requires_grad_()
    th = torch.from_numpy(_np(jh)).bfloat16().requires_grad_()
    tt = torch.from_numpy(tgt)
    for j_fn, t_fn in (
            (jf, lambda: tlayers.chunked_ce(tx, th, tt, V, transpose=True)),
            (jf_whole, lambda: tlayers.cross_entropy(
                tlayers.lm_logits(tx, th, V, transpose=True), tt))):
        jv, (jgx, jgh) = jax.jit(jax.value_and_grad(j_fn, (0, 1)))(jx, jh)
        tx.grad = th.grad = None
        tv = t_fn()
        tv.backward()
        assert abs(tv.item() - float(jv)) < 1e-5
        for t, j in ((tx.grad, jgx), (th.grad, jgh)):
            a, b = _np(t), _np(j)
            assert np.linalg.norm(a - b) <= 2e-3 * np.linalg.norm(b)
