"""The port's int8 KV cache (``Plan(kv_quant=True)``: ``attention._quant_kv``,
``cache_update``, ``attend``'s int8-native mode, the reference's default
decode route) and the weight-only int8 helpers (``layers.quantize_int8`` / ``matmul_int8``) against the JAX
package's ``repro.models``.

As in ``test_torch_models.py``, JAX parameters go to the port through
``convert.model_params_from_numpy`` and the JAX model runs eagerly
(``jax.disable_jit()``).  The codes and scales are exact f32 arithmetic
(a max, two divisions, a round half to even) and are held bitwise; the
logits are held to the 2e-2 absolute of the LM tests."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs
from repro.models import Plan as JPlan
from repro.models import attention as jattn
from repro.models import build_model as jbuild
from repro.models import layers as jlayers
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.models import Plan, attention, build_model
from repro_torch.models import layers as tlayers

B, S, S0 = 2, 24, 20


def _bf(x):
    """numpy -> the bf16 values as a JAX array and a torch tensor."""
    j = jnp.asarray(x, jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j, np.float32)).to(torch.bfloat16)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _pair(arch, seed=1, **plan):
    """The JAX model with its params and the port's model holding them,
    the same Plan fields in both packages (MoE drop-free)."""
    jcfg, tcfg = jconfigs.get_reduced(arch), tconfigs.get_reduced(arch)
    jm = jbuild(jcfg, JPlan(moe_capacity=0, **plan))
    params = jm.init_params(jax.random.PRNGKey(seed))
    tm = build_model(tcfg, Plan(moe_capacity=0, **plan), device="cpu")
    tm.load_state_dict(convert.model_params_from_numpy(
        tcfg, jax.tree.map(np.asarray, params), device="cpu"))
    return jm, params, tm


def _kv_rows(seed=0):
    """bf16 K-like rows (4, 37, 3, 16): normal draws at three magnitudes,
    an all-zero row (scale 0: the 1e-8 floor), a row of one value, rows
    whose quotients land on .5 (round half to even) and a huge row."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(4, 37, 3, 16)) * np.array([1e-3, 1, 30, 300])[
        :, None, None, None]
    x[0, 0] = 0.0
    x[1, 1] = 2.5
    x[1, 2, 0] = np.arange(16) - 7.5          # max 8.5 -> x / s = 127 x / 8.5
    x[2, 3, 1] = np.linspace(-127, 127, 16) / 2
    x[3, 4] = 3e38
    return _bf(x)


def test_quant_kv_bitwise():
    """``_quant_kv``: the int8 codes and f32 scales equal the JAX
    package's bit for bit, zero rows, ties and huge values included."""
    jx, tx = _kv_rows()
    with jax.disable_jit():
        jq, js = jattn._quant_kv(jx)
    tq, ts = attention._quant_kv(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert ts.shape == (4, 37, 3)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.uint32),
                                  np.asarray(js).view(np.uint32))
    assert int(np.abs(tq.numpy()).max()) == 127
    assert not tq[0, 0].any() and not ts[0, 0].any()


def test_cache_update_int8_bitwise():
    """An int8 cache written at two offsets holds the JAX cache's codes and
    scales."""
    jx, tx = _kv_rows(1)
    jc = jattn.init_kv_cache(4, 48, 3, 16, quant=True)
    tc = attention.init_kv_cache(4, 48, 3, 16, quant=True, device="cpu")
    assert tc.k.dtype == torch.int8 and tc.k_scale.shape == (4, 48, 3)
    with jax.disable_jit():
        jc = jattn.cache_update(jc, jx[:, :30], jx[:, :30] * 2, 0)
        jc = jattn.cache_update(jc, jx[:, 30:], jx[:, 30:] * 2, 30)
    tc = attention.cache_update(tc, tx[:, :30], tx[:, :30] * 2, 0)
    tc = attention.cache_update(tc, tx[:, 30:], tx[:, 30:] * 2, 30)
    assert tc.length == int(jc.length) == 37
    for a, b in ((tc.k, jc.k), (tc.v, jc.v), (tc.k_scale, jc.k_scale),
                 (tc.v_scale, jc.v_scale)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("kv_len", [None, 29])
def test_attend_int8_native_matches_jax(kv_len):
    """``attend`` with int8 codes and their scales (dequantized per 16-key
    chunk, the last one ragged) against the JAX ``attend``'s int8 mode."""
    jx, tx = _kv_rows(2)
    rng = np.random.default_rng(4)
    jq, tq = _bf(rng.normal(size=(4, 1, 3, 16)))
    with jax.disable_jit():
        jk, jks = jattn._quant_kv(jx)
        jv, jvs = jattn._quant_kv(jx[:, ::-1])
        want = jattn.attend(jq, jk, jv, k_scale=jks, v_scale=jvs,
                            causal=False, q_offset=36, kv_len=kv_len,
                            chunk=16)
    tk, tks = attention._quant_kv(tx)
    tv, tvs = attention._quant_kv(tx.flip(1))
    got = attention.attend(tq, tk, tv, k_scale=tks, v_scale=tvs,
                           causal=False, q_offset=36, kv_len=kv_len, chunk=16)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-2, rtol=0)


def test_quantize_int8_and_matmul_int8_bitwise():
    """Weight-only int8: per-output-channel codes and scales bitwise (a
    zero column included), and the dequantized product in bf16 bitwise."""
    rng = np.random.default_rng(5)
    w = rng.normal(size=(64, 48)) * 0.05
    w[:, 3] = 0.0
    jw, tw = _bf(w)
    jx, tx = _bf(rng.normal(size=(2, 5, 64)))
    with jax.disable_jit():
        jq, js = jlayers.quantize_int8(jw)
        jy = jlayers.matmul_int8(jx, jq, js)
    tq, ts = tlayers.quantize_int8(tw)
    assert tq.dtype == torch.int8 and ts.shape == (1, 48)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    ty = tlayers.matmul_int8(tx, tq, ts)
    assert ty.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(ty), _np(jy))


def _tokens(cfg, n=S, seed=2):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, n)).astype(np.int32)


def _prefill_and_decode(jm, params, tm, toks, s0, steps, s_max=64):
    """prefill of ``s0`` tokens + ``steps`` teacher-forced decode steps in
    both packages: the (JAX, port) logits of every step and both caches."""
    with jax.disable_jit():
        jc, jl = jm.prefill(params, {"tokens": jnp.asarray(toks[:, :s0])},
                            jm.init_decode(B, s_max))
        tc, tl = tm.prefill({"tokens": torch.from_numpy(toks[:, :s0])},
                            tm.init_decode(B, s_max))
        pairs = [(jl, tl)]
        for i in range(steps):
            tok = toks[:, s0 + i:s0 + i + 1]
            jc, jl = jm.decode_step(params, jc, jnp.asarray(tok), s0 + i)
            tc, tl = tm.decode_step(tc, torch.from_numpy(tok), s0 + i)
            pairs.append((jl, tl))
    return pairs, tc, jc


def _assert_logits(pairs, v):
    for step, (a, b) in enumerate(pairs):
        assert bool(torch.isfinite(b[..., :v]).all())
        np.testing.assert_allclose(_np(b)[..., :v], _np(a)[..., :v],
                                   atol=2e-2, rtol=0, err_msg=f"step {step}")


def _assert_caches_equal(tm, tc, jc, exact=True):
    """Every layer's cache leaves (codes, scales or bf16 K/V) and length
    equal the JAX package's, read through ``kv_caches_from_numpy``.  With
    ``exact=False`` an int8 code may differ by one and a scale by one bf16
    ulp of the row's max (at most 2^-7 relative): where a K entry of the
    prefill already differs by a bf16 ulp (the kernel's plain softmax and
    the reference's online one round apart), its code and row scale
    follow."""
    want = convert.kv_caches_from_numpy(tm.cfg, jax.tree.map(np.asarray, jc),
                                        device="cpu")
    assert len(tc) == len(want) == tm.cfg.n_layers
    for got, ref in zip(tc, want):
        assert got.length == ref.length
        for a, b in zip(got[:4], ref[:4]):
            assert (a is None) == (b is None)
            if a is None:
                continue
            assert a.dtype == b.dtype
            if exact:
                assert torch.equal(a, b)
            elif a.dtype == torch.int8:
                assert int((a.int() - b.int()).abs().max()) <= 1
            else:
                torch.testing.assert_close(a, b, rtol=2 ** -7, atol=0)


def test_int8_prefill_and_decode_match_jax():
    """Qwen2-7B reduced with ``Plan(kv_quant=True)``: prefill of 20 tokens
    + 4 teacher-forced decode steps through the int8-native ``attend``;
    logits within 2e-2 of the JAX package's, every layer's codes, scales
    and length equal."""
    jm, params, tm = _pair("qwen2-7b", kv_quant=True)
    toks = _tokens(tm.cfg)
    pairs, tc, jc = _prefill_and_decode(jm, params, tm, toks, S0, 4)
    _assert_logits(pairs, tm.cfg.vocab_size)
    assert tc[0].k.dtype == torch.int8 and tc[0].length == S0 + 4
    _assert_caches_equal(tm, tc, jc)


def test_int8_decode_route_reads_the_cache_as_planned():
    """An int8 decode hands ``attend`` the cache's int8 codes and their f32
    scales (dequantized per chunk there), with the 21 valid slots (20 of
    the prefill, one of the step) and folded GQA queries."""
    _, _, tm = _pair("qwen2-7b", kv_quant=True)
    toks = torch.from_numpy(_tokens(tm.cfg))
    caches, _ = tm.prefill({"tokens": toks[:, :S0]}, tm.init_decode(B, 64))
    real, seen = attention.attend, []

    def spy(q, k, v, **kw):
        seen.append((q.shape, k, v, kw))
        return real(q, k, v, **kw)

    attention.attend = spy
    try:
        caches, _ = tm.decode_step(caches, toks[:, S0:S0 + 1], S0)
    finally:
        attention.attend = real
    assert len(seen) == tm.cfg.n_layers
    for (qs, k, v, kw), c in zip(seen, caches):
        assert qs == (B, tm.cfg.n_heads, 1, tm.cfg.hd)      # folded groups
        assert kw["kv_len"] == S0 + 1
        assert k.dtype == torch.int8 and torch.equal(k, c.k)
        assert v.dtype == torch.int8 and torch.equal(v, c.v)
        assert torch.equal(kw["k_scale"], c.k_scale)
        assert torch.equal(kw["v_scale"], c.v_scale)


def test_int8_ring_matches_jax():
    """Mixtral reduced (window 64) with an int8 ring: a 40-token prefill
    into 256 requested slots (a 64-slot ring) and 32 decode steps, past
    the wrap at step 24; logits within 2e-2 of the JAX package's, the
    ring's length equal, its codes within one and its scales within one
    bf16 ulp (layer 1 holds 2 codes off by one and a scale 0.6 % apart at
    one prefill position, from a K entry one bf16 ulp apart before
    quantization)."""
    jm, params, tm = _pair("mixtral-8x22b", seed=3, kv_quant=True)
    toks = _tokens(tm.cfg, n=72, seed=6)
    pairs, tc, jc = _prefill_and_decode(jm, params, tm, toks, 40, 32,
                                        s_max=256)
    _assert_logits(pairs, tm.cfg.vocab_size)
    assert tc[0].k.shape[1] == tm.cfg.sliding_window == 64
    assert tc[0].k.dtype == torch.int8 and tc[0].length == 72
    _assert_caches_equal(tm, tc, jc, exact=False)


def test_mla_latent_cache_stays_bf16_under_kv_quant():
    """DeepSeek-V2-Lite reduced with ``kv_quant=True``: its MLA latent
    caches stay bf16 without scales, as the reference keeps them
    (``repro/models/transformer.py:120``); prefill + 4 decode steps within
    2e-2 of the JAX package's, the latent caches equal."""
    jm, params, tm = _pair("deepseek-v2-lite", kv_quant=True)
    caches = tm.init_decode(B, 64)
    assert all(c.k.dtype == torch.bfloat16 and c.k_scale is None
               for c in caches)
    toks = _tokens(tm.cfg)
    pairs, tc, jc = _prefill_and_decode(jm, params, tm, toks, S0, 4)
    _assert_logits(pairs, tm.cfg.vocab_size)
    _assert_caches_equal(tm, tc, jc)


def test_jax_int8_prefill_continues_in_port_decode():
    """A jitted JAX prefill into an int8 cache goes to the port
    (``kv_caches_from_numpy`` carries codes and scales) and the port
    decodes on with the JAX decode's logits from the same caches."""
    jm, params, tm = _pair("qwen2-7b", seed=3, kv_quant=True)
    toks = _tokens(tm.cfg, seed=4)
    jc = jm.init_decode(B, 32)
    jc, _ = jax.jit(jm.prefill)(params, {"tokens": jnp.asarray(toks[:, :S0])},
                                jc)
    tc = convert.kv_caches_from_numpy(tm.cfg, jax.tree.map(np.asarray, jc),
                                      device="cpu")
    assert tc[1].k.dtype == torch.int8 and tc[1].k_scale.dtype == \
        torch.float32 and tc[1].k_scale.shape == (B, 32, 1)
    assert tc[1].length == S0
    with jax.disable_jit():
        for i in range(3):
            tok = toks[:, S0 + i:S0 + i + 1]
            jc, jl = jm.decode_step(params, jc, jnp.asarray(tok), S0 + i)
            tc, tl = tm.decode_step(tc, torch.from_numpy(tok), S0 + i)
            np.testing.assert_allclose(_np(tl)[..., :512],
                                       _np(jl)[..., :512], atol=2e-2, rtol=0)
    _assert_caches_equal(tm, tc, jc)


def test_serve_int8_plan_decodes_like_bf16():
    """``Plan(kv_quant=True)`` through the whole model on the CPU: prefill
    + 4 decode steps of the reduced Qwen2-7B stay within 0.5 of the bf16
    cache's logits (int8 rounds K/V to 1/254 of each row's range), the
    cache is 0.5 + 4 / (2 D) of the bf16 one's bytes."""
    cfg = tconfigs.get_reduced("qwen2-7b")
    bf = build_model(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(1))
    q8 = build_model(cfg, Plan(kv_quant=True), device="cpu")
    q8.load_state_dict(bf.state_dict())
    toks = torch.from_numpy(_tokens(cfg))
    ca, cb = bf.init_decode(B, 64), q8.init_decode(B, 64)
    size = lambda cs: sum(t.numel() * t.element_size() for c in cs
                          for t in c[:4] if t is not None)
    assert size(cb) / size(ca) == 0.5 + 4 / (2 * cfg.hd)
    ca, _ = bf.prefill({"tokens": toks[:, :S0]}, ca)
    cb, _ = q8.prefill({"tokens": toks[:, :S0]}, cb)
    for i in range(4):
        tok = toks[:, S0 + i:S0 + i + 1]
        ca, la = bf.decode_step(ca, tok, S0 + i)
        cb, lb = q8.decode_step(cb, tok, S0 + i)
        assert float((la - lb).abs().max()) < 0.5
