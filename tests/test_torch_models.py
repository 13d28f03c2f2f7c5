"""The port's LM stack (``repro_torch.models``: GQA and MLA attention,
Mamba and RWKV-6 mixers, dense and MoE FFNs, the sliding-window ring
cache, Qwen2-VL's M-RoPE and vision prefix; ``launch/serve.run``,
``convert``) against the JAX package's ``repro.models``.

Parameters made by the JAX package go to the port through
``convert.model_params_from_numpy``; the same numpy tokens go through
both, teacher-forced.  The JAX model runs eagerly (``jax.disable_jit()``):
under ``jit``, XLA lets its fusions keep bf16 intermediates in f32 (excess
precision), which moves the reduced Qwen2-7B's logits by up to 0.10 from
the step-by-step casts that both the eager JAX model and the port perform.
Eager, the port's prefill and decode logits equal the JAX model's bit for
bit on the CPU they were measured on; they are held to the 2e-2 absolute
of the acceptance bar, so that a one-ulp difference of a bf16 matmul on
another CPU does not fail them.  Every prefill scales q by D^-0.5 in bf16
before the kernel, as the reference's ``attend`` does
(``attention.prefill_mha``); scaling the f32 scores instead agrees only
where D^-0.5 is a power of two (D 16), and left the reduced StableLM-12B
(D 20) and DeepSeek-67B (D 8) 0.234 and 0.504 apart
(``test_forward_matches_jax_where_the_scale_rounds``).  The reduced
DeepSeek-V2-Lite's (MLA, D 24), Mixtral's (ring cache included), Jamba's
(Mamba + attention without RoPE, MoE) and RWKV6-3B's logits were bitwise
equal too."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs
from repro.models import Plan as JPlan
from repro.models import build_model as jbuild
from repro.models import layers as jlayers
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.kernels.flash_attention import flash_attention as fa_kernel
from repro_torch.launch import serve
from repro_torch.models import Plan, build_model
from repro_torch.models import layers as tlayers
from repro_torch.models.model import model_spec
from repro_torch.models.param import param_count

# the configs with RoPE (rope_theta > 0)
ROPE = ["qwen2-7b", "qwen1.5-0.5b", "stablelm-12b", "deepseek-67b",
        "qwen2-vl-72b", "mixtral-8x22b", "deepseek-v2-lite"]
SSM = ["jamba-v0.1-52b", "rwkv6-3b"]
PORTED = ROPE + SSM
MOE = ["mixtral-8x22b", "deepseek-v2-lite", "jamba-v0.1-52b"]
# spec-tree parameters that ModelConfig.n_params() leaves out (full width,
# reduced): Jamba's Mamba layers' conv_b and dt_bias (28 x 2 x 8192 at full
# width), RWKV's
N_PARAMS_GAP = {"jamba-v0.1-52b": (458752, 1536),
                "rwkv6-3b": (205455360, 1536)}
B, S, S0 = 2, 24, 20


def _bf(x):
    """numpy -> the bf16 values as a JAX array and a torch tensor."""
    j = jnp.asarray(x, jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j, np.float32)).to(torch.bfloat16)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _tokens(cfg, seed=2):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _pair(arch, seed=1, **plan):
    """The JAX model with its params and the port's model holding them;
    ``plan`` sets the same Plan fields in both packages (MoE drop-free)."""
    jcfg, tcfg = jconfigs.get_reduced(arch), tconfigs.get_reduced(arch)
    jm = jbuild(jcfg, JPlan(moe_capacity=0, **plan))
    params = jm.init_params(jax.random.PRNGKey(seed))
    tm = build_model(tcfg, Plan(moe_capacity=0, **plan), device="cpu")
    tm.load_state_dict(convert.model_params_from_numpy(
        tcfg, jax.tree.map(np.asarray, params), device="cpu"))
    return jm, params, tm


# ---------------- layers ----------------

def _xla_sincos(a, jit):
    f = lambda x: (jnp.sin(x), jnp.cos(x))
    if jit:
        return jax.jit(f)(a)
    with jax.disable_jit():
        return f(a)


@pytest.mark.parametrize("jit", [False, True], ids=["eager", "jit"])
@pytest.mark.parametrize("arch", ROPE)
def test_rope_sincos_matches_xla_bitwise(arch, jit):
    """``sincosf.sincos_f32`` (the port's RoPE sine and cosine) gives the
    bits of the JAX package's ``jnp.sin`` / ``jnp.cos`` on every RoPE angle
    of the configuration at full size over 16384 positions, and on 2^18
    f32 bit patterns drawn over every finite value and their negatives."""
    from repro_torch.models.sincosf import sincos_f32
    cfg = tconfigs.get(arch)
    dim = cfg.mla.qk_rope_head_dim if cfg.mla is not None else cfg.hd
    ang = tlayers.rope_angles(torch.arange(16384), dim, cfg.rope_theta)
    bits = np.random.default_rng(11).integers(0, 0x7f800000, 1 << 18)
    bits[::2] |= 1 << 31
    rand = torch.from_numpy(bits.astype(np.uint32).view(np.float32))
    for a in (ang.reshape(-1), rand):
        ts, tc = sincos_f32(a)
        js, jc = _xla_sincos(jnp.asarray(a.numpy()), jit)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_layer_functions_match_jax_bitwise():
    """rms_norm (f32 statistics, bf16 round, times the weight),
    rope_angles (f32 theta ** (-i / half), at Qwen2-7B's head_dim 128 and
    positions past 4096 too), apply_rope (f32, rounded), swiglu (silu in
    f32, cast, gate): bitwise."""
    rng = np.random.default_rng(0)
    jx, tx = _bf(rng.normal(size=(2, 24, 64)))
    jw, tw = _bf(rng.normal(size=64))
    np.testing.assert_array_equal(_np(jlayers.rms_norm(jx, jw, 1e-6)),
                                  _np(tlayers.rms_norm(tx, tw, 1e-6)))
    pos = np.broadcast_to(np.arange(4090, 4114), (2, 24)).copy()
    ja = jlayers.rope_angles(jnp.asarray(pos), 128, 1e6)
    ta = tlayers.rope_angles(torch.from_numpy(pos), 128, 1e6)
    np.testing.assert_array_equal(np.asarray(ja), ta.numpy())
    ja = jlayers.rope_angles(jnp.asarray(pos[:, :24]), 16, 1e6)
    ta = tlayers.rope_angles(torch.from_numpy(pos[:, :24]), 16, 1e6)
    jq, tq = _bf(rng.normal(size=(2, 24, 7, 16)))
    np.testing.assert_array_equal(
        _np(jlayers.apply_rope(jq, ja)),
        _np(tlayers.apply_rope(tq, tlayers.rope_tables(ta))))
    jwi, twi = _bf(rng.normal(size=(64, 352)) * 0.1)
    jwo, two = _bf(rng.normal(size=(176, 64)) * 0.1)
    np.testing.assert_array_equal(
        _np(jlayers.swiglu({"wi": jwi, "wo": jwo}, jx)),
        _np(tlayers.swiglu({"wi": twi, "wo": two}, tx)))


@pytest.mark.parametrize("tied", [True, False])
def test_lm_logits_match_jax(tied):
    """bf16 matmul, then f32, padded vocab slots at -1e30.  The matmul's
    f32 accumulation order differs between XLA and torch, so a logit may
    round to the neighbouring bf16 value: held to one bf16 ulp (2^-8
    relative), and 1e-6 absolute for the few that cancel to near zero
    (one of 3000 here: 1.2e-7 apart)."""
    rng = np.random.default_rng(1)
    jx, tx = _bf(rng.normal(size=(2, 3, 64)))
    shape = (512, 64) if tied else (64, 512)
    jw, tw = _bf(rng.normal(size=shape) * 0.125)
    want = _np(jlayers.lm_logits(jx, jw, 500, transpose=tied))
    got = tlayers.lm_logits(tx, tw, 500, transpose=tied)
    assert got.dtype == torch.float32 and got.shape == (2, 3, 512)
    np.testing.assert_array_equal(got[..., 500:].numpy(), want[..., 500:])
    np.testing.assert_allclose(got[..., :500].numpy(), want[..., :500],
                               rtol=2 ** -8, atol=1e-6)


@pytest.mark.parametrize("causal,window,q_offset,kv_len", [
    (True, 0, 0, None), (False, 0, 37, 38), (True, 9, 0, None),
    (False, 0, 60, 61)])
def test_attend_matches_jax(causal, window, q_offset, kv_len):
    """The plain chunked online softmax of decode (q scaled in bf16, f32
    scores, -1e30 masks, 16-key chunks with a ragged last one) against the
    JAX ``attend`` run eagerly."""
    from repro.models.attention import attend as jattend
    from repro_torch.models.attention import attend as tattend
    rng = np.random.default_rng(3)
    sq = 1 if kv_len else 40
    jq, tq = _bf(rng.normal(size=(2, sq, 3, 16)))
    jk, tk = _bf(rng.normal(size=(2, 61, 3, 16)))
    jv, tv = _bf(rng.normal(size=(2, 61, 3, 16)))
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              kv_len=kv_len, chunk=16)
    if not kv_len:
        jk, tk, jv, tv = jk[:, :40], tk[:, :40], jv[:, :40], tv[:, :40]
    with jax.disable_jit():
        want = _np(jattend(jq, jk, jv, **kw))
    np.testing.assert_allclose(_np(tattend(tq, tk, tv, **kw)), want,
                               atol=2e-2, rtol=0)


# ---------------- parameters ----------------

@pytest.mark.parametrize("arch", PORTED)
def test_param_count_matches_config(arch):
    """The spec tree counts the JAX package's spec tree's parameters, at
    full width (counted, not allocated) and reduced: the config's
    ``n_params()`` plus the vocab padding (256-multiple), and for Jamba
    and RWKV6-3B plus what ``n_params()`` leaves out (``N_PARAMS_GAP``, a
    fact about the reference)."""
    from repro.models.param import param_count as jparam_count
    for cfg, jcfg, gap in zip(
            (tconfigs.get(arch), tconfigs.get_reduced(arch)),
            (jconfigs.get(arch), jconfigs.get_reduced(arch)),
            N_PARAMS_GAP.get(arch, (0, 0))):
        plan = Plan()
        pad = (plan.padded_vocab(cfg.vocab_size) - cfg.vocab_size) * \
            cfg.d_model * (1 if cfg.tie_embeddings else 2)
        count = param_count(model_spec(cfg, plan))
        assert count == jparam_count(jbuild(jcfg, JPlan()).spec())
        assert count == cfg.n_params() + pad + gap
    assert param_count(model_spec(tconfigs.get("qwen2-7b"), Plan())) == \
        7_615_616_512


def test_state_names_and_shapes_match_the_jax_tree():
    """Every JAX leaf lands on one port parameter of its shape and dtype,
    one per layer (the 2-layer group is unstacked)."""
    _, params, tm = _pair("qwen2-7b")
    state = convert.model_params_from_numpy(
        tconfigs.get_reduced("qwen2-7b"), jax.tree.map(np.asarray, params),
        device="cpu")
    own = tm.state_dict()
    assert sorted(state) == sorted(own)
    assert "stack.layers.1.attn.bq" in own and "lm_head" in own
    for name, x in state.items():
        assert x.shape == own[name].shape and x.dtype == own[name].dtype
    assert len(state) == len(jax.tree.leaves(params)) + 11   # 11 a layer


def test_init_params_follow_the_spec():
    """zeros / ones exactly; normal draws with std scale / sqrt(fan_in)
    (fan_in = shape[-2]), embeddings 0.02, all bf16, reproducible."""
    cfg = tconfigs.get_reduced("qwen2-7b")
    m = build_model(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    p = m.stack.layers[0]
    assert torch.equal(p.ln_mix, torch.ones(64, dtype=torch.bfloat16))
    assert not p.attn.bq.any() and p.attn.wq.dtype == torch.bfloat16
    for w, std in ((p.attn.wq, 7 ** -0.5), (p.ffn.wi, 64 ** -0.5),
                   (p.attn.wo, 16 ** -0.5), (m.tok_embed, 0.02)):
        assert abs(float(w.float().std()) / std - 1) < 0.1
    again = build_model(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    for (name, a), b in zip(m.state_dict().items(),
                            again.state_dict().values()):
        assert torch.equal(a, b), name


def test_cache_update_past_the_end_raises():
    """A write past ``s_max`` raises: its slice would be empty and the
    token silently dropped while the length still grew."""
    from repro_torch.models import attention
    cache = attention.init_kv_cache(1, 9, 2, 4, quant=False, device="cpu")
    kv = torch.ones(1, 1, 2, 4, dtype=torch.bfloat16)
    cache = attention.cache_update(cache, kv, kv, 8)
    assert cache.length == 9 and bool((cache.k[:, 8] == 1).all())
    for pos, s_new in ((9, 1), (10, 1), (8, 2), (-1, 1)):
        new = torch.ones(1, s_new, 2, 4, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="do not fit"):
            attention.cache_update(cache, new, new, pos)
    m = build_model(tconfigs.get_reduced("qwen2-7b"), device="cpu")
    caches = m.init_decode(1, 9)
    caches, _ = m.prefill({"tokens": torch.zeros(1, 9, dtype=torch.long)},
                          caches)
    with pytest.raises(ValueError, match="do not fit"):
        m.decode_step(caches, torch.zeros(1, 1, dtype=torch.long), 9)


# ---------------- model ----------------

def _prefill_and_decode(jm, params, tm, toks):
    """prefill of 20 tokens + 4 teacher-forced decode steps through both
    packages: the (JAX, port) logits of each step, the port's caches and
    the JAX package's."""
    with jax.disable_jit():
        jc = jm.init_decode(B, 64)
        jc, jl = jm.prefill(params, {"tokens": jnp.asarray(toks[:, :S0])},
                            jc)
        tc = tm.init_decode(B, 64)
        tc, tl = tm.prefill({"tokens": torch.from_numpy(toks[:, :S0])}, tc)
        pairs = [(jl, tl)]
        for i in range(4):
            tok = toks[:, S0 + i:S0 + i + 1]
            jc, jl = jm.decode_step(params, jc, jnp.asarray(tok), S0 + i)
            tc, tl = tm.decode_step(tc, torch.from_numpy(tok), S0 + i)
            pairs.append((jl, tl))
    return pairs, tc, jc


@functools.lru_cache(maxsize=None)
def _served(arch):
    """``_pair(arch)`` through ``_prefill_and_decode`` on ``_tokens``: (the
    port's model, the (JAX, port) logits, the port's caches, the JAX
    package's), once a process."""
    jm, params, tm = _pair(arch)
    pairs, tc, jc = _prefill_and_decode(jm, params, tm, _tokens(tm.cfg))
    return tm, pairs, tc, jc


@pytest.mark.parametrize("arch", PORTED)
def test_prefill_and_decode_match_jax(arch):
    """prefill of 20 tokens + 4 teacher-forced decode steps; qwen1.5-0.5b
    has tied embeddings (the head is the table, transposed), the reduced
    StableLM-12B and DeepSeek-67B head dims 20 and 8 (no power of two's
    root), the reduced Qwen2-VL M-RoPE on three equal streams, the reduced
    Mixtral MoE layers and a 64-token ring cache, the reduced
    DeepSeek-V2-Lite MLA with a dense then an MoE layer, the reduced
    Jamba two 4-layer periods of Mamba and RoPE-free attention layers with
    dense and MoE FFNs, the reduced RWKV6-3B two RWKV blocks."""
    tm, pairs, tc, _ = _served(arch)
    v = tm.cfg.vocab_size
    for step, (a, b) in enumerate(pairs):
        assert b.shape == (B, 1, 512) and b.dtype == torch.float32
        np.testing.assert_allclose(_np(b)[..., :v], _np(a)[..., :v],
                                   atol=2e-2, rtol=0, err_msg=f"step {step}")
    lengths = [c.length for c in tc if hasattr(c, "length")]
    assert lengths == [S0 + 4] * len(lengths)


@pytest.mark.parametrize("arch,bound", [("stablelm-12b", 1e-5),
                                        ("deepseek-67b", 0.0)])
def test_forward_matches_jax_where_the_scale_rounds(arch, bound):
    """Teacher-forced logits at head dims whose D^-0.5 is no power of two
    (the reduced StableLM-12B's 20, DeepSeek-67B's 8): with q scaled in
    bf16 before the kernel, as the reference's ``attend``, StableLM's
    differ from the JAX package's on 1 logit by 3.8e-6 and DeepSeek-67B's
    on none (with the scale on the f32 scores instead: 0.234 and 0.504)."""
    jm, params, tm = _pair(arch)
    toks = _tokens(tm.cfg)
    v = tm.cfg.vocab_size
    with jax.disable_jit():
        want = _np(jm.forward(params, {"tokens": jnp.asarray(toks)}))[..., :v]
    got = _np(tm.forward({"tokens": torch.from_numpy(toks)}))[..., :v]
    diff = np.abs(got - want)
    assert float(diff.max()) <= bound and int((diff > 0).sum()) <= 1


def test_unpacked_gqa_decode_matches_jax():
    """Plan(opt_gqa_pack=False): decode repeats the KV heads instead of
    folding each query group into the query axis, in both packages; the
    logits agree with the JAX model's and with the packed decode's."""
    jm, params, tm = _pair("qwen2-7b", opt_gqa_pack=False)
    assert tm.cfg.n_heads > tm.cfg.n_kv_heads      # the GQA case
    toks = _tokens(tm.cfg)
    v = tm.cfg.vocab_size
    pairs, _, _ = _prefill_and_decode(jm, params, tm, toks)
    packed = build_model(tm.cfg, device="cpu")
    packed.load_state_dict(tm.state_dict())
    tc = packed.init_decode(B, 64)
    tc, _ = packed.prefill({"tokens": torch.from_numpy(toks[:, :S0])}, tc)
    for step, (a, b) in enumerate(pairs):
        np.testing.assert_allclose(_np(b)[..., :v], _np(a)[..., :v],
                                   atol=2e-2, rtol=0, err_msg=f"step {step}")
        if step:
            tok = torch.from_numpy(toks[:, S0 + step - 1:S0 + step])
            tc, want = packed.decode_step(tc, tok, S0 + step - 1)
            np.testing.assert_allclose(_np(b), _np(want), atol=1e-3, rtol=0,
                                       err_msg=f"step {step}")


def test_padded_heads_match_jax():
    """Plan(tp=2): 7 query heads padded to 8 (the pad masked to zero), the
    KV head replicated to 2, as the JAX package lays a model out for
    2-way tensor parallelism; the forward logits agree."""
    jcfg, tcfg = jconfigs.get_reduced("qwen2-7b"), \
        tconfigs.get_reduced("qwen2-7b")
    jm = jbuild(jcfg, JPlan(tp=2))
    params = jm.init_params(jax.random.PRNGKey(6))
    tm = build_model(tcfg, Plan(tp=2), device="cpu")
    tm.load_state_dict(convert.model_params_from_numpy(
        tcfg, jax.tree.map(np.asarray, params), device="cpu"))
    assert tm.stack.layers[0].attn.wq.shape == (64, 8, 16)
    assert tm.stack.layers[0].attn.wk.shape == (64, 2, 16)
    toks = _tokens(tcfg)
    with jax.disable_jit():
        want = _np(jm.forward(params, {"tokens": jnp.asarray(toks)}))
    got = tm.forward({"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_np(got), want, atol=2e-2, rtol=0)


@pytest.mark.parametrize("arch", ["qwen2-7b", "qwen1.5-0.5b"] + MOE +
                         ["rwkv6-3b"])
def test_decode_matches_forward(arch):
    """prefill + decode_step logits == the full forward's (exact cache;
    MoE drop-free; Mamba's and RWKV's carried states), as
    tests/test_models.py:49-76 holds the JAX package."""
    cfg = tconfigs.get_reduced(arch)
    m = build_model(cfg, Plan(moe_capacity=0), device="cpu").init_params(
        torch.Generator().manual_seed(1))
    toks = torch.from_numpy(_tokens(cfg))
    full = m.forward({"tokens": toks})
    caches = m.init_decode(B, 64)
    caches, lg = m.prefill({"tokens": toks[:, :S0]}, caches)
    errs = [float((lg[:, 0] - full[:, S0 - 1]).abs().max())]
    for i in range(4):
        caches, lg = m.decode_step(caches, toks[:, S0 + i:S0 + i + 1],
                                   S0 + i)
        errs.append(float((lg[:, 0] - full[:, S0 + i]).abs().max()))
    assert max(errs) < 1e-3, errs


def test_jax_prefill_continues_in_port_decode():
    """A jitted JAX prefill's caches go to the port (``kv_caches_from_numpy``)
    and the port decodes on: the same logits as the JAX decode from the
    same caches."""
    jm, params, tm = _pair("qwen2-7b", seed=3)
    toks = _tokens(tm.cfg, seed=4)
    jc = jm.init_decode(B, 32)
    jc, _ = jax.jit(jm.prefill)(params, {"tokens": jnp.asarray(toks[:, :S0])},
                                jc)
    tc = convert.kv_caches_from_numpy(tm.cfg, jax.tree.map(np.asarray, jc),
                                      device="cpu")
    assert len(tc) == 2 and tc[1].length == S0 and tc[1].k.shape == \
        (B, 32, 1, 16)
    with jax.disable_jit():
        for i in range(3):
            tok = toks[:, S0 + i:S0 + i + 1]
            jc, jl = jm.decode_step(params, jc, jnp.asarray(tok), S0 + i)
            tc, tl = tm.decode_step(tc, torch.from_numpy(tok), S0 + i)
            np.testing.assert_allclose(_np(tl)[..., :512], _np(jl)[..., :512],
                                       atol=2e-2, rtol=0)
    np.testing.assert_array_equal(_np(tc[0].k),
                                  _np(jax.tree.leaves(jc)[0][0]))


@pytest.mark.parametrize("arch", MOE)
def test_moe_state_matches_the_jax_tree(arch):
    """Every JAX leaf of the MoE / MLA trees lands on one port parameter of
    its shape and dtype (the router in f32), the groups unstacked into
    layers; the same number of values; the forward's summed load-balance
    loss (``Model._last_aux``) within 1e-6 relative of the JAX model's."""
    jm, params, tm = _pair(arch)
    state = convert.model_params_from_numpy(
        tm.cfg, jax.tree.map(np.asarray, params), device="cpu")
    own = tm.state_dict()
    assert sorted(state) == sorted(own)
    for name, x in state.items():
        assert x.shape == own[name].shape and x.dtype == own[name].dtype
    assert own["stack.layers.1.ffn.router"].dtype == torch.float32
    assert sum(x.numel() for x in state.values()) == \
        sum(np.size(x) for x in jax.tree.leaves(params)) == \
        param_count(model_spec(tm.cfg, tm.plan))
    toks = _tokens(tm.cfg)
    with jax.disable_jit():
        jm.forward(params, {"tokens": jnp.asarray(toks)})
    tm.forward({"tokens": torch.from_numpy(toks)})
    want = float(jm._last_aux)
    assert want > 0
    np.testing.assert_allclose(float(tm._last_aux), want, rtol=1e-6)


def test_mla_latent_cache_matches_jax():
    """After a 20-token prefill and 4 decode steps, every layer's latent
    cache (c_kv in the k slot, the RoPE key in the v slot) and length
    equal the JAX package's, read through ``kv_caches_from_numpy``."""
    tm, _, tc, jc = _served("deepseek-v2-lite")
    want = convert.kv_caches_from_numpy(tm.cfg, jax.tree.map(np.asarray, jc),
                                        device="cpu")
    m = tm.cfg.mla
    assert len(tc) == len(want) == tm.cfg.n_layers
    for got, ref in zip(tc, want):
        assert got.k.shape == (B, 64, 1, m.kv_lora_rank)
        assert got.v.shape == (B, 64, 1, m.qk_rope_head_dim)
        assert got.length == ref.length == S0 + 4
        assert torch.equal(got.k, ref.k) and torch.equal(got.v, ref.v)


@pytest.mark.parametrize("arch,s_max", [("deepseek-v2-lite", 32),
                                        ("mixtral-8x22b", S0)])
def test_jax_prefill_continues_in_port_decode_moe(arch, s_max):
    """A jitted JAX prefill and two eager JAX decode steps hand their
    caches to the port (``kv_caches_from_numpy``): DeepSeek-V2-Lite's
    latent caches, and Mixtral's ring of ``S0`` slots whose length is
    already past it.  The port decodes on with the JAX decode's logits
    from the same caches."""
    jm, params, tm = _pair(arch, seed=3)
    toks = _tokens(tm.cfg, seed=4)
    jc = jm.init_decode(B, s_max)
    jc, _ = jax.jit(jm.prefill)(params, {"tokens": jnp.asarray(toks[:, :S0])},
                                jc)
    with jax.disable_jit():
        for i in range(2):
            jc, _ = jm.decode_step(params, jc, jnp.asarray(
                toks[:, S0 + i:S0 + i + 1]), S0 + i)
        tc = convert.kv_caches_from_numpy(tm.cfg, jax.tree.map(np.asarray, jc),
                                          device="cpu")
        assert tc[1].length == S0 + 2
        if arch == "mixtral-8x22b":
            assert tc[1].k.shape[1] == S0 < tc[1].length     # wrapped ring
        for i in range(2, 4):
            tok = toks[:, S0 + i:S0 + i + 1]
            jc, jl = jm.decode_step(params, jc, jnp.asarray(tok), S0 + i)
            tc, tl = tm.decode_step(tc, torch.from_numpy(tok), S0 + i)
            np.testing.assert_allclose(_np(tl)[..., :512], _np(jl)[..., :512],
                                       atol=2e-2, rtol=0)


@pytest.mark.parametrize("arch", SSM)
def test_recurrent_states_match_jax(arch):
    """After ``_served``'s 20-token prefill and 4 decode steps, every
    layer's cache against the JAX package's, read through
    ``kv_caches_from_numpy``: a Mamba layer's ``MambaState`` (conv bf16,
    ssm f32), an RWKV layer's ``RWKVState`` (x_tm, x_cm bf16, wkv f32),
    Jamba's attention layers' KV caches.  Shapes and dtypes equal; the
    bf16 leaves within 2e-2 plus one bf16 ulp (bitwise on the CPU these
    tests were written on), the f32 recurrent states within 1e-4 (7.2e-7
    there: the f32 reductions round apart)."""
    from repro_torch.models import transformer
    tm, _, tc, jc = _served(arch)
    want = convert.kv_caches_from_numpy(tm.cfg, jax.tree.map(np.asarray, jc),
                                        device="cpu")
    kinds = [transformer.layer_def(tm.cfg, i).mixer
             for i in range(tm.cfg.n_layers)]
    assert len(tc) == len(want) == len(kinds)
    names = {"mamba": "MambaState", "rwkv": "RWKVState", "attn": "KVCache"}
    for i, (kind, got, ref) in enumerate(zip(kinds, tc, want)):
        assert type(got) is type(ref) and type(got).__name__ == names[kind]
        fields = type(ref)._fields
        if kind == "attn":
            assert got.length == ref.length == S0 + 4
            fields, got, ref = fields[:2], got[:2], ref[:2]
        for name, a, b in zip(fields, got, ref):
            assert a.shape == b.shape and a.dtype == b.dtype, (i, name)
            if a.dtype == torch.float32:
                assert float((a - b).abs().max()) <= 1e-4, (i, name)
            else:
                assert _ulp_excess(a, b) <= 2e-2, (i, name)


@pytest.mark.parametrize("arch", SSM)
def test_jax_prefill_continues_in_port_decode_ssm(arch):
    """A jitted JAX prefill's caches (Mamba's conv / ssm states, RWKV's
    token-shift inputs and wkv states, Jamba's attention KV caches) go to
    the port (``kv_caches_from_numpy``) and the port decodes on: the same
    logits as the eager JAX decode from the same caches."""
    jm, params, tm = _pair(arch, seed=3)
    toks = _tokens(tm.cfg, seed=4)
    jc = jm.init_decode(B, 32)
    jc, _ = jax.jit(jm.prefill)(params, {"tokens": jnp.asarray(toks[:, :S0])},
                                jc)
    tc = convert.kv_caches_from_numpy(tm.cfg, jax.tree.map(np.asarray, jc),
                                      device="cpu")
    own = tm.init_decode(B, 32)
    assert [type(c) for c in tc] == [type(c) for c in own]
    for got, ref in zip(tc, own):
        for a, b in zip(got, ref):
            if isinstance(b, torch.Tensor):
                assert a.shape == b.shape and a.dtype == b.dtype
    with jax.disable_jit():
        for i in range(3):
            tok = toks[:, S0 + i:S0 + i + 1]
            jc, jl = jm.decode_step(params, jc, jnp.asarray(tok), S0 + i)
            tc, tl = tm.decode_step(tc, torch.from_numpy(tok), S0 + i)
            np.testing.assert_allclose(_np(tl)[..., :512], _np(jl)[..., :512],
                                       atol=2e-2, rtol=0)


def _ring_run(prompt, steps, seed=2):
    """The reduced Mixtral (window 64) in both packages: a prefill of
    ``prompt`` tokens into caches of 256 slots (a 64-slot ring), then
    ``steps`` decode steps of token 0, as tests/test_models.py:76-91.
    Returns the (JAX, port) logits of every step and both packages'
    caches."""
    jm, params, tm = _pair("mixtral-8x22b", seed=seed)
    toks = np.random.default_rng(seed).integers(
        0, tm.cfg.vocab_size, (1, prompt)).astype(np.int32)
    tok = np.zeros((1, 1), np.int32)
    with jax.disable_jit():
        jc, jl = jm.prefill(params, {"tokens": jnp.asarray(toks)},
                            jm.init_decode(1, 256))
        tc, tl = tm.prefill({"tokens": torch.from_numpy(toks)},
                            tm.init_decode(1, 256))
        pairs = [(jl, tl)]
        for i in range(steps):
            jc, jl = jm.decode_step(params, jc, jnp.asarray(tok), prompt + i)
            tc, tl = tm.decode_step(tc, torch.from_numpy(tok), prompt + i)
            pairs.append((jl, tl))
    return pairs, tc, jc, tm


def _ulp_excess(got, want):
    """How far ``got`` strays beyond one bf16 ulp of ``want`` (2^-7 of its
    magnitude), elementwise max."""
    got, want = _np(got), _np(want)
    return float((np.abs(got - want) - np.abs(want) * 2 ** -7).max())


def _assert_ring_matches(pairs, tc, jc, tm, length):
    """Every step's logits within 2e-2 of the JAX package's and the final
    ring caches equal (both bitwise on the CPU these tests were written
    on)."""
    for step, (a, b) in enumerate(pairs):
        np.testing.assert_allclose(_np(b)[..., :512], _np(a)[..., :512],
                                   atol=2e-2, rtol=0, err_msg=f"step {step}")
        assert bool(torch.isfinite(b[..., :512]).all())
    want = convert.kv_caches_from_numpy(tm.cfg, jax.tree.map(np.asarray, jc),
                                        device="cpu")
    for got, ref in zip(tc, want):
        assert got.k.shape[1] == tm.cfg.sliding_window == 64
        assert got.length == ref.length == length
        assert torch.equal(got.k, ref.k) and torch.equal(got.v, ref.v)


def test_swa_ring_buffer_decode_matches_jax():
    """tests/test_models.py:76-91 held against the JAX package: a 16-token
    prompt and 80 decode steps, past the 64-token window (the ring wraps
    at step 48); every step's logits within 2e-2 of eager JAX and the
    ring caches equal (``_assert_ring_matches``).  The same steps
    over a plain 96-slot cache with the window mask give the ring's
    attention outputs, layer by layer on the same inputs, within 2e-2
    plus one bf16 ulp."""
    pairs, tc, jc, tm = _ring_run(16, 80)
    _assert_ring_matches(pairs, tc, jc, tm, 96)
    from repro_torch.models import attention
    full = [attention.init_kv_cache(1, 96, 2, 16, False, device="cpu")
            for _ in range(tm.cfg.n_layers)]
    toks = np.random.default_rng(2).integers(0, 512, (1, 16))
    full, _ = tm.prefill({"tokens": torch.from_numpy(toks)}, full)
    ring, _ = tm.prefill({"tokens": torch.from_numpy(toks)},
                         tm.init_decode(1, 256))
    real, calls, excess = attention.gqa_forward, [0], []

    def both(p, h, cfg, plan, *, cache, decode, **kw):
        i = calls[0] % cfg.n_layers
        calls[0] += 1
        y, c = real(p, h, cfg, plan, cache=cache, decode=decode, **kw)
        want, full[i] = real(p, h, cfg, plan, cache=full[i], decode=decode,
                             **kw)
        excess.append(_ulp_excess(y, want))
        return y, c

    tok = torch.zeros((1, 1), dtype=torch.long)
    attention.gqa_forward = both
    try:
        for i in range(80):
            ring, _ = tm.decode_step(ring, tok, 16 + i)
    finally:
        attention.gqa_forward = real
    assert len(excess) == 160 and max(excess) <= 2e-2
    assert ring[0].length == full[0].length == 96


def test_swa_ring_prefill_tail_matches_jax():
    """A 128-token prompt at window 64: the prefill keeps its last 64 keys
    in the ring (length 128), then 8 decode steps; logits within 2e-2 of
    eager JAX and the ring caches equal (``_assert_ring_matches``)."""
    pairs, tc, jc, tm = _ring_run(128, 8, seed=5)
    _assert_ring_matches(pairs, tc, jc, tm, 136)


# ---------------- VLM (Qwen2-VL) ----------------

def _positions3(nv_side, s_text, b=B):
    """Qwen2-VL's (t, h, w) streams for a square vision grid of
    ``nv_side`` x ``nv_side`` tokens (t 0, h the row, w the column), then
    ``s_text`` text positions from ``nv_side`` on all three streams:
    (3, b, nv_side^2 + s_text) int32."""
    row, col = np.divmod(np.arange(nv_side * nv_side), nv_side)
    text = nv_side + np.arange(s_text)
    streams = [np.concatenate([v, text]) for v in
               (np.zeros_like(row), row, col)]
    return np.broadcast_to(np.stack(streams)[:, None],
                           (3, b, nv_side * nv_side + s_text)).astype(np.int32)


def test_mrope_angles_match_jax_bitwise():
    """``mrope_angles`` on distinct (t, h, w) streams, at Qwen2-VL's full
    head dim 128 (sections 16 / 24 / 24) and the reduced 16 (2 / 3 / 3):
    the frequency slots of each section take their stream's angles,
    bitwise; on three equal streams they are ``rope_angles``'."""
    pos3 = _positions3(32, 40)
    for dim, sections in ((128, (16, 24, 24)), (16, (2, 3, 3))):
        want = np.asarray(jlayers.mrope_angles(jnp.asarray(pos3), dim, 1e6,
                                               sections))
        got = tlayers.mrope_angles(torch.from_numpy(pos3), dim, 1e6,
                                   sections)
        assert got.shape == (B, 1064, dim // 2)
        np.testing.assert_array_equal(got.numpy(), want)
        same = torch.from_numpy(np.broadcast_to(pos3[0], (3,) + pos3.shape[1:])
                                .copy())
        np.testing.assert_array_equal(
            tlayers.mrope_angles(same, dim, 1e6, sections).numpy(),
            tlayers.rope_angles(same[0], dim, 1e6).numpy())


def test_vlm_prefill_and_decode_match_jax():
    """The reduced Qwen2-VL: a prefill of 16 random vision embeddings (a
    4 x 4 grid in ``positions3``) before 20 tokens, then 4 teacher-forced
    decode steps at positions 36.. (three equal streams); logits within
    2e-2 of the JAX package's, the caches hold 40 tokens.  The streams
    matter: the same prefill with broadcast positions gives other
    logits."""
    jm, params, tm = _pair("qwen2-vl-72b")
    cfg = tm.cfg
    nv = cfg.n_vision_tokens
    toks = _tokens(cfg)
    jv, tv = _bf(np.random.default_rng(8).normal(size=(B, nv, cfg.d_model)))
    pos3 = _positions3(4, S0)
    v = cfg.vocab_size
    with jax.disable_jit():
        jc, jl = jm.prefill(params, {"tokens": jnp.asarray(toks[:, :S0]),
                                     "vision_embeds": jv,
                                     "positions3": jnp.asarray(pos3)},
                            jm.init_decode(B, 64))
        tc, tl = tm.prefill({"tokens": torch.from_numpy(toks[:, :S0]),
                             "vision_embeds": tv,
                             "positions3": torch.from_numpy(pos3)},
                            tm.init_decode(B, 64))
        pairs = [(jl, tl)]
        for i in range(4):
            tok = toks[:, S0 + i:S0 + i + 1]
            jc, jl = jm.decode_step(params, jc, jnp.asarray(tok), nv + S0 + i)
            tc, tl = tm.decode_step(tc, torch.from_numpy(tok), nv + S0 + i)
            pairs.append((jl, tl))
    for step, (a, b) in enumerate(pairs):
        np.testing.assert_allclose(_np(b)[..., :v], _np(a)[..., :v],
                                   atol=2e-2, rtol=0, err_msg=f"step {step}")
    assert tc[0].length == nv + S0 + 4
    _, flat = tm.prefill({"tokens": torch.from_numpy(toks[:, :S0]),
                          "vision_embeds": tv}, tm.init_decode(B, 64))
    assert float((flat - pairs[0][1]).abs().max()) > 1e-2


def test_vlm_serve_holds_the_vision_prefix():
    """``serve.run`` of the reduced Qwen2-VL decodes 32 tokens after 16
    zero vision embeddings and 64 prompt tokens: its cache holds 64 + 16 +
    32 + 8 slots, so every decode position fits (the JAX package's 104
    slots end at 103, and its decode from step 24 on overwrites slot 103);
    each greedy token is the argmax of a teacher-forced forward up to one
    bf16 ulp of the logit (the logits are bf16 products; the decode's
    ``attend`` and the forward's kernel round apart, so a near tie may go
    either way)."""
    res = serve.run("qwen2-vl-72b", prompt_len=64, gen=32, batch=2, seed=5,
                    device="cpu")
    vis = res.batch["vision_embeds"]
    assert vis.shape == (2, 16, 64) and not vis.any()
    assert res.tokens.shape == (2, 32)
    seq = torch.cat([res.prompt, torch.from_numpy(res.tokens[:, :-1])], 1)
    full = res.model.forward({"tokens": seq, "vision_embeds": vis})[
        :, 16 + 63:, :512]
    picked = full.gather(-1, torch.from_numpy(res.tokens)[..., None])[..., 0]
    top = full.amax(-1)
    assert bool((top - picked <= top.abs() * 2 ** -7).all())


def test_vlm_serve_matches_jax_until_its_cache_overruns():
    """The JAX package's ``serve.run("qwen2-vl-72b")`` (run eagerly) and the
    port's ``serve_batch`` on the same weights and prompt: the greedy
    tokens agree up to the reference's decode step 24, the first whose
    write falls past its cache (position 104 of 104 slots, clamped onto
    slot 103); the port's cache holds all 32."""
    from repro.launch import serve as jserve
    jcfg = jconfigs.get_reduced("qwen2-vl-72b")
    key = jax.random.PRNGKey(0)
    params = jbuild(jcfg, JPlan(moe_capacity=0)).init_params(key)
    prompt = np.array(jax.random.randint(jax.random.fold_in(key, 1),
                                           (2, 64), 0, jcfg.vocab_size))
    with jax.disable_jit():
        want = jserve.run("qwen2-vl-72b", prompt_len=64, gen=32, batch=2,
                          seed=0)
    tm = build_model(tconfigs.get_reduced("qwen2-vl-72b"),
                     Plan(moe_capacity=0), device="cpu")
    tm.load_state_dict(convert.model_params_from_numpy(
        tm.cfg, jax.tree.map(np.asarray, params), device="cpu"))
    got, _, logits, _ = serve.serve_batch(tm, {
        "tokens": torch.from_numpy(prompt).long(),
        "vision_embeds": torch.zeros(2, 16, 64, dtype=torch.bfloat16)}, 32)
    assert got.shape == want.shape == (2, 32)
    # token i + 1 comes from decode step i
    np.testing.assert_array_equal(got[:, :25], want[:, :25])
    assert bool(torch.isfinite(logits[..., :512]).all())


# ---------------- serving ----------------

def test_serve_run_on_cpu():
    """``serve.run`` at reduced size on the CPU: greedy tokens are the
    argmax of a teacher-forced forward over prompt + output, and no kernel
    launches."""
    before = fa_kernel.COUNTER.launches
    res = serve.run("qwen2-7b", prompt_len=16, gen=4, batch=2, seed=5,
                    device="cpu")
    assert fa_kernel.COUNTER.launches == before
    assert res.tokens.shape == (2, 4) and res.prompt.shape == (2, 16)
    assert res.prefill_logits.shape == res.logits.shape == (2, 1, 512)
    assert bool(torch.isfinite(res.logits).all())
    assert set(res.timings) == {"prefill_s", "decode_s", "ms_per_step",
                                "tok_s"}
    seq = torch.cat([res.prompt, torch.from_numpy(res.tokens[:, :-1])], 1)
    full = res.model.forward({"tokens": seq})
    np.testing.assert_array_equal(full[:, 15:].argmax(-1).numpy(), res.tokens)


def test_serve_run_moe_on_cpu():
    """``serve.run`` of the reduced DeepSeek-V2-Lite on the CPU builds the
    model drop-free (``Plan(moe_capacity=0)``, as the JAX package's
    ``serve.run``), and its greedy tokens are the argmax of a
    teacher-forced forward over prompt + output."""
    res = serve.run("deepseek-v2-lite", prompt_len=16, gen=4, batch=2, seed=5,
                    device="cpu")
    assert res.model.plan.moe_capacity == 0
    assert res.tokens.shape == (2, 4)
    assert bool(torch.isfinite(res.logits[..., :512]).all())
    seq = torch.cat([res.prompt, torch.from_numpy(res.tokens[:, :-1])], 1)
    full = res.model.forward({"tokens": seq})
    np.testing.assert_array_equal(full[:, 15:].argmax(-1).numpy(), res.tokens)

@pytest.mark.parametrize("arch", SSM)
def test_serve_run_ssm_on_cpu(arch, monkeypatch):
    """``serve.run(..., figkv=True)`` of the reduced Jamba and RWKV6-3B on
    the CPU: greedy tokens are the argmax of a teacher-forced forward over
    prompt + output; RWKV is attention-free, so the FIGCache-KV demo is
    skipped, as the JAX package skips it; Jamba's runs."""
    demos = []
    monkeypatch.setattr(serve, "demo_figkv",
                        lambda *a, **k: demos.append(a[0].name))
    res = serve.run(arch, prompt_len=16, gen=4, batch=2, seed=5, figkv=True,
                    device="cpu")
    assert demos == ([] if res.model.cfg.attn_free else [res.model.cfg.name])
    assert res.tokens.shape == (2, 4)
    assert bool(torch.isfinite(res.logits[..., :512]).all())
    seq = torch.cat([res.prompt, torch.from_numpy(res.tokens[:, :-1])], 1)
    full = res.model.forward({"tokens": seq})
    np.testing.assert_array_equal(full[:, 15:].argmax(-1).numpy(), res.tokens)


def test_serve_main_needs_cuda(monkeypatch):
    """The command line runs on the card; without one it raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr("sys.argv", ["serve", "--arch", "qwen2-7b",
                                     "--prompt-len", "4", "--gen", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device to launch the flash_attention kernel")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_prefill_launches_the_kernel_per_layer(cuda_device):
    """The same weights on the card: one flash_attention launch per layer
    per prefill, logits within bf16 noise of the CPU's plain version."""
    cfg = tconfigs.get_reduced("qwen2-7b")
    cpu = build_model(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    gpu = build_model(cfg, device=cuda_device)
    gpu.load_state_dict(cpu.state_dict())
    toks = torch.from_numpy(_tokens(cfg))
    _, want = cpu.prefill({"tokens": toks}, cpu.init_decode(B, S))
    before = fa_kernel.COUNTER.launches
    _, got = gpu.prefill({"tokens": toks.to(cuda_device)},
                         gpu.init_decode(B, S))
    torch.cuda.synchronize()
    assert fa_kernel.COUNTER.launches == before + cfg.n_layers
    torch.testing.assert_close(got.cpu(), want, atol=5e-2, rtol=0)
