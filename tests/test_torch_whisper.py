"""The port's Whisper (``repro_torch.models.whisper``: the encoder over frame
embeddings, the decoder with self-attention caches and cross-attention, the
encoder-decoder branches of ``Model``; ``layers.layer_norm``,
``sinusoid_positions``, ``gelu_mlp`` with XLA's f32 tanh
``xla_math.tanh_f32``; ``attention.gqa_forward``'s ``cross_kv``) against
the JAX package's ``repro.models``.

The JAX model runs eagerly (``jax.disable_jit()``), one XLA computation a
primitive, as in ``test_torch_models.py``: there ``jax.nn.gelu`` is the
f32 multiplies and adds of its formula, each rounded, around XLA's
``tanh``, and the port reproduces it bit for bit.  (Under ``jit`` XLA
fuses the formula and contracts some of its multiply-adds: the jitted
GELU differs from the eager one on a few percent of normal draws, counts
printed by ``test_gelu_matches_jax_bitwise`` under ``-s``.)
The models' logits are held to the 2e-2 absolute of the LM tests."""
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
from repro.models import whisper as jwhisper
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.core.workload.xla_math import tanh_f32
from repro_torch.kernels.flash_attention import flash_attention as fa_kernel
from repro_torch.launch import serve
from repro_torch.models import Plan, attention, build_model, whisper
from repro_torch.models import layers as tlayers
from repro_torch.models.model import model_spec
from repro_torch.models.param import param_count

ARCH = "whisper-tiny"
B, S, S0 = 2, 24, 20


def _bf(x):
    """numpy -> the bf16 values as a JAX array and a torch tensor."""
    j = jnp.asarray(x, jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j, np.float32)).to(torch.bfloat16)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _pair(seed=1, **plan):
    jcfg, tcfg = jconfigs.get_reduced(ARCH), tconfigs.get_reduced(ARCH)
    jm = jbuild(jcfg, JPlan(**plan))
    params = jm.init_params(jax.random.PRNGKey(seed))
    tm = build_model(tcfg, Plan(**plan), device="cpu")
    tm.load_state_dict(convert.model_params_from_numpy(
        tcfg, jax.tree.map(np.asarray, params), device="cpu"))
    return jm, params, tm


def _inputs(cfg, seed=2):
    """Tokens (B, S) and frame embeddings (B, F, d), N(0, 1) x 0.1 in bf16
    as the JAX package's serve draws them."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    ja, ta = _bf(rng.normal(size=(B, cfg.n_audio_frames, cfg.d_model)) * 0.1)
    return toks, ja, ta


# ---------------- layers ----------------

def _draws(seed=0):
    """f32 inputs: normal draws at scales 0.1, 1 and 3 (2^20 each), 2^18
    random bit patterns over every finite value and their negatives, and
    2^18 points evenly over [-25, 25] (past both clamps)."""
    rng = np.random.default_rng(seed)
    xs = [(rng.normal(size=1 << 20) * s).astype(np.float32)
          for s in (0.1, 1, 3)]
    bits = rng.integers(0, 0x7F800000, 1 << 18).astype(np.uint32)
    bits[::2] |= 1 << 31
    xs.append(bits.view(np.float32))
    xs.append(np.linspace(-25, 25, 1 << 18, dtype=np.float32))
    return xs


def test_tanh_f32_matches_xla_bitwise(capsys):
    """``xla_math.tanh_f32`` gives the bits of ``jnp.tanh`` (XLA's CPU
    build) on every input of ``_draws``; torch's ``tanh`` differs on most
    (counts printed under ``-s``)."""
    for x in _draws():
        with jax.disable_jit():
            want = _bits(jnp.tanh(jnp.asarray(x)))
        got = tanh_f32(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(_bits(got), want)
        off = int((_bits(torch.tanh(torch.from_numpy(x)).numpy())
                   != want).sum())
        print(f"torch.tanh differs from jnp.tanh on {off} of {x.size}")


def test_gelu_matches_jax_bitwise():
    """``layers.gelu_tanh`` (XLA's tanh inside the formula's rounded f32
    steps) gives the bits of the eager ``jax.nn.gelu(approximate=True)``
    on ``_draws``' normal draws; ``F.gelu(approximate="tanh")`` does not.
    Printed under ``-s``: torch's mismatches in f32 and after the cast to
    bf16, and the jitted JAX GELU's against its own eager form."""
    gelu = lambda a: jax.nn.gelu(a, approximate=True)  # noqa: E731
    for x in _draws()[:3]:
        with jax.disable_jit():
            want = _bits(gelu(jnp.asarray(x)))
        got = tlayers.gelu_tanh(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(_bits(got), want)
        torch_gelu = torch.nn.functional.gelu(torch.from_numpy(x),
                                              approximate="tanh")
        off = int((_bits(torch_gelu.numpy()) != want).sum())
        assert off > 0
        bf = lambda a: _bits(np.asarray(  # noqa: E731
            jnp.asarray(a, jnp.float32).astype(jnp.bfloat16), np.float32))
        off_bf = int((bf(torch_gelu.numpy()) != bf(want.view(np.float32)))
                     .sum())
        jitted = int((_bits(jax.jit(gelu)(jnp.asarray(x))) != want).sum())
        print(f"F.gelu differs from the eager jax.nn.gelu on {off} of "
              f"{x.size} ({off_bf} after the cast to bf16); the jitted "
              f"jax.nn.gelu on {jitted}")


def test_layer_functions_match_jax_bitwise():
    """layer_norm (f32 mean and variance, rsqrt, bf16 round, times the
    weight plus the bias) and gelu_mlp (bf16 products and biases, GELU in
    f32) bitwise."""
    rng = np.random.default_rng(0)
    jx, tx = _bf(rng.normal(size=(2, 24, 64)) * 3 + 1)
    jw, tw = _bf(rng.normal(size=64))
    jb, tb = _bf(rng.normal(size=64))
    np.testing.assert_array_equal(
        _np(jlayers.layer_norm(jx, {"w": jw, "b": jb}, 1e-5)),
        _np(tlayers.layer_norm(tx, {"w": tw, "b": tb}, 1e-5)))
    jp, tp = {}, {}
    for name, shape, s in (("wi", (64, 256), 0.2), ("bi", (256,), 1.0),
                           ("wo", (256, 64), 0.1), ("bo", (64,), 1.0)):
        jp[name], tp[name] = _bf(rng.normal(size=shape) * s)
    with jax.disable_jit():
        want = _np(jlayers.gelu_mlp(jp, jx))
    np.testing.assert_array_equal(_np(tlayers.gelu_mlp(tp, tx)), want)


@pytest.mark.parametrize("n,d", [(32, 64), (1500, 384)])
def test_sinusoid_positions_match_jax_bitwise(n, d):
    """Whisper's sinusoids at the reduced and the full encoder size: the
    power ``10000 ** (-i / (d/2 - 1))`` correctly rounded, glibc's
    ``sinf`` / ``cosf``: bitwise."""
    with jax.disable_jit():
        want = np.asarray(jlayers.sinusoid_positions(n, d))
    got = tlayers.sinusoid_positions(n, d)
    assert got.dtype == torch.float32 and got.shape == (n, d)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


# ---------------- parameters ----------------

def test_state_matches_the_jax_tree():
    """Every JAX leaf (``enc`` / ``dec`` stacked, ``enc_ln``, ``dec_ln``,
    ``tok_embed``, ``pos_embed``) lands on one port parameter of its shape
    and dtype, one per layer; the port's spec counts the JAX spec's
    parameters, at full width too."""
    _, params, tm = _pair()
    state = convert.model_params_from_numpy(
        tm.cfg, jax.tree.map(np.asarray, params), device="cpu")
    own = tm.state_dict()
    assert sorted(state) == sorted(own)
    assert "enc.1.attn.wq" in own and "dec.1.xattn.wk" in own
    for name, x in state.items():
        assert x.shape == own[name].shape and x.dtype == own[name].dtype
    assert sum(x.numel() for x in state.values()) == \
        sum(np.size(x) for x in jax.tree.leaves(params))
    for get in ("get", "get_reduced"):
        jspec = jbuild(getattr(jconfigs, get)(ARCH), JPlan()).spec()
        want = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(jspec))
        assert param_count(model_spec(getattr(tconfigs, get)(ARCH),
                                      Plan())) == want


# ---------------- model ----------------

def test_encode_matches_jax():
    """The encoder (sinusoids, layer norms, non-causal attention through
    the kernel's plain version with q scaled in bf16, GELU MLPs) against
    the JAX ``encode``: within 2e-2 (the kernel's plain version takes the
    softmax before ``p @ v``, the reference's ``attend`` divides after, so
    a few outputs round one bf16 ulp apart)."""
    jm, params, tm = _pair()
    _, ja, ta = _inputs(tm.cfg)
    with jax.disable_jit():
        want = _np(jwhisper.encode(params, ja, jm.cfg, jm.plan))
    got = whisper.encode(tm, ta, tm.cfg, tm.plan)
    assert got.shape == (B, tm.cfg.n_audio_frames, tm.cfg.d_model)
    np.testing.assert_allclose(_np(got), want, atol=2e-2, rtol=0)


def test_forward_matches_jax():
    """Teacher-forced logits of the whole encoder-decoder within 2e-2."""
    jm, params, tm = _pair()
    toks, ja, ta = _inputs(tm.cfg)
    with jax.disable_jit():
        want = _np(jm.forward(params, {"tokens": jnp.asarray(toks),
                                       "audio_embeds": ja}))
    got = tm.forward({"tokens": torch.from_numpy(toks), "audio_embeds": ta})
    v = tm.cfg.vocab_size
    assert got.shape == (B, S, 512)
    np.testing.assert_allclose(_np(got)[..., :v], want[..., :v], atol=2e-2,
                               rtol=0)


def _prefill_and_decode(jm, params, tm, toks, ja, ta, steps=4):
    with jax.disable_jit():
        jc, jl = jm.prefill(params, {"tokens": jnp.asarray(toks[:, :S0]),
                                     "audio_embeds": ja},
                            jm.init_decode(B, 64))
        tc, tl = tm.prefill({"tokens": torch.from_numpy(toks[:, :S0]),
                             "audio_embeds": ta}, tm.init_decode(B, 64))
        pairs = [(jl, tl)]
        for i in range(steps):
            tok = toks[:, S0 + i:S0 + i + 1]
            jc, jl = jm.decode_step(params, jc, jnp.asarray(tok), S0 + i)
            tc, tl = tm.decode_step(tc, torch.from_numpy(tok), S0 + i)
            pairs.append((jl, tl))
    return pairs, tc, jc


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
def test_prefill_and_decode_match_jax(kv_quant):
    """prefill of 20 tokens over the encoder's output, then 4 teacher-forced
    decode steps (learned positions ``pos_embed[pos]``, cross-attention
    over the prefill's K/V), with a bf16 and an int8 self-attention cache:
    logits within 2e-2, the caches and cross K/V near the JAX package's
    (``_assert_near``; the first layer's bitwise)."""
    jm, params, tm = _pair(kv_quant=kv_quant)
    toks, ja, ta = _inputs(tm.cfg)
    pairs, tc, jc = _prefill_and_decode(jm, params, tm, toks, ja, ta)
    v = tm.cfg.vocab_size
    for step, (a, b) in enumerate(pairs):
        assert b.shape == (B, 1, 512) and bool(torch.isfinite(b).all())
        np.testing.assert_allclose(_np(b)[..., :v], _np(a)[..., :v],
                                   atol=2e-2, rtol=0, err_msg=f"step {step}")
    assert isinstance(tc, whisper.WhisperCache)
    want = convert.kv_caches_from_numpy(tm.cfg, jax.tree.map(np.asarray, jc),
                                        device="cpu")
    assert len(tc.self_kv) == tm.cfg.n_layers
    for got, ref in zip(tc.self_kv, want.self_kv):
        assert got.length == ref.length == S0 + 4
        assert (got.k_scale is not None) == kv_quant
        for a, b in zip(got[:4], ref[:4]):
            if a is not None:
                _assert_near(a, b)
    for a, b in zip(tc.cross[0] + tc.cross[1], want.cross[0] + want.cross[1]):
        assert a.shape == (B, tm.cfg.n_audio_frames, 4, 16)
        _assert_near(a, b)


def _assert_near(got, want):
    """Cache leaves of the two packages: int8 codes within one, bf16 K/V
    and f32 scales within one bf16 ulp of the leaf's largest magnitude
    (2^-7 of it).  The encoder's attention (the kernel's plain softmax
    against the reference's online one) rounds a few outputs one bf16 ulp
    apart; the decoder's second layer and the cross K/V read them."""
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == torch.int8:
        assert int((got.int() - want.int()).abs().max()) <= 1
    else:
        g, w = _np(got), _np(want)
        assert float(np.abs(g - w).max()) <= float(np.abs(w).max()) * 2 ** -7


def test_jax_prefill_continues_in_port_decode():
    """A jitted JAX Whisper prefill's ``(caches, cross)`` go to the port
    (``kv_caches_from_numpy`` builds a ``WhisperCache``) and the port
    decodes on with the JAX decode's logits from the same state."""
    jm, params, tm = _pair(seed=3)
    toks, ja, _ = _inputs(tm.cfg, seed=4)
    jc = jm.init_decode(B, 32)
    jc, _ = jax.jit(jm.prefill)(params, {"tokens": jnp.asarray(toks[:, :S0]),
                                         "audio_embeds": ja}, jc)
    tc = convert.kv_caches_from_numpy(tm.cfg, jax.tree.map(np.asarray, jc),
                                      device="cpu")
    assert tc.self_kv[1].length == S0 and tc.self_kv[1].k.shape == \
        (B, 32, 4, 16)
    with jax.disable_jit():
        for i in range(3):
            tok = toks[:, S0 + i:S0 + i + 1]
            jc, jl = jm.decode_step(params, jc, jnp.asarray(tok), S0 + i)
            tc, tl = tm.decode_step(tc, torch.from_numpy(tok), S0 + i)
            np.testing.assert_allclose(_np(tl)[..., :512],
                                       _np(jl)[..., :512], atol=2e-2, rtol=0)


def test_decode_matches_forward():
    """prefill + decode_step logits == the teacher-forced forward's."""
    _, _, tm = _pair()
    toks, _, ta = _inputs(tm.cfg)
    toks = torch.from_numpy(toks)
    full = tm.forward({"tokens": toks, "audio_embeds": ta})
    caches, lg = tm.prefill({"tokens": toks[:, :S0], "audio_embeds": ta},
                            tm.init_decode(B, 64))
    errs = [float((lg[:, 0] - full[:, S0 - 1]).abs().max())]
    for i in range(4):
        caches, lg = tm.decode_step(caches, toks[:, S0 + i:S0 + i + 1],
                                    S0 + i)
        errs.append(float((lg[:, 0] - full[:, S0 + i]).abs().max()))
    assert max(errs) < 1e-3, errs


@pytest.mark.parametrize("decode", [False, True])
def test_gqa_forward_cross_kv_matches_jax(decode):
    """``gqa_forward(cross_kv=(k, v))``: queries of the decoder attend the
    encoder's K/V without a causal mask: 20 queries over 32 frames, or one
    decode query over a cache the cross K/V are written into, as the
    reference does."""
    _, params, tm = _pair()
    cfg = tm.cfg
    p_j = jax.tree.map(lambda a: a[0], params["dec"])["xattn"]
    p_t = tm.dec[0].xattn
    rng = np.random.default_rng(7)
    sq = 1 if decode else S0
    jx, tx = _bf(rng.normal(size=(B, sq, cfg.d_model)))
    jk, tk = _bf(rng.normal(size=(B, cfg.n_audio_frames, 4, 16)))
    jv, tv = _bf(rng.normal(size=(B, cfg.n_audio_frames, 4, 16)))
    kw_j, kw_t = {}, {}
    if decode:
        kw_j["cache"] = jattn.init_kv_cache(B, 40, 4, 16, False)
        kw_t["cache"] = attention.init_kv_cache(B, 40, 4, 16, False,
                                                device="cpu")
    with jax.disable_jit():
        want, jc = jattn.gqa_forward(p_j, jx, jconfigs.get_reduced(ARCH),
                                     JPlan(),
                                     cross_kv=(jk, jv), decode=decode, **kw_j)
    got, tc = attention.gqa_forward(p_t, tx, cfg, Plan(), cross_kv=(tk, tv),
                                    decode=decode, **kw_t)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-2, rtol=0)
    if decode:
        assert tc.length == int(jc.length) == cfg.n_audio_frames
        assert torch.equal(tc.k, convert._tensor(np.asarray(jc.k), "cpu"))


def test_decoder_cross_attention_runs_gqa_forward():
    """The decoder's cross-attention is ``gqa_forward`` given each layer's
    encoder K/V (``cross_kv``), with no cache, in the prefill and in every
    decode step; the self-attention call of each layer keeps its cache."""
    _, _, tm = _pair()
    cfg = tm.cfg
    toks, _, ta = _inputs(cfg)
    toks = torch.from_numpy(toks)
    real, seen = attention.gqa_forward, []

    def spy(p, x, cfg_, plan, **kw):
        seen.append(kw)
        return real(p, x, cfg_, plan, **kw)

    attention.gqa_forward = spy
    try:
        state, _ = tm.prefill({"tokens": toks[:, :S0], "audio_embeds": ta},
                              tm.init_decode(B, 64))
        tm.decode_step(state, toks[:, S0:S0 + 1], S0)
    finally:
        attention.gqa_forward = real
    assert len(seen) == 2 * 2 * cfg.n_layers
    cross = [kw for kw in seen if kw.get("cross_kv") is not None]
    assert len(cross) == 2 * cfg.n_layers
    ks, vs = state.cross
    for i, kw in enumerate(cross):
        ck, cv = kw["cross_kv"]
        assert ck is ks[i % cfg.n_layers] and cv is vs[i % cfg.n_layers]
        assert kw.get("cache") is None and not kw.get("decode", False)
    own = [kw for kw in seen if kw.get("cross_kv") is None]
    assert all(kw["cache"] is not None for kw in own)
    assert [kw["decode"] for kw in own] == [False] * cfg.n_layers + \
        [True] * cfg.n_layers


# ---------------- serving ----------------

def test_serve_run_whisper_on_cpu():
    """``serve.run`` of the reduced Whisper on the CPU: random frames from
    the run's generator, greedy tokens that are the argmax of a
    teacher-forced forward over prompt + output, no kernel launch."""
    before = fa_kernel.COUNTER.launches
    res = serve.run(ARCH, prompt_len=16, gen=4, batch=2, seed=5,
                    device="cpu")
    assert fa_kernel.COUNTER.launches == before
    audio = res.batch["audio_embeds"]
    assert audio.shape == (2, 32, 64) and audio.dtype == torch.bfloat16
    assert 0.05 < float(audio.float().std()) < 0.2
    assert res.tokens.shape == (2, 4)
    assert bool(torch.isfinite(res.logits[..., :512]).all())
    seq = torch.cat([res.prompt, torch.from_numpy(res.tokens[:, :-1])], 1)
    full = res.model.forward({"tokens": seq, "audio_embeds": audio})
    np.testing.assert_array_equal(full[:, 15:].argmax(-1).numpy(), res.tokens)
