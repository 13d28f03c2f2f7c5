"""The port's attention-free mixers (``repro_torch.models.mamba`` and
``repro_torch.models.rwkv6``) against the JAX package's, on the reduced
Jamba-v0.1 and RWKV6-3B configs, and ``tests/test_ssm.py``'s four
properties held on the port.

Parameters and inputs are drawn from a seed with numpy at each spec's
shape (the zeros / ones leaves jittered, so biases and scales are
exercised too) and go through both packages in f32 (held to 1e-4, as
``tests/test_ssm.py``) and in bf16 (2e-2 plus one bf16 ulp of the value:
the f32 reductions' and transcendentals' last-bit differences between
XLA and torch flip bf16 roundings inside ``rwkv_block``, and its bf16
case here ends 0.0234 apart on one of 65536 outputs, at 1.57, where a
bf16 ulp is 0.0078; past 2.56 one ulp alone is more than 2e-2).  The JAX functions run eagerly
(``jax.disable_jit()``), as the model tests do: under ``jit`` XLA keeps
bf16 intermediates in f32.  A prefill is longer than its chunk and a
multiple of it; a decode carries the state the prefill left, one token a
step."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs
from repro.models import mamba as jmamba
from repro.models import rwkv6 as jrwkv
from repro.models.param import Spec as JSpec
from repro.models.plan import Plan as JPlan
from repro_torch import configs as tconfigs
from repro_torch.models import mamba as tmamba
from repro_torch.models import rwkv6 as trwkv
from repro_torch.models.plan import Plan

JAMBA, RWKV = "jamba-v0.1-52b", "rwkv6-3b"
TOL = {"f32": 1e-4, "bf16": 2e-2}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _draw(spec, rng):
    """One leaf at the spec's shape: normal std 1/sqrt(fan_in), small 0.1,
    zeros N(0, 0.1), ones 1 + N(0, 0.1)."""
    z = rng.normal(size=spec.shape)
    if spec.init == "normal":
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        return z / np.sqrt(fan_in)
    return {"small": 0.1 * z, "zeros": 0.1 * z, "ones": 1 + 0.1 * z}[
        spec.init]


def _to_both(a, dtype):
    """numpy -> (JAX array, torch tensor) holding the same values in
    ``dtype`` ("f32" / "bf16")."""
    jd, td = DTYPES[dtype]
    j = jnp.asarray(a, jd)
    return j, torch.from_numpy(np.array(j, np.float32)).to(td)


def _params(spec_tree, seed, dtype):
    """The JAX spec tree -> (JAX params, port params), the same values."""
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree.flatten(
        spec_tree, is_leaf=lambda x: isinstance(x, JSpec))
    pairs = [_to_both(_draw(s, rng), dtype) for s in leaves]
    jp = jax.tree.unflatten(treedef, [j for j, _ in pairs])
    tp = jax.tree.unflatten(treedef, [t for _, t in pairs])
    return jp, tp


def _x(cfg, shape, seed, dtype):
    return _to_both(np.random.default_rng(seed).normal(size=shape) * 0.1,
                    dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol, what):
    """Within ``tol``; a bf16 tensor within ``tol`` plus one bf16 ulp of
    the value (2^-7 of it)."""
    rtol = 2 ** -7 if got.dtype == torch.bfloat16 else 0
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=rtol,
                               err_msg=what)


def _cfgs(arch):
    return jconfigs.get_reduced(arch), tconfigs.get_reduced(arch)


# ---------------- state ----------------

@pytest.mark.parametrize("arch", [JAMBA, RWKV])
def test_init_state_shapes_and_dtypes(arch):
    """``init_state``: the JAX package's leaves, shapes and dtypes (bf16
    conv / token-shift inputs, f32 recurrent states), all zero."""
    jcfg, tcfg = _cfgs(arch)
    jmod, tmod = (jmamba, tmamba) if arch == JAMBA else (jrwkv, trwkv)
    want, got = jmod.init_state(jcfg, 3), tmod.init_state(tcfg, 3,
                                                         device="cpu")
    assert type(got)._fields == type(want)._fields
    for name, a, b in zip(got._fields, want, got):
        assert tuple(b.shape) == a.shape, name
        assert str(b.dtype).split(".")[-1] == str(a.dtype), name
        assert not b.any(), name


# ---------------- Mamba ----------------

def _mamba_pair(dtype, seed=0):
    jcfg, tcfg = _cfgs(JAMBA)
    jp, tp = _params(jmamba.mamba_spec(jcfg, JPlan()), seed, dtype)
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("s,chunk", [(32, 8), (512, 256)])
def test_mamba_prefill_matches_jax(dtype, s, chunk):
    """A chunked prefill (S > chunk, S % chunk == 0; 256 is the default
    chunk) from a zero state: outputs and the conv / ssm states it leaves
    within the dtype's bar of the JAX package's."""
    jcfg, tcfg, jp, tp = _mamba_pair(dtype)
    jx, tx = _x(tcfg, (2, s, tcfg.d_model), 1, dtype)
    with jax.disable_jit():
        want, wst = jmamba.mamba_forward(
            jp, jx, jcfg, JPlan(), state=jmamba.init_state(jcfg, 2),
            chunk=chunk)
    got, gst = tmamba.mamba_forward(
        tp, tx, tcfg, Plan(), state=tmamba.init_state(tcfg, 2, device="cpu"),
        chunk=chunk)
    tol = TOL[dtype]
    _close(got, want, tol, "out")
    assert got.dtype == tx.dtype and gst.ssm.dtype == torch.float32
    _close(gst.conv, wst.conv, tol, "conv state")
    _close(gst.ssm, wst.ssm, tol, "ssm state")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mamba_decode_matches_jax(dtype):
    """Four decode steps continuing a 16-token prefill's state: every
    step's output and the final states within the dtype's bar."""
    jcfg, tcfg, jp, tp = _mamba_pair(dtype, seed=2)
    jx, tx = _x(tcfg, (2, 20, tcfg.d_model), 3, dtype)
    tol = TOL[dtype]
    with jax.disable_jit():
        _, jst = jmamba.mamba_forward(jp, jx[:, :16], jcfg, JPlan(),
                                      state=jmamba.init_state(jcfg, 2),
                                      chunk=8)
        _, tst = tmamba.mamba_forward(
            tp, tx[:, :16], tcfg, Plan(),
            state=tmamba.init_state(tcfg, 2, device="cpu"), chunk=8)
        for t in range(16, 20):
            want, jst = jmamba.mamba_forward(jp, jx[:, t:t + 1], jcfg,
                                             JPlan(), state=jst, decode=True)
            got, tst = tmamba.mamba_forward(tp, tx[:, t:t + 1], tcfg, Plan(),
                                            state=tst, decode=True)
            _close(got, want, tol, f"step {t}")
    assert tst.conv.shape == (2, tcfg.mamba.d_conv - 1,
                              tcfg.mamba.expand * tcfg.d_model)
    _close(tst.conv, jst.conv, tol, "conv state")
    _close(tst.ssm, jst.ssm, tol, "ssm state")


def test_causal_conv_matches_jax_bitwise():
    """The depthwise conv: the taps' bf16 products summed from the oldest,
    then the bias; padded for a prefill, after the carried inputs for a
    decode; the new state its last d_conv - 1 inputs.  Bitwise."""
    rng = np.random.default_rng(4)
    jx, tx = _to_both(rng.normal(size=(2, 9, 16)), "bf16")
    jw, tw = _to_both(rng.normal(size=(4, 16)), "bf16")
    jb, tb = _to_both(rng.normal(size=16), "bf16")
    js, ts = _to_both(rng.normal(size=(2, 3, 16)), "bf16")
    for jst, tst in ((None, None), (js, ts)):
        with jax.disable_jit():
            want, wnew = jmamba._causal_conv(jx, jw, jb, jst)
        got, gnew = tmamba._causal_conv(tx, tw, tb, tst)
        np.testing.assert_array_equal(_np(got), _np(want))
        np.testing.assert_array_equal(_np(gnew), _np(wnew))


# ---------------- RWKV-6 ----------------

def _rwkv_pair(dtype, seed=0):
    jcfg, tcfg = _cfgs(RWKV)
    jp, tp = _params(jrwkv.rwkv_spec(jcfg, JPlan()), seed, dtype)
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("s,chunk", [(32, 8), (512, 256)])
def test_time_mix_prefill_matches_jax(dtype, s, chunk):
    """``time_mix`` chunked (S > chunk, S % chunk == 0) from zeros: the
    output, the last input and the wkv state within the dtype's bar."""
    jcfg, tcfg, jp, tp = _rwkv_pair(dtype)
    jx, tx = _x(tcfg, (2, s, tcfg.d_model), 1, dtype)
    with jax.disable_jit():
        want, (wl, ww) = jrwkv.time_mix(jp["tm"], jx, jcfg, chunk=chunk)
    got, (gl, gw) = trwkv.time_mix(tp["tm"], tx, tcfg, chunk=chunk)
    tol = TOL[dtype]
    _close(got, want, tol, "out")
    np.testing.assert_array_equal(_np(gl), _np(wl))
    assert gw.dtype == torch.float32
    _close(gw, ww, tol, "wkv state")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_time_mix_decode_matches_jax(dtype):
    """Four one-token ``time_mix`` steps carrying (x_last, wkv) from a
    16-token prefill: each output and the final state within the bar."""
    jcfg, tcfg, jp, tp = _rwkv_pair(dtype, seed=1)
    jx, tx = _x(tcfg, (2, 20, tcfg.d_model), 2, dtype)
    tol = TOL[dtype]
    with jax.disable_jit():
        _, (jl, jw) = jrwkv.time_mix(jp["tm"], jx[:, :16], jcfg, chunk=8)
        _, (tl, tw) = trwkv.time_mix(tp["tm"], tx[:, :16], tcfg, chunk=8)
        for t in range(16, 20):
            want, (jl, jw) = jrwkv.time_mix(jp["tm"], jx[:, t:t + 1], jcfg,
                                            x_prev=jl, wkv0=jw)
            got, (tl, tw) = trwkv.time_mix(tp["tm"], tx[:, t:t + 1], tcfg,
                                           x_prev=tl, wkv0=tw)
            _close(got, want, tol, f"step {t}")
    _close(tw, jw, tol, "wkv state")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("carried", [False, True], ids=["zeros", "carried"])
def test_channel_mix_matches_jax(dtype, carried):
    """The squared-ReLU channel mix, its token shift padded with zeros or
    continuing a carried last input; the last input it returns."""
    jcfg, tcfg, jp, tp = _rwkv_pair(dtype, seed=3)
    jx, tx = _x(tcfg, (2, 12, tcfg.d_model), 4, dtype)
    jprev, tprev = _x(tcfg, (2, tcfg.d_model), 5, dtype) if carried \
        else (None, None)
    with jax.disable_jit():
        want, wl = jrwkv.channel_mix(jp["cm"], jx, x_prev=jprev)
    got, gl = trwkv.channel_mix(tp["cm"], tx, x_prev=tprev)
    _close(got, want, TOL[dtype], "out")
    np.testing.assert_array_equal(_np(gl), _np(wl))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rwkv_block_matches_jax(dtype):
    """``rwkv_block`` (layer norms, time mix, channel mix, residuals): a
    32-token prefill in chunks of 256 would be one chunk, so the prefill
    runs 512 tokens (two chunks) from ``init_state``; then four decode
    steps.  Outputs and every ``RWKVState`` leaf within the bar."""
    jcfg, tcfg, jp, tp = _rwkv_pair(dtype, seed=4)
    jx, tx = _x(tcfg, (2, 516, tcfg.d_model), 6, dtype)
    jst, tst = jrwkv.init_state(jcfg, 2), trwkv.init_state(tcfg, 2,
                                                           device="cpu")
    if dtype == "f32":
        jst = jst._replace(x_tm=jst.x_tm.astype(jnp.float32),
                           x_cm=jst.x_cm.astype(jnp.float32))
        tst = tst._replace(x_tm=tst.x_tm.float(), x_cm=tst.x_cm.float())
    tol = TOL[dtype]
    with jax.disable_jit():
        want, jst = jrwkv.rwkv_block(jp, jx[:, :512], jcfg, JPlan(),
                                     state=jst)
        got, tst = trwkv.rwkv_block(tp, tx[:, :512], tcfg, Plan(), state=tst)
        _close(got, want, tol, "prefill")
        for name, a, b in zip(tst._fields, jst, tst):
            _close(b, a, tol, f"prefill state {name}")
        for t in range(512, 516):
            want, jst = jrwkv.rwkv_block(jp, jx[:, t:t + 1], jcfg, JPlan(),
                                         state=jst)
            got, tst = trwkv.rwkv_block(tp, tx[:, t:t + 1], tcfg, Plan(),
                                        state=tst)
            _close(got, want, tol, f"step {t}")
    for name, a, b in zip(tst._fields, jst, tst):
        _close(b, a, tol, f"decode state {name}")


# ---------------- tests/test_ssm.py's properties, on the port ----------

def _mamba_naive(p, x, cfg):
    """Reference: the unchunked per-step recurrence of tests/test_ssm.py,
    in torch."""
    d_in, dtr, n, dc = tmamba._dims(cfg)
    b, s, _ = x.shape
    xi, z = (x @ p["in_proj"]).chunk(2, dim=-1)
    xi, _ = tmamba._causal_conv(xi, p["conv_w"], p["conv_b"], None)
    xi = torch.nn.functional.silu(xi.float()).to(x.dtype)
    dt_r, bc, cc = (xi @ p["x_proj"]).split([dtr, n, n], dim=-1)
    dt = torch.nn.functional.softplus(
        (dt_r @ p["dt_proj"] + p["dt_bias"]).float())
    A = -torch.exp(p["A_log"].float())
    h = torch.zeros((b, d_in, n))
    ys = []
    for t in range(s):
        dA = torch.exp(dt[:, t, :, None] * A)
        dBx = (dt[:, t] * xi[:, t].float())[..., None] * \
            bc[:, t].float()[:, None, :]
        h = h * dA + dBx
        ys.append(torch.einsum("bdn,bn->bd", h, cc[:, t].float()))
    y = torch.stack(ys, 1) + xi.float() * p["D"].float()
    y = y * torch.nn.functional.silu(z.float())
    return y.to(x.dtype) @ p["out_proj"]


@functools.lru_cache(maxsize=None)
def _port_params(arch, dtype, seed):
    jcfg, tcfg = _cfgs(arch)
    spec = jmamba.mamba_spec(jcfg, JPlan()) if arch == JAMBA else \
        jrwkv.rwkv_spec(jcfg, JPlan())
    return tcfg, _params(spec, seed, dtype)[1]


def test_mamba_chunked_equals_naive():
    tcfg, p = _port_params(JAMBA, "f32", 0)
    _, x = _x(tcfg, (2, 32, tcfg.d_model), 1, "f32")
    out_c, _ = tmamba.mamba_forward(p, x, tcfg, Plan(), chunk=8)
    np.testing.assert_allclose(_np(out_c), _np(_mamba_naive(p, x, tcfg)),
                               atol=1e-4)


def test_mamba_decode_continues_prefill():
    tcfg, p = _port_params(JAMBA, "bf16", 0)
    _, x = _x(tcfg, (1, 24, tcfg.d_model), 1, "bf16")
    full, _ = tmamba.mamba_forward(p, x, tcfg, Plan(), chunk=8)
    st = tmamba.init_state(tcfg, 1, device="cpu")
    _, st = tmamba.mamba_forward(p, x[:, :20], tcfg, Plan(), state=st,
                                 chunk=8)
    errs = []
    for t in range(20, 24):
        o, st = tmamba.mamba_forward(p, x[:, t:t + 1], tcfg, Plan(),
                                     state=st, decode=True)
        errs.append(float((o.float() - full[:, t:t + 1].float()).abs().max()))
    assert max(errs) < 5e-2, errs


def test_rwkv_chunked_equals_single_chunk():
    tcfg, p = _port_params(RWKV, "f32", 2)
    _, x = _x(tcfg, (2, 32, tcfg.d_model), 3, "f32")
    y1, (xl1, w1) = trwkv.time_mix(p["tm"], x, tcfg, chunk=8)
    y2, (xl2, w2) = trwkv.time_mix(p["tm"], x, tcfg, chunk=64)
    np.testing.assert_allclose(_np(y1), _np(y2), atol=1e-4)
    np.testing.assert_allclose(_np(w1), _np(w2), atol=1e-4)
    assert torch.equal(xl1, xl2)


def test_rwkv_decode_continues_prefill():
    tcfg, p = _port_params(RWKV, "bf16", 4)
    _, x = _x(tcfg, (1, 16, tcfg.d_model), 5, "bf16")
    full, _ = trwkv.rwkv_block(p, x, tcfg, Plan())
    st = trwkv.init_state(tcfg, 1, device="cpu")
    _, st = trwkv.rwkv_block(p, x[:, :12], tcfg, Plan(), state=st)
    errs = []
    for t in range(12, 16):
        o, st = trwkv.rwkv_block(p, x[:, t:t + 1], tcfg, Plan(), state=st)
        errs.append(float((o.float() - full[:, t:t + 1].float()).abs().max()))
    assert max(errs) < 5e-2, errs
