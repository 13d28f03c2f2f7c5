"""The port's prefill flash attention (``repro_torch.kernels.flash_attention``)
against the JAX package's Pallas kernel (interpret mode) and its oracle.

The JAX kernel takes flattened heads, q/k/v (B*H, S, D); the port takes the
model layout q (B, S, H, D), k/v (B, S, Hkv, D), so a (BH, S, D) case goes
through it as (BH, S, 1, D).  The same numpy inputs, rounded to the working
dtype, go through both.  Tolerances are those of tests/test_kernels.py:
f32 2e-5 (summation order), bf16 2e-2 (one bf16 rounding of outputs of
order 1; the Pallas kernel, like the plain version, keeps P in f32).  The
CUDA kernel itself is held against the plain version in the
``cuda``-marked tests (skipped without a card) and in ``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention.flash_attention import \
    flash_attention as jax_kernel
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_ref
from repro_torch.kernels.flash_attention import flash_attention as port_kernel
from repro_torch.kernels.flash_attention.ops import mha
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

DTYPES = {"f32": (jnp.float32, torch.float32, 2e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
MASKS = [(True, 0), (False, 0), (True, 96)]


def _case(shape_q, shape_kv, jdt, seed):
    """numpy q, k, v from N(0, 1), rounded to the working dtype."""
    rng = np.random.default_rng(seed)
    return [np.array(jnp.asarray(rng.normal(size=s), jdt), np.float32)
            for s in (shape_q, shape_kv, shape_kv)]


def _port(q, k, v, tdt, **mask):
    """Model-layout numpy inputs through the port's ``mha`` -> f32 numpy."""
    out = mha(*[torch.from_numpy(x).to(tdt) for x in (q, k, v)], **mask)
    assert out.dtype == tdt and tuple(out.shape) == q.shape
    return out.float().numpy()


def _flat(x):
    """(B, S, H, D) -> the JAX kernel's (B*H, S, D)."""
    b, s, h, d = x.shape
    return x.transpose(0, 2, 1, 3).reshape(b * h, s, d)


def _unflat(x, b, h):
    bh, s, d = x.shape
    return np.asarray(x, np.float32).reshape(b, h, s, d).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("BH,S,D,bq,bkv", [
    (2, 128, 64, 64, 64),
    (4, 256, 64, 64, 128),
    (1, 256, 128, 128, 64),
])
def test_mha_matches_pallas_interpret(BH, S, D, bq, bkv, dtype, causal,
                                      window):
    """The 18 cases of tests/test_kernels.py:20-37."""
    jdt, tdt, tol = DTYPES[dtype]
    q, k, v = _case((BH, S, D), (BH, S, D), jdt, seed=BH * S + D)
    mask = dict(causal=causal, window=window)
    got = _port(q[:, :, None], k[:, :, None], v[:, :, None], tdt,
                **mask)[:, :, 0]
    want = jax_kernel(*[jnp.asarray(x, jdt) for x in (q, k, v)], block_q=bq,
                      block_kv=bkv, interpret=True, **mask)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=tol)
    oracle = jax_ref(*[jnp.asarray(x, jdt) for x in (q, k, v)], **mask)
    np.testing.assert_allclose(got, np.asarray(oracle, np.float32), atol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("S,causal,window", [(100, True, 0), (100, False, 30),
                                             (1000, True, 96),
                                             (1000, False, 0)])
def test_ragged_length_matches_reference(dtype, S, causal, window):
    """S that no block size divides: the port takes any S.  The Pallas
    kernel runs S = 100 as one block; S = 1000 goes to its oracle only."""
    jdt, tdt, tol = DTYPES[dtype]
    q, k, v = _case((2, S, 2, 64), (2, S, 2, 64), jdt, seed=S + window)
    mask = dict(causal=causal, window=window)
    got = _port(q, k, v, tdt, **mask)
    jq, jk, jv = [jnp.asarray(_flat(x), jdt) for x in (q, k, v)]
    want = jax_ref(jq, jk, jv, **mask)
    np.testing.assert_allclose(got, _unflat(want, 2, 2), atol=tol)
    if S == 100:
        kern = jax_kernel(jq, jk, jv, interpret=True, **mask)
        np.testing.assert_allclose(got, _unflat(kern, 2, 2), atol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("H,hkv,causal,window", [(28, 4, True, 0),
                                                 (8, 2, True, 40),
                                                 (4, 1, False, 0)])
def test_grouped_kv_heads_match_repeated_heads(dtype, H, hkv, causal,
                                               window):
    """Hkv < H: query head h reads KV head h // (H // Hkv), which equals
    the JAX oracle on K/V repeated to H heads (28 / 4 is Qwen2-7B)."""
    jdt, tdt, tol = DTYPES[dtype]
    S, D = 96, 32
    q, k, v = _case((2, S, H, D), (2, S, hkv, D), jdt, seed=H + hkv)
    mask = dict(causal=causal, window=window)
    got = _port(q, k, v, tdt, **mask)
    rep = H // hkv
    kr, vr = np.repeat(k, rep, axis=2), np.repeat(v, rep, axis=2)
    want = jax_ref(*[jnp.asarray(_flat(x), jdt) for x in (q, kr, vr)],
                   **mask)
    np.testing.assert_allclose(got, _unflat(want, 2, H), atol=tol)


def test_query_blocks_do_not_change_the_plain_version():
    """The plain version walks query blocks and reads only the keys their
    masks leave open; the block size changes nothing beyond f32 rounding."""
    q, k, v = [torch.from_numpy(x) for x in
               _case((1, 300, 4, 16), (1, 300, 2, 16), jnp.float32, 5)]
    for causal, window in MASKS + [(False, 50)]:
        outs = [flash_attention_ref(q, k, v, causal=causal, window=window,
                                    block_q=bq) for bq in (1, 7, 256, 300)]
        for o in outs[1:]:
            torch.testing.assert_close(o, outs[0], atol=1e-6, rtol=0)


def test_dispatch_cpu_uses_plain_version():
    q, k, v = [torch.from_numpy(x) for x in
               _case((1, 8, 2, 16), (1, 8, 1, 16), jnp.float32, 0)]
    before = port_kernel.COUNTER.launches
    out = mha(q, k, v, causal=True, window=3)
    assert torch.equal(out, flash_attention_ref(q, k, v, causal=True,
                                                window=3))
    assert port_kernel.COUNTER.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        port_kernel.flash_attention(q, k, v)


@pytest.mark.parametrize("bad", ["head_dim", "heads", "dtype"])
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(bad):
    """The wrapper raises ValueError before it builds or launches anything:
    a head_dim outside (16, 32, 64, 128), H not a multiple of Hkv, mixed
    dtypes."""
    shapes = {"head_dim": ((1, 8, 2, 80), (1, 8, 1, 80)),
              "heads": ((1, 8, 3, 16), (1, 8, 2, 16)),
              "dtype": ((1, 8, 2, 16), (1, 8, 1, 16))}[bad]
    q, k, v = [torch.zeros(s) for s in (shapes[0], shapes[1], shapes[1])]
    if bad == "dtype":
        k = k.to(torch.bfloat16)
    with pytest.raises(ValueError, match=bad.replace("heads", "do not fit")):
        port_kernel.flash_attention(q, k, v)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device to launch the flash_attention kernel")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,hkv,D,causal,window", [
    (4, 512, 28, 4, 128, True, 0), (2, 256, 4, 4, 64, False, 0),
    (1, 256, 1, 1, 128, True, 96), (2, 100, 4, 2, 64, True, 0),
    (1, 1000, 2, 1, 128, False, 300), (2, 77, 7, 1, 16, True, 0),
    (2, 129, 4, 2, 32, True, 50), (1, 1, 2, 1, 128, True, 0)])
def test_cuda_kernel_matches_plain(cuda_device, dtype, B, S, H, hkv, D,
                                   causal, window):
    q, k, v = [torch.from_numpy(x).to(dtype) for x in
               _case((B, S, H, D), (B, S, hkv, D), jnp.float32, seed=S)]
    mask = dict(causal=causal, window=window)
    want = flash_attention_ref(q, k, v, **mask)
    before = port_kernel.COUNTER.launches
    got = mha(*[x.to(cuda_device) for x in (q, k, v)], **mask)
    torch.cuda.synchronize()
    assert port_kernel.COUNTER.launches == before + 1
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.cpu().float(), want.float(), atol=tol,
                               rtol=0)


@pytest.mark.cuda
def test_cuda_mha_raises_for_unsupported_head_dim(cuda_device):
    q = torch.zeros((1, 8, 2, 80), device=cuda_device)
    k = torch.zeros((1, 8, 1, 80), device=cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        mha(q, k, k)
