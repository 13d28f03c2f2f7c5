"""The port's FIGCache-KV decode attention
(``repro_torch.kernels.figcache_decode``) against the JAX package's Pallas
kernel (interpret mode) and its oracle.

The JAX kernel takes flattened heads, q (B*H, D) and k/v (B*H, L, D); the
port takes q (B, 1, H, D) and k/v (B, L, Hkv, D).  The same numpy inputs
go through both.  Tolerances: f32 2e-5 (summation order), bf16 3e-2 (one
bf16 rounding of outputs of order 1), as in tests/test_kernels.py.  The
CUDA kernel itself is held against the plain version in the
``cuda``-marked tests (skipped without a card) and in ``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.figcache_decode.figcache_decode import \
    figcache_decode as jax_kernel
from repro.kernels.figcache_decode.ref import figcache_decode_ref as jax_ref
from repro_torch.kernels.figcache_decode import figcache_decode as port_kernel
from repro_torch.kernels.figcache_decode.ops import decode_attend
from repro_torch.kernels.figcache_decode.ref import figcache_decode_ref

DTYPES = {"f32": (jnp.float32, torch.float32, 2e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 3e-2)}
SHAPES = [(2, 4, 512, 64, 128), (1, 8, 256, 128, 256), (3, 2, 384, 64, 128)]


def _case(B, H, L, D, seed, hkv=None):
    """numpy q (B, H, D), k/v (B, L, Hkv, D) and valid (B, L) with ~60 %
    valid entries and entry 0 always valid."""
    rng = np.random.default_rng(seed)
    hkv = hkv or H
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    k = rng.normal(size=(B, L, hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, L, hkv, D)).astype(np.float32)
    valid = rng.random((B, L)) < 0.6
    valid[:, 0] = True
    return q, k, v, valid


def _jax(q, k, v, valid, jdt, block_l=128):
    """The Pallas kernel in interpret mode on the flattened-head layout,
    with K/V heads repeated to H."""
    B, H, D = q.shape
    L, hkv = k.shape[1], k.shape[2]
    rep = H // hkv

    def flat(x):
        return jnp.asarray(np.repeat(x, rep, axis=2).transpose(0, 2, 1, 3)
                           .reshape(B * H, L, D), jdt)

    out = jax_kernel(jnp.asarray(q.reshape(B * H, D), jdt), flat(k), flat(v),
                     jnp.asarray(valid), heads_per_seq=H,
                     block_l=min(block_l, L), interpret=True)
    return np.asarray(out, np.float32).reshape(B, H, D)


def _port(q, k, v, valid, tdt):
    def t(x):
        return torch.from_numpy(x).to(tdt)
    out = decode_attend(t(q)[:, None], t(k), t(v), torch.from_numpy(valid))
    assert out.dtype == tdt and out.shape == (q.shape[0], 1) + q.shape[1:]
    return out[:, 0].float().numpy()


def _round(x, jdt):
    """numpy f32 -> the working dtype and back, so both sides see the same
    rounded inputs."""
    return np.array(jnp.asarray(x, jdt), np.float32)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,H,L,D,bl", SHAPES)
def test_decode_attend_matches_pallas_interpret(dtype, B, H, L, D, bl):
    jdt, tdt, tol = DTYPES[dtype]
    q, k, v, valid = [_round(x, jdt) if x.dtype == np.float32 else x
                      for x in _case(B, H, L, D, seed=B * H + L)]
    want = _jax(q, k, v, valid, jdt, block_l=bl)
    np.testing.assert_allclose(_port(q, k, v, valid, tdt), want, atol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("H,hkv", [(8, 4), (28, 4), (4, 1)])
def test_grouped_kv_heads_match_repeated_heads(dtype, H, hkv):
    """Hkv < H: query head h reads KV head h // (H // Hkv), which equals the
    JAX kernel on K/V repeated to H heads.  L = 160 is the FIGCache-KV
    shape (not a multiple of the TPU kernel's block, so JAX runs it as one
    block)."""
    jdt, tdt, tol = DTYPES[dtype]
    q, k, v, valid = [_round(x, jdt) if x.dtype == np.float32 else x
                      for x in _case(2, H, 160, 16, seed=H, hkv=hkv)]
    want = _jax(q, k, v, valid, jdt, block_l=160)
    np.testing.assert_allclose(_port(q, k, v, valid, tdt), want, atol=tol)


def test_all_invalid_but_one_and_fully_masked_rows():
    """One valid entry returns its v; a fully masked row averages v
    uniformly, in the JAX kernel and oracle alike."""
    q, k, v, valid = _case(3, 2, 256, 64, seed=9)
    valid[:] = False
    valid[0, 5] = True
    valid[1, 200] = True                                 # row 2: all masked
    got = _port(q, k, v, valid, torch.float32)
    np.testing.assert_allclose(got[0], v[0, 5], atol=1e-5)
    np.testing.assert_allclose(got[1], v[1, 200], atol=1e-5)
    np.testing.assert_allclose(got[2], v[2].mean(axis=0), atol=1e-5)
    np.testing.assert_allclose(got, _jax(q, k, v, valid, jnp.float32),
                               atol=2e-5)
    B, H, L, D = 3, 2, 256, 64
    flat = jax_ref(jnp.asarray(q.reshape(B * H, D)),
                   jnp.asarray(k.transpose(0, 2, 1, 3).reshape(B * H, L, D)),
                   jnp.asarray(v.transpose(0, 2, 1, 3).reshape(B * H, L, D)),
                   jnp.asarray(np.repeat(valid, H, axis=0)))
    np.testing.assert_allclose(got, np.asarray(flat).reshape(B, H, D),
                               atol=2e-5)


def test_dispatch_cpu_uses_plain_version():
    q, k, v, valid = [torch.from_numpy(x) for x in _case(1, 2, 8, 4, 0)]
    before = port_kernel.COUNTER.launches
    out = decode_attend(q[:, None], k, v, valid)
    assert torch.equal(out[:, 0], figcache_decode_ref(q, k, v, valid))
    assert port_kernel.COUNTER.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        port_kernel.figcache_decode(q, k, v, valid)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device to launch the figcache_decode kernel")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,hkv,L,D", [(8, 28, 4, 160, 128),
                                         (2, 4, 4, 512, 64),
                                         (3, 2, 2, 384, 64),
                                         (2, 3, 1, 1, 16)])
def test_cuda_kernel_matches_plain(cuda_device, dtype, B, H, hkv, L, D):
    q, k, v, valid = [torch.from_numpy(x) for x in
                      _case(B, H, L, D, seed=L, hkv=hkv)]
    valid[-1] = False                                    # a fully masked row
    args = [x.to(dtype) if x.is_floating_point() else x for x in
            (q, k, v, valid)]
    want = figcache_decode_ref(*args)
    before = port_kernel.COUNTER.launches
    got = port_kernel.figcache_decode(*[x.to(cuda_device) for x in args])
    torch.cuda.synchronize()
    assert port_kernel.COUNTER.launches == before + 1
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.cpu().float(), want.float(), atol=tol,
                               rtol=0)
