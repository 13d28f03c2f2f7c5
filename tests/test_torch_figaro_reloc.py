"""The port's FIGARO RELOC (``repro_torch.kernels.figaro_reloc`` and
``repro_torch.core.figaro``) against the JAX package's Pallas kernel
(interpret mode) and ``repro.core.figaro``.

Relocation moves data unchanged, so every comparison is bitwise, for f32,
bf16 and int8 payloads, with masked moves and a slow pool whose length is
not a multiple of the segment.  The CUDA kernel itself is held against the
plain version in the ``cuda``-marked test (skipped without a card) and in
``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import figaro as jfig
from repro.kernels.figaro_reloc.figaro_reloc import reloc as jax_reloc
from repro.kernels.figaro_reloc.ref import reloc_ref as jax_ref
from repro_torch.core import figaro as tfig
from repro_torch.kernels.figaro_reloc import figaro_reloc as port_kernel
from repro_torch.kernels.figaro_reloc.ops import reloc_segments, segment_rows
from repro_torch.kernels.figaro_reloc.ref import reloc_ref

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16),
          "int8": (jnp.int8, torch.int8)}


def _to_torch(x, tdtype):
    return torch.from_numpy(np.array(x, np.float32)).to(tdtype)


def _to_np(t):
    return t.float().numpy()


def _data(rng, shape, dtype):
    return jnp.asarray(rng.integers(-100, 100, shape), dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n_segs,n_slots,E,n_moves,n_masked", [
    (16, 8, 128, 3, 0), (4, 2, 128, 2, 1), (64, 32, 256, 4, 3),
    (8, 4, 100, 4, 2), (5, 3, 1, 3, 1)])
def test_reloc_segments_matches_pallas_interpret(dtype, n_segs, n_slots, E,
                                                 n_moves, n_masked):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(n_segs * 100 + E)
    pool, fast = _data(rng, (n_segs, E), jdt), _data(rng, (n_slots, E), jdt)
    src = rng.choice(n_segs, n_moves, replace=False).astype(np.int32)
    dst = rng.choice(n_slots, n_moves, replace=False).astype(np.int32)
    src[:n_masked] = -1
    want = jax_reloc(pool, fast, jnp.asarray(src), jnp.asarray(dst),
                     interpret=True)
    np.testing.assert_array_equal(
        np.asarray(want), np.asarray(jax_ref(pool, fast, jnp.asarray(src),
                                             jnp.asarray(dst))))
    fast_t = _to_torch(fast, tdt)
    out = reloc_segments(_to_torch(pool, tdt), fast_t, torch.from_numpy(src),
                         torch.from_numpy(dst))
    assert out is fast_t                             # in place
    np.testing.assert_array_equal(_to_np(out), np.asarray(want, np.float32))


def test_reloc_segments_any_payload_shape():
    """Segments of shape (st, Hkv, D), as the JAX wrapper flattens them."""
    rng = np.random.default_rng(1)
    pool = _data(rng, (6, 4, 2, 8), jnp.bfloat16)
    fast = _data(rng, (3, 4, 2, 8), jnp.bfloat16)
    src, dst = np.array([5, -1, 0], np.int32), np.array([2, 0, 1], np.int32)
    from repro.kernels.figaro_reloc.ops import reloc_segments as jax_ops
    want = jax_ops(pool, fast, jnp.asarray(src), jnp.asarray(dst),
                   interpret=True)
    got = reloc_segments(_to_torch(pool, torch.bfloat16),
                         _to_torch(fast, torch.bfloat16),
                         torch.from_numpy(src), torch.from_numpy(dst))
    np.testing.assert_array_equal(_to_np(got), np.asarray(want, np.float32))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_batched_strided_pool_non_multiple_smax(dtype):
    """FIGCache-KV's shape: a (B, Smax, Hkv, D) pool with Smax % st != 0 is
    moved through a strided segment view, one masked move per sequence,
    without copying the pool, and equals the JAX reference per sequence."""
    jdt, tdt = DTYPES[dtype]
    B, smax, hkv, d, st, slots = 3, 45, 2, 4, 8, 4
    n_segs = smax // st                                  # 5, tail of 5
    rng = np.random.default_rng(7)
    pool = _data(rng, (B, smax, hkv, d), jdt)
    fast = _data(rng, (B, slots, st, hkv, d), jdt)
    src = np.array([4, -1, 0], np.int32)
    dst = np.array([1, 3, -1], np.int32)
    pool_t, fast_t = _to_torch(pool, tdt), _to_torch(fast, tdt)
    view = pool_t[:, :n_segs * st].view(B, n_segs, st, hkv, d)
    p3, f3, _, _ = segment_rows(view, fast_t, torch.from_numpy(src)[:, None],
                                torch.from_numpy(dst)[:, None])
    assert p3.data_ptr() == pool_t.data_ptr()            # no copy
    assert p3.stride(0) == smax * hkv * d
    reloc_segments(view, fast_t, torch.from_numpy(src)[:, None],
                   torch.from_numpy(dst)[:, None])
    for b in range(B):
        segs = pool[b, :n_segs * st].reshape(n_segs, st * hkv * d)
        ok = src[b] >= 0 and dst[b] >= 0
        want = jax_ref(segs, fast[b].reshape(slots, -1),
                       jnp.asarray([src[b] if ok else -1]),
                       jnp.asarray([max(dst[b], 0)]))
        np.testing.assert_array_equal(_to_np(fast_t[b]).reshape(slots, -1),
                                      np.asarray(want, np.float32))


def test_figaro_reloc_in_out_gather_match_jax():
    rng = np.random.default_rng(2)
    slow = _data(rng, (6, 4, 8, 3), jnp.float32)         # 24 segments
    fast = _data(rng, (2, 4, 8, 3), jnp.float32)         # 8 slots
    seg_ids = np.array([17, -1, 3, 22], np.int32)
    slots = np.array([0, 5, 7, 2], np.int32)
    want_in = jfig.reloc_in(slow, fast, jnp.asarray(seg_ids),
                            jnp.asarray(slots))
    slow_t = _to_torch(slow, torch.float32)
    fast_t = _to_torch(fast, torch.float32)
    got_in = tfig.reloc_in(slow_t, fast_t, torch.from_numpy(seg_ids),
                           torch.from_numpy(slots))
    np.testing.assert_array_equal(got_in.numpy(), np.asarray(want_in))
    # write-back: fast[slots] -> slow[seg_ids]; seg -1 masks
    wb_slots = np.array([5, 7, 2], np.int32)
    wb_segs = np.array([0, -1, 23], np.int32)
    want_out = jfig.reloc_out(slow, want_in, jnp.asarray(wb_slots),
                              jnp.asarray(wb_segs))
    got_out = tfig.reloc_out(slow_t, got_in, torch.from_numpy(wb_slots),
                             torch.from_numpy(wb_segs))
    np.testing.assert_array_equal(got_out.numpy(), np.asarray(want_out))
    ids = np.array([0, 23, 30, -2], np.int32)            # clipped reads
    np.testing.assert_array_equal(
        tfig.gather_segments(slow_t, torch.from_numpy(ids)).numpy(),
        np.asarray(jfig.gather_segments(want_out, jnp.asarray(ids))))
    n = np.array([0, 1, 7], np.int32)
    np.testing.assert_allclose(
        tfig.reloc_cost_ns(torch.from_numpy(n), 16).numpy(),
        np.asarray(jfig.reloc_cost_ns(jnp.asarray(n), 16)), rtol=1e-6)


def test_reloc_refuses_a_copy_of_the_destination():
    """A destination that cannot be seen as rows is refused, not copied."""
    fast = torch.zeros(4, 3, 2).transpose(1, 2)          # (4, 2, 3)
    with pytest.raises(RuntimeError):
        reloc_segments(torch.ones(5, 2, 3), fast,
                       torch.tensor([0], dtype=torch.int32),
                       torch.tensor([1], dtype=torch.int32))


def test_dispatch_cpu_uses_plain_version():
    before = port_kernel.COUNTER.launches
    fast = torch.zeros(2, 3, 4)
    reloc_ref(torch.ones(2, 5, 4), fast, torch.tensor([[1], [-1]],
                                                      dtype=torch.int32),
              torch.tensor([[2], [0]], dtype=torch.int32))
    assert fast[0, 2].eq(1).all() and fast[1].eq(0).all()
    reloc_segments(torch.ones(5, 4), fast[0],
                   torch.tensor([0], dtype=torch.int32),
                   torch.tensor([0], dtype=torch.int32))
    assert port_kernel.COUNTER.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        port_kernel.reloc(torch.ones(1, 5, 4), fast[:1], torch.zeros(
            1, 1, dtype=torch.int32), torch.zeros(1, 1, dtype=torch.int32))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device to launch the figaro_reloc kernel")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("E", [8192, 100, 1])
def test_cuda_kernel_matches_plain(cuda_device, dtype, E):
    g, n_segs, n_slots = 3, 9, 5
    gen = torch.Generator().manual_seed(E)
    base = torch.randint(-100, 100, (g, n_segs + 1, E), generator=gen)
    pool = base.to(dtype).to(cuda_device)[:, 1:]         # strided groups
    fast = torch.randint(-100, 100, (g, n_slots, E), generator=gen).to(
        dtype).to(cuda_device)
    src = torch.tensor([[3, -1], [0, 8], [5, 2]], dtype=torch.int32,
                       device=cuda_device)
    dst = torch.tensor([[4, 0], [1, -1], [0, 3]], dtype=torch.int32,
                       device=cuda_device)
    want = reloc_ref(pool.cpu(), fast.cpu(), src.cpu(), dst.cpu())
    before = port_kernel.COUNTER.launches
    got = port_kernel.reloc(pool, fast, src, dst)
    torch.cuda.synchronize()
    assert port_kernel.COUNTER.launches == before + 1
    assert torch.equal(got.cpu(), want)
