"""The port's fused FTS lookup (``repro_torch.kernels.fts_lookup``) against
the JAX package's Pallas kernel (interpret mode) and its pure-JAX oracle.

The port answers for every lane in one call; the JAX kernel answers for
one bank row, so it is vmapped (or called per lane) over the same numpy
inputs.  Integer outputs: every comparison is bitwise.  The CUDA kernel
itself is held against the plain version in ``test_cuda_kernel_matches_
plain`` (skipped without a card) and in ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.fts_lookup.fts_lookup import fts_lookup as jax_kernel
from repro.kernels.fts_lookup.ref import fts_lookup_ref as jax_ref
from repro_torch.kernels.fts_lookup import fts_lookup as port_kernel
from repro_torch.kernels.fts_lookup.ops import fts_lookup_op
from repro_torch.kernels.fts_lookup.ref import BIG, fts_lookup_ref


def _case(n_lanes, n_banks, S, seed, score_hi=8):
    """Random stores with many ties (score in [0, score_hi)), tags in
    [-1, 40), segs in [-1, 40] and limits cycling {0, S/2, S} plus random
    values, so all-miss, all-masked and duplicate-minimum lanes occur."""
    rng = np.random.default_rng(seed)
    tags = rng.integers(-1, 40, (n_lanes, n_banks, S)).astype(np.int32)
    score = rng.integers(0, score_hi, (n_lanes, n_banks, S)).astype(np.int32)
    bank = rng.integers(0, n_banks, n_lanes).astype(np.int32)
    seg = rng.integers(-1, 41, n_lanes).astype(np.int32)
    seg[::5] = 1000                     # guaranteed all-miss lanes
    limit = np.array([(0, S // 2, S)[i % 3] for i in range(n_lanes)],
                     np.int32)
    limit[3::7] = rng.integers(-2, S + 2, limit[3::7].shape)
    return tags, score, bank, seg, limit


def _port(tags, score, bank, seg, limit):
    t = [torch.from_numpy(x) for x in (tags, score, bank, seg, limit)]
    return fts_lookup_ref(*t).numpy()


def _jax_vmapped(fn, tags, score, bank, seg, limit):
    return np.asarray(jax.vmap(fn)(tags, score, bank, seg, limit))


def _interpret(t, s, b, g, l):
    return jax_kernel(t, s, b, g, l, interpret=True)


@pytest.mark.parametrize("n_banks", [1, 3, 8])
@pytest.mark.parametrize("slots_pow", [5, 6, 7, 8, 9])
def test_plain_matches_jax_kernel_and_ref(n_banks, slots_pow):
    """The cases of tests/test_kernels.py (n_banks 1-8, S = 2^5..2^9, seg
    -1..40, limit in {0, S/2, S}, many ties), batched into one port call."""
    S = 2 ** slots_pow
    args = _case(24, n_banks, S, seed=n_banks * 1000 + S)
    got = _port(*args)
    np.testing.assert_array_equal(got, _jax_vmapped(_interpret, *args))
    np.testing.assert_array_equal(got, _jax_vmapped(jax_ref, *args))


@pytest.mark.parametrize("S", [2, 3, 5, 13, 100])
def test_plain_matches_jax_odd_widths(S):
    """S = 2 (a tiny exact_static store) and widths that are not a multiple
    of 4 (the CUDA kernel's scalar tail)."""
    args = _case(12, 4, S, seed=S, score_hi=3)
    got = _port(*args)
    np.testing.assert_array_equal(got, _jax_vmapped(_interpret, *args))
    np.testing.assert_array_equal(got, _jax_vmapped(jax_ref, *args))


def test_plain_matches_jax_kernel_lane_by_lane():
    """No vmap on the JAX side: each lane through the unbatched kernel."""
    tags, score, bank, seg, limit = _case(8, 4, 64, seed=11)
    got = _port(tags, score, bank, seg, limit)
    for i in range(8):
        ref = jax_kernel(jnp.asarray(tags[i]), jnp.asarray(score[i]),
                         jnp.int32(bank[i]), jnp.int32(seg[i]),
                         jnp.int32(limit[i]), interpret=True)
        np.testing.assert_array_equal(got[i], np.asarray(ref), err_msg=i)


def test_plain_corners():
    """limit <= 0 -> candidate 0; all ties -> first index; no match ->
    hit 0, hit_slot S; first of several matches."""
    tags = np.array([[[3, -1, 7, 3]], [[9, 9, -1, 0]], [[1, 1, 1, 1]]],
                    np.int32)
    score = np.array([[[5, 1, 1, 2]], [[4, 4, 4, 4]], [[2, 2, 0, 0]]],
                     np.int32)
    bank = np.zeros(3, np.int32)
    out = _port(tags, score, bank, np.array([3, 8, 1], np.int32),
                np.array([4, 0, 3], np.int32))
    np.testing.assert_array_equal(out, [[1, 0, 1], [0, 4, 0], [1, 0, 2]])
    # scores at BIG inside the limit still tie-break on the index
    big = np.full((1, 1, 4), BIG, np.int32)
    out = _port(tags[:1], big, bank[:1], np.array([7], np.int32),
                np.array([4], np.int32))
    np.testing.assert_array_equal(out, [[1, 2, 0]])


def test_dispatch_cpu_uses_plain_version():
    """A CPU tensor goes to the plain version and never counts a launch."""
    args = [torch.from_numpy(x) for x in _case(6, 2, 32, seed=3)]
    before = port_kernel.COUNTER.launches
    hit, slot, cand = fts_lookup_op(*args)
    ref = fts_lookup_ref(*args)
    assert hit.dtype == torch.bool and slot.dtype == torch.int32
    assert torch.equal(hit, ref[:, 0] != 0)
    assert torch.equal(slot, ref[:, 1]) and torch.equal(cand, ref[:, 2])
    assert port_kernel.COUNTER.launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel wrapper itself never runs the plain version."""
    args = [torch.from_numpy(x) for x in _case(2, 2, 32, seed=4)]
    with pytest.raises(ValueError, match="CUDA"):
        port_kernel.fts_lookup(*args)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device to launch the fts_lookup kernel")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n_banks,S", [(16, 512), (16, 1024), (4, 2),
                                       (3, 13), (1, 100)])
def test_cuda_kernel_matches_plain(cuda_device, n_banks, S):
    args = [torch.from_numpy(x).to(cuda_device)
            for x in _case(40, n_banks, S, seed=S)]
    before = port_kernel.COUNTER.launches
    got = port_kernel.fts_lookup(*args)
    torch.cuda.synchronize()
    assert port_kernel.COUNTER.launches == before + 1
    assert torch.equal(got.cpu(), fts_lookup_ref(*[a.cpu() for a in args]))
