"""The port's FIGCache-KV decode attention
(``repro_torch.kernels.figcache_decode``) against the JAX package's Pallas
kernel (interpret mode) and its oracle.

The JAX kernel takes flattened heads, q (B*H, D) and k/v (B*H, L, D); the
port takes q (B, 1, H, D) and k/v (B, L, Hkv, D).  The same numpy inputs
go through both.  Tolerances: f32 2e-5 (summation order), bf16 3e-2 (one
bf16 rounding of outputs of order 1), as in tests/test_kernels.py.  The
CUDA kernel itself is held against the plain version in the
``cuda``-marked tests (skipped without a card) and in ``chip_smoke.py``;
on the CPU its split and combine logic is held through its model
(``emulate.py``) and its plan (``figcache_decode.plan``)."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.figcache_decode.figcache_decode import \
    figcache_decode as jax_kernel
from repro.kernels.figcache_decode.ref import figcache_decode_ref as jax_ref
from repro_torch.kernels.figcache_decode import figcache_decode as port_kernel
from repro_torch.kernels.figcache_decode.emulate import \
    figcache_decode_emulated
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


# (B, H, Hkv, L, D, splits, mask): the kernel's edge shapes.  Ragged L
# (uneven splits), L = 1, L < splits (forced: empty splits), several ring
# chunks per split (D 512 f32), groups of 1, 4, 7 and 8 query heads; mask
# "random" (~60 % valid), "row" (the last row fully masked) or "first"
# (the first split masked in every row, row 0's only valid key in the last
# split)
EDGE = [(2, 28, 4, 161, 16, None, "random"),
        (3, 7, 1, 37, 32, None, "first"),
        (2, 4, 1, 1, 16, None, "row"),
        (2, 8, 2, 3, 16, 8, "first"),
        (2, 4, 4, 64, 16, None, "row"),
        (2, 8, 2, 96, 16, None, "first"),
        (1, 7, 1, 40, 16, 8, "random"),
        (1, 8, 1, 300, 512, None, "first")]


def _edge_case(B, H, hkv, L, D, splits, mask, item):
    q, k, v, valid = _case(B, H, L, D, seed=L + H, hkv=hkv)
    if mask == "row":
        valid[-1] = False
    elif mask == "first":
        p = port_kernel.plan(B, H, hkv, L, D, item, splits)
        bounds = port_kernel.split_bounds(L, p.splits)
        valid[:, :bounds[0][1]] = False
        valid[0] = False
        valid[0, bounds[-1][0]] = True
    return q, k, v, valid


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,H,hkv,L,D,splits,mask", EDGE)
def test_kernel_model_matches_plain_and_pallas(dtype, B, H, hkv, L, D,
                                               splits, mask):
    """The model of the kernel's splits, chunks and combine against the
    plain version and the Pallas kernel (one block of L keys)."""
    jdt, tdt, tol = DTYPES[dtype]
    item = torch.tensor([], dtype=tdt).element_size()
    q, k, v, valid = [_round(x, jdt) if x.dtype == np.float32 else x
                      for x in _edge_case(B, H, hkv, L, D, splits, mask,
                                          item)]
    t = [torch.from_numpy(x).to(tdt) if x.dtype == np.float32 else
         torch.from_numpy(x) for x in (q, k, v, valid)]
    got = figcache_decode_emulated(*t, splits=splits)
    assert got.dtype == tdt and got.shape == (B, H, D)
    got = got.float().numpy()
    np.testing.assert_allclose(got, figcache_decode_ref(*t).float().numpy(),
                               atol=tol)
    np.testing.assert_allclose(got, _jax(q, k, v, valid, jdt, block_l=L),
                               atol=tol)
    if mask == "first":                  # row 0: the last split's key
        key = v[0, port_kernel.split_bounds(
            L, port_kernel.plan(B, H, hkv, L, D, item, splits).splits)[-1][0]]
        np.testing.assert_allclose(got[0], np.repeat(key, H // hkv, axis=0),
                                   atol=tol)
    if mask == "row":
        np.testing.assert_allclose(
            got[-1], np.repeat(v[-1].mean(axis=0), H // hkv, axis=0),
            atol=tol)


@pytest.mark.parametrize("B,H,hkv,L,D,item", [
    (8, 28, 4, 160, 128, 2), (8, 28, 4, 161, 128, 2),
    (8, 28, 4, 8192, 128, 2), (1, 7, 1, 5, 128, 4), (3, 7, 1, 37, 128, 2),
    (64, 28, 4, 160, 128, 2), (2, 12, 1, 50, 64, 4), (1, 8, 1, 2048, 512, 4),
    (2, 3, 1, 1, 16, 2)])
def test_split_plan_covers_every_key_once(B, H, hkv, L, D, item):
    """The plan's splits: at most 8 (the cluster) and at most L, blocks
    for about three quarters of the card's SMs where 8 splits allow it,
    every split non-empty, [0, L) covered once in order; chunks within the
    ring's bytes.  Forced counts above L leave empty splits but cover L
    too."""
    p = port_kernel.plan(B, H, hkv, L, D, item)
    assert 1 <= p.splits <= min(port_kernel.MAX_SPLITS, L)
    units = B * hkv * p.tiles
    assert p.tiles == -(-(H // hkv) // port_kernel.MAX_GROUP)
    assert p.blocks == units * p.splits
    quarter3 = 3 * port_kernel.SMS // 4
    assert p.blocks <= max(quarter3, units)
    assert (p.blocks + units > quarter3 or p.splits == min(8, L))
    for splits in (p.splits, 8):
        bounds = port_kernel.split_bounds(L, splits)
        assert len(bounds) == splits and bounds[0][0] == 0
        assert bounds[-1][1] == L
        assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
        sizes = [hi - lo for lo, hi in bounds]
        assert min(sizes) >= (1 if L >= splits else 0)
        assert max(sizes) - min(sizes) <= 1
        q = port_kernel.plan(B, H, hkv, L, D, item, splits)
        assert (q.chunk >= max(sizes)) == (q.stages == 1)
        tile = -(-q.chunk // 16) * 16 if item == 2 else q.chunk
        assert (q.stages * tile * 2 * port_kernel.row_stride(D, item)
                <= port_kernel.RING_BYTES)
    if (B, H, hkv, L) == (8, 28, 4, 160):   # the FIGCache-KV shape
        assert (p.splits, p.blocks, p.chunk, p.stages) == (3, 96, 54, 1)


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


# shapes of chip_smoke.py's phase 2 whose split count is forced
FORCED_SPLITS = {(2, 8, 1, 3, 64): 8}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,hkv,L,D", [(8, 28, 4, 160, 128),
                                         (2, 4, 4, 512, 64),
                                         (3, 2, 2, 384, 64),
                                         (2, 3, 1, 1, 16),
                                         (2, 7, 1, 1, 128),
                                         (2, 8, 1, 3, 64),
                                         (3, 7, 1, 37, 128),
                                         (8, 28, 4, 161, 128),
                                         (8, 28, 4, 8192, 128),
                                         (2, 8, 2, 300, 16),
                                         (2, 4, 1, 200, 256),
                                         (2, 8, 1, 100, 512),
                                         (1, 8, 1, 2048, 512),
                                         (2, 12, 1, 50, 64),
                                         (2, 4, 2, 70, 100)])
def test_cuda_kernel_matches_plain(cuda_device, dtype, B, H, hkv, L, D):
    q, k, v, valid = [torch.from_numpy(x) for x in
                      _case(B, H, L, D, seed=L, hkv=hkv)]
    valid[-1] = False                                    # a fully masked row
    args = [x.to(dtype) if x.is_floating_point() else x for x in
            (q, k, v, valid)]
    want = figcache_decode_ref(*args)
    before = port_kernel.COUNTER.launches
    got = port_kernel.figcache_decode(
        *[x.to(cuda_device) for x in args],
        splits=FORCED_SPLITS.get((B, H, hkv, L, D)))
    torch.cuda.synchronize()
    assert port_kernel.COUNTER.launches == before + 1
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.cpu().float(), want.float(), atol=tol,
                               rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [None, 8])
def test_cuda_graph_replays_are_bitwise_equal(cuda_device, splits):
    """The combine keeps no state between launches: two replays of one
    captured launch at the FIGCache-KV shape give the same bits, within
    bf16 2e-2 of the plain version."""
    q, k, v, valid = [torch.from_numpy(x).to(cuda_device) for x in
                      _case(8, 28, 160, 128, seed=3, hkv=4)]
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        port_kernel.figcache_decode(q, k, v, valid, splits=splits)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = port_kernel.COUNTER.launches
    with torch.cuda.graph(graph):
        out = port_kernel.figcache_decode(q, k, v, valid, splits=splits)
    assert port_kernel.COUNTER.launches == before + 1
    graph.replay()
    torch.cuda.synchronize()
    first = out.clone()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, first)
    torch.testing.assert_close(out.float(), figcache_decode_ref(
        q, k, v, valid).float(), atol=2e-2, rtol=0)
