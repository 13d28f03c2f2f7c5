"""The port's prefill flash attention (``repro_torch.kernels.flash_attention``)
against the JAX package's Pallas kernel (interpret mode) and its oracle.

The JAX kernel takes flattened heads, q/k/v (B*H, S, D); the port takes the
model layout q (B, S, H, D), k/v (B, S, Hkv, D), so a (BH, S, D) case goes
through it as (BH, S, 1, D).  The same numpy inputs, rounded to the working
dtype, go through both.  Tolerances are those of tests/test_kernels.py:
f32 2e-5 (summation order), bf16 2e-2 (one bf16 rounding of outputs of
order 1; the Pallas kernel, like the plain version, keeps P in f32).  The
CUDA kernel itself is held against the plain version in the
``cuda``-marked tests (skipped without a card) and in ``chip_smoke.py``;
on the CPU a model of its bf16 tiling, softmax order and rounding of P
(``emulate.py``) is held against the plain version for each way of
rounding P."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention.flash_attention import \
    flash_attention as jax_kernel
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_ref
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import emulate
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
    a head_dim above the largest instantiated one (192), H not a multiple
    of Hkv, mixed dtypes."""
    shapes = {"head_dim": ((1, 8, 2, 200), (1, 8, 1, 200)),
              "heads": ((1, 8, 3, 16), (1, 8, 2, 16)),
              "dtype": ((1, 8, 2, 16), (1, 8, 1, 16))}[bad]
    q, k, v = [torch.zeros(s) for s in (shapes[0], shapes[1], shapes[1])]
    if bad == "dtype":
        k = k.to(torch.bfloat16)
    with pytest.raises(ValueError, match=bad.replace("heads", "do not fit")):
        port_kernel.flash_attention(q, k, v)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,dp", [(8, 16), (20, 32), (160, 192), (64, 64)])
def test_padded_head_dim_equals_plain(D, dp, dtype):
    """The wrapper's padding (q, k, v zero-padded to the next instantiated
    head dim, the true D^-0.5, the first D output columns) through the
    plain version equals the plain version at D: StableLM-12B's 160, its
    reduced 20 and the reduced DeepSeek-67B's 8."""
    assert port_kernel.padded_head_dim(D) == dp
    q, k, v = [torch.from_numpy(x).to(dtype) for x in
               _case((2, 40, 4, D), (2, 40, 2, D), jnp.float32, seed=D)]
    widths = []

    def attend(q, k, v, **kw):
        widths.append(q.shape[-1])
        return flash_attention_ref(q, k, v, **kw)

    for causal, window in ((True, 0), (False, 9)):
        want = flash_attention_ref(q, k, v, causal=causal, window=window)
        got = port_kernel.padded(attend, q, k, v, causal=causal,
                                 window=window)
        assert got.shape == want.shape and got.is_contiguous()
        tol = 1e-6 if dtype == torch.float32 else 0
        torch.testing.assert_close(got, want, atol=tol, rtol=0)
    assert widths == [dp, dp]


# The shapes of test_mha_matches_pallas_interpret, the ragged and the GQA
# cases above, as (B, S, H, Hkv, D, causal, window).
EMULATED_CASES = (
    [(bh, s, 1, 1, d, causal, window)
     for bh, s, d in ((2, 128, 64), (4, 256, 64), (1, 256, 128))
     for causal, window in MASKS]
    + [(2, s, 2, 2, 64, causal, window)
       for s, causal, window in ((100, True, 0), (100, False, 30),
                                 (1000, True, 96), (1000, False, 0))]
    + [(2, 96, h, hkv, 32, causal, window)
       for h, hkv, causal, window in ((28, 4, True, 0), (8, 2, True, 40),
                                      (4, 1, False, 0))])


def _bf16_case(B, S, H, hkv, D, seed, stds=(1.0, 1.0, 1.0)):
    """bf16 q, k, v from N(0, std^2) in numpy."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy((std * rng.normal(size=shape)).astype(
        np.float32)).to(torch.bfloat16)
        for std, shape in zip(stds, ((B, S, H, D), (B, S, hkv, D),
                                     (B, S, hkv, D)))]


def _row_rel_err(got, want):
    """max |got - want| over each output row / the row's largest |want|
    (chip_smoke.py's phase 7 hold), largest over rows."""
    diff = (got.float() - want.float()).abs().amax(-1)
    return float((diff / want.float().abs().amax(-1).clamp_min(1e-30)).max())


@pytest.mark.parametrize("p_mode", emulate.P_MODES)
@pytest.mark.parametrize("B,S,H,hkv,D,causal,window", EMULATED_CASES)
def test_kernel_arithmetic_matches_plain(B, S, H, hkv, D, causal, window,
                                         p_mode):
    """The model of the bf16 kernel on the CPU (its 128 x 128 tiles, the
    tiles it skips, exp2 with log2(e) in the scale, P rounded as
    ``p_mode``), within the bf16 bars of the plain version: 2e-2 absolute
    and 1e-2 of each output row's largest value.  At these unit-scale
    inputs both modes hold (both within 0.0079 absolute and per row); the
    next test shows where one bf16 P does not."""
    q, k, v = _bf16_case(B, S, H, hkv, D, seed=B * S + D + window)
    mask = dict(causal=causal, window=window)
    got = emulate.flash_attention_emulated(q, k, v, p_mode=p_mode, **mask)
    want = flash_attention_ref(q, k, v, **mask)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    err = float((got.float() - want.float()).abs().max())
    rel = _row_rel_err(got, want)
    print(f"P {p_mode}: abs {err}, row-relative {rel}")
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=0)
    assert rel <= 1e-2


# Qwen2-7B's layers under the reference's random init (PERF.md): q std
# ~11, k and v std ~30, scores std ~300
LM_STDS = (11.0, 30.0, 30.0)


def _ulp_excess(got, want):
    """How far ``got`` strays beyond one bf16 ulp of ``want`` (2^-7 of its
    magnitude), elementwise max: chip_smoke.py's per-layer hold."""
    want = want.float()
    return float(((got.float() - want).abs() - want.abs() * 2 ** -7).max())


@pytest.mark.parametrize("seed", [7, 8])
@pytest.mark.parametrize("p_mode", emulate.P_MODES)
def test_p_precision_at_the_lm_activations(p_mode, seed):
    """At the magnitudes of Qwen2-7B's layers under random weights,
    chip_smoke.py holds each layer's kernel output within 2e-2 beyond one
    bf16 ulp of the plain one.  The split P holds that on these inputs;
    one bf16 P misses it (its error is ~2^-9 of sum p |v|, 0.03-0.06
    here), which is why the kernel splits P."""
    q, k, v = _bf16_case(2, 256, 4, 1, 128, seed=seed, stds=LM_STDS)
    excess = _ulp_excess(
        emulate.flash_attention_emulated(q, k, v, p_mode=p_mode),
        flash_attention_ref(q, k, v))
    print(f"P {p_mode}, seed {seed}: excess beyond one bf16 ulp {excess}")
    if p_mode == port_kernel.p_mode():
        assert excess <= 2e-2
    else:
        assert excess > 2e-2


def test_p_mode_is_read_from_the_kernel_source():
    """The kernel's P mode comes from its source (two register-form
    products per step of ``issue_pv``: split), and the model rounds P
    that way by default."""
    assert port_kernel.p_mode() == "split"
    q, k, v = _bf16_case(1, 200, 2, 1, 64, seed=3, stds=LM_STDS)
    assert torch.equal(emulate.flash_attention_emulated(q, k, v),
                       emulate.flash_attention_emulated(q, k, v,
                                                        p_mode="split"))


PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116flash_tma_kernelILi64EEEv' for 'sm_90a'
ptxas info    : Used 154 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116flash_tma_kernelILi128EEEv' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_116flash_tma_kernelILi128EEEv
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116flash_simt_kernelILi128EEEv' for 'sm_90a'
ptxas info    : Used 90 registers
"""


def test_ptxas_report_reads_a_cached_build(tmp_path, monkeypatch):
    """A library built by an earlier process (nothing in BUILD_LOG) keeps
    nvcc's output beside it, and the ptxas report reads it from there."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "BUILD_LOG", {})
    lib = _build._lib_path("flash_attention")
    lib.write_bytes(b"")
    lib.with_suffix(".log").write_text(PTXAS_LOG)
    rep = _build.ptxas_report("flash_attention", "flash_tma_kernelILi128E")
    assert rep == {"registers": 168, "spill_stores": 4, "spill_loads": 12,
                   "perf_notes": 0}
    assert _build.ptxas_report("flash_attention",
                               "flash_tma_kernelILi64E")["registers"] == 154


def test_a_library_without_its_log_is_rebuilt(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    _build._lib_path("flash_attention").write_bytes(b"")

    def no_nvcc():
        raise RuntimeError("nvcc asked for")
    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc asked for"):
        _build.build_all(["flash_attention"])


@pytest.mark.parametrize("S,causal,window", [(1, True, 0), (127, True, 0),
                                             (129, False, 0), (300, True, 1),
                                             (700, False, 50),
                                             (1000, True, 300)])
def test_emulated_tiles_are_the_open_ones(S, causal, window):
    """The key tiles each 128-query block visits hold every key its masks
    leave open, and none of them is closed to the whole block."""
    rows = np.arange(S)[:, None]
    keys = np.arange(S)[None, :]
    open_ = np.ones((S, S), bool)
    if causal:
        open_ &= keys <= rows
    if window:
        open_ &= keys > rows - window
    for q0 in range(0, S, emulate.BLOCK_Q):
        block = open_[q0:q0 + emulate.BLOCK_Q]
        tiles = emulate.key_tiles(S, q0, causal, window)
        seen = np.zeros(S, bool)
        for kt in tiles:
            k0 = kt * emulate.BLOCK_K
            assert block[:, k0:k0 + emulate.BLOCK_K].any()
            seen[k0:k0 + emulate.BLOCK_K] = True
        assert not (block.any(0) & ~seen).any()


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
    (2, 129, 4, 2, 32, True, 50), (1, 1, 2, 1, 128, True, 0),
    # the edges of the bf16 kernel's 128-query blocks and 128-key tiles:
    # S one below and above a tile, S = 257 and 203 (not a multiple of 8),
    # window 1 and windows shorter than a tile, D 16 and 32 with GQA 7/1
    (2, 127, 4, 2, 128, True, 0), (2, 129, 4, 2, 128, False, 0),
    (1, 257, 2, 1, 128, True, 0), (1, 203, 4, 1, 64, True, 30),
    (2, 300, 4, 4, 64, True, 1), (1, 200, 2, 1, 128, False, 1),
    (1, 500, 4, 2, 128, True, 50), (1, 500, 2, 2, 128, False, 100),
    (2, 200, 7, 1, 16, True, 0), (2, 200, 7, 1, 32, False, 0),
    # head dims that run zero-padded: the reduced DeepSeek-67B's 8, the
    # reduced StableLM-12B's 20 and StableLM-12B's 160 (into the 64-key
    # tiles of D = 192), and 192 itself at tile edges
    (2, 100, 4, 2, 8, True, 0), (2, 77, 4, 1, 20, False, 30),
    (2, 300, 32, 8, 160, True, 0), (1, 129, 4, 4, 160, False, 0),
    (1, 65, 2, 1, 192, True, 0), (1, 200, 4, 2, 192, True, 50)])
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
def test_cuda_kernel_at_the_lm_activations(cuda_device):
    """At Qwen2-7B's prefill shape (B 4, S 4096, H 28, Hkv 4, D 128,
    causal) and its layers' magnitudes under random weights, the kernel
    within chip_smoke.py's per-layer hold (2e-2 beyond one bf16 ulp of the
    plain version), as is its model with P split; the model with one bf16
    P misses it.  Printed beside them: the model with its products summed
    on the tensor cores (TF32 matmuls: bf16 values and P's bf16 parts are
    exact in TF32), which the f32 model leaves out."""
    q, k, v = [x.to(cuda_device) for x in
               _bf16_case(4, 4096, 28, 4, 128, seed=7, stds=LM_STDS)]
    want = flash_attention_ref(q, k, v)
    got = {"kernel": mha(q, k, v)}
    for mode in emulate.P_MODES:
        got[f"model, P {mode}"] = emulate.flash_attention_emulated(
            q, k, v, p_mode=mode)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        got["model, P split, tensor-core sums"] = \
            emulate.flash_attention_emulated(q, k, v, p_mode="split")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    excess = {}
    for name, out in got.items():
        diff = (out.float() - want.float()).abs()
        excess[name] = _ulp_excess(out, want)
        beyond = int((diff > want.float().abs() * 2 ** -7).sum())
        print(f"{name}: excess beyond one bf16 ulp {excess[name]}, "
              f"{beyond} elements beyond one ulp, max abs "
              f"{float(diff.max())}")
    assert excess["kernel"] <= 2e-2
    assert excess["model, P split"] <= 2e-2
    assert excess["model, P bf16"] > 2e-2


@pytest.mark.cuda
def test_cuda_mha_raises_for_unsupported_head_dim(cuda_device):
    q = torch.zeros((1, 8, 2, 200), device=cuda_device)
    k = torch.zeros((1, 8, 1, 200), device=cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        mha(q, k, k)
