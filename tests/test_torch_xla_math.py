"""The workload engine's f32 arithmetic (``repro_torch.core.workload``'s
``rng`` and ``xla_math``) against the JAX package's, on the CPU, bitwise:

 * the threefry draws along the generator's key tree;
 * the f32 prefix sum in XLA's CPU addition order (``cumsum_f32``), and
   the measured facts behind the port's design (printed under ``-s``);
 * the f32 transcendentals (``xla_math``): ``fma_f32`` against an exact
   ``fmaf``, ``log1p`` over every value the generator can give it (all
   2**23 uniforms), the Zipf inversion's ``pow`` / ``exp`` / ``log``
   expressions over every uniform at the presets' knob pairs and over
   every 7th at the fig-8 apps' knobs.

The ``cuda`` case holds ``xla_math`` on the card against the CPU.  The
rest of the engine is in ``test_torch_workload.py``, fig 17's scale in
``test_torch_workload_fig17.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import traces as jtr
from repro.core.workload import generators as jg
from repro_torch.core import traces as ptr
from repro_torch.core.workload import generators as pg
from repro_torch.core.workload import rng
from repro_torch.core.workload import xla_math as xm
from torch_workload_common import CPU, _jax_core_keys

# generate_stream's epoch seeds for seed 3, epochs 1 and 2
STREAM_SEEDS = tuple((3 + 7919 * e) & 0x7FFFFFFF for e in (1, 2))


# ---------------------------------------------------------------------------
# (a) draws, bitwise

def _port_core_keys(seed, n_cores):
    return rng.fold_in(rng.prng_key(seed, CPU)[None],
                       torch.arange(n_cores))


@pytest.mark.parametrize("seed", (0, 3, 2 ** 31 - 1) + STREAM_SEEDS)
def test_draws_bitwise(seed):
    assert jax.config.jax_threefry_partitionable, \
        "the port reproduces the partitionable threefry counters"
    assert np.array_equal(np.asarray(jax.random.PRNGKey(seed)),
                          rng.prng_key(seed, CPU).numpy())
    jk, pk = _jax_core_keys(seed, 8), _port_core_keys(seed, 8)
    assert np.array_equal(np.asarray(jk).astype(np.int64), pk.numpy())
    for tag in (0, 1, 2, 11, 12):
        a = jax.vmap(lambda k: jg._uniforms(k, 257, tag, 5))(jk)
        b = pg._uniforms(pk, 257, tag, 5)
        assert np.array_equal(np.asarray(a).view(np.int32),
                              b.numpy().view(np.int32)), tag
    # ids as the generator forms them: visit * 8 + ctx and
    # gen_id * 65536 + slot, past 2**31 (the JAX package's int32 wraps)
    ids = np.concatenate([np.arange(0, 40000, 7), 65536 * np.arange(
        32760, 32800) + 5]).astype(np.int64)
    ids32 = ids.astype(np.uint32).view(np.int32)
    a = jax.vmap(lambda k: jg._id_uniforms(k, jnp.asarray(ids32), 2, 4))(jk)
    b = pg._id_uniforms(pk, torch.from_numpy(ids)[None].expand(8, -1), 2, 4)
    assert np.array_equal(np.asarray(a), b.numpy())


# ---------------------------------------------------------------------------
# (b) the f32 prefix sum, bitwise

_jcumsum = jax.jit(jnp.cumsum)


@pytest.mark.parametrize("n", (1, 15, 16, 17, 256, 257, 4097, 5242, 70001))
def test_cumsum_f32_bitwise(n):
    r = np.random.default_rng(n)
    x = (r.exponential(size=n) * (r.random(n) < 0.4)).astype(np.float32)
    want = np.asarray(_jcumsum(x))
    got = rng.cumsum_f32(torch.from_numpy(x)).numpy()
    assert np.array_equal(want, got)


def test_cumsum_f32_batched_bitwise():
    """As the generator applies it: (W, n_cores, n) under vmap."""
    x = (np.random.default_rng(1).exponential(size=(3, 2, 5242)) * 250
         ).astype(np.float32)
    want = np.asarray(jax.jit(jax.vmap(jax.vmap(jnp.cumsum)))(x))
    assert np.array_equal(want, rng.cumsum_f32(torch.from_numpy(x)).numpy())


def _cumsum_fact():
    """Entries of an f32 prefix sum that differ from jnp.cumsum: none for
    cumsum_f32; most for np.cumsum and torch.cumsum, and some even after
    the int cast of an arrival clock."""
    r = np.random.default_rng(0)
    for n in (256, 4097, 20000, 70001):
        x = (r.exponential(size=n) * 300 * (r.random(n) < 0.4)
             ).astype(np.float32)
        want, t = np.asarray(_jcumsum(x)), torch.from_numpy(x)
        port = rng.cumsum_f32(t).numpy()
        assert np.array_equal(want, port), n
        other = torch.cumsum(t, 0).numpy()
        print(f"cumsum n={n}: port 0, numpy "
              f"{int((np.cumsum(x) != want).sum())}, torch "
              f"{int((other != want).sum())}, torch after the int cast "
              f"{int((other.astype(np.int32) != want.astype(np.int32)).sum())}")


# the generator's transcendentals on 1e6 uniforms, each op's argument made
# in numpy: (argument, XLA's op, torch's f32 op, the float64 op rounded
# once to float32 that the port used before xla_math, the port's op)
ULP_CASES = {
    "log1p": (lambda u: -np.minimum(u, np.float32(0.999999)), jnp.log1p,
              torch.log1p, lambda t: torch.log1p(t.double()).float(),
              xm.log1p_f32),
    "log": (lambda u: u * np.float32(8191) + np.float32(1), jnp.log,
            torch.log, lambda t: torch.log(t.double()).float(), xm.log_f32),
    "exp": (lambda u: u * np.float32(8.3), jnp.exp, torch.exp,
            lambda t: torch.exp(t.double()).float(), xm.exp_f32),
    "pow": (lambda u: u * np.float32(4095) + np.float32(1),
            lambda x, y: x ** y,
            lambda t: torch.pow(t, -10.0),
            lambda t: torch.pow(t.double(), -10.0).float(),
            lambda t: xm.pow_f32(t, -10.0)),
}


def _ulp_fact():
    """The share of inputs on which an f32 transcendental differs from
    XLA's: torch's f32 op, the float64 op rounded once (the port before
    ``xla_math``) and ``xla_math``'s, which differs on none.  ``pow``'s
    exponent is a traced argument, as the generator's is."""
    u = np.random.default_rng(0).random(1_000_000).astype(np.float32)
    for name, (arg, xla, f32, before, port) in ULP_CASES.items():
        x = arg(u).astype(np.float32)
        want = np.asarray(jax.jit(xla)(x, np.float32(-10.0)) if name == "pow"
                          else jax.jit(xla)(x))
        t = torch.from_numpy(x)
        off = {k: int((fn(t).numpy().view(np.int32)
                       != want.view(np.int32)).sum())
               for k, fn in (("torch f32", f32), ("float64 rounded", before),
                             ("xla_math", port))}
        print(f"ulp {name} (of {x.size}): {off}")
        assert off["xla_math"] == 0, name


FACTS = {"cumsum": _cumsum_fact, "ulp": _ulp_fact}


@pytest.mark.parametrize("fact", FACTS)
def test_reference_facts(fact):
    """The measured facts behind the port's design, printed under -s."""
    FACTS[fact]()


# ---------------------------------------------------------------------------
# (b') the transcendentals over every value the generator can give them

# jax.random.uniform gives only k * 2**-23; every transcendental of the
# generator takes u (or an affine function of it) and per-core knobs
U_ALL = np.arange(2 ** 23, dtype=np.int64).astype(np.float32) * \
    np.float32(2.0 ** -23)
PRESET_KNOBS = [(n, a) for a in (1.1, 1.2) for n in (1024, 2048, 4096, 8192)]


def _bitwise_off(want, got) -> int:
    return int((np.asarray(want).view(np.int32)
                != got.numpy().view(np.int32)).sum())


def _fmaf_exact(a, b, c) -> np.float32:
    """``fmaf(a, b, c)`` from exact rational arithmetic: the f32 nearest
    ``a * b + c``, ties to even."""
    from fractions import Fraction
    exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    near = np.float32(float(exact))
    cands = [np.nextafter(near, np.float32(-np.inf)), near,
             np.nextafter(near, np.float32(np.inf))]
    dist = [abs(Fraction(float(x)) - exact) for x in cands]
    best = min(dist)
    ties = [x for x, d in zip(cands, dist) if d == best]
    return min(ties, key=lambda x: int(np.array(x).view(np.int32)) & 1)


def test_fma_f32_is_fmaf():
    """``fma_f32`` rounds once: equal to the exact result on random
    triples, and on sums the float64 route would round to an f32 tie
    (``(1 + 2**-23) * -2**-24 (1 - 2**-23) + (1 + 2**-23)`` lies 2**-70
    above the tie, so rounding to float64 first gives 1, not 1 + 2**-23)."""
    one_up = np.float32(1 + 2.0 ** -23)
    b = np.float32(-(2.0 ** -24) * (1 - 2.0 ** -23))
    tie = [(one_up, b, one_up), (-one_up, b, -one_up)]
    r = np.random.default_rng(7)
    rand = r.standard_normal((400, 3)).astype(np.float32) * \
        np.float32(2.0) ** r.integers(-20, 20, (400, 3)).astype(np.float32)
    cases = tie + [tuple(x) for x in rand]
    a_, b_, c_ = (torch.tensor(np.array(col, np.float32))
                  for col in zip(*cases))
    got = xm.fma_f32(a_, b_, c_).numpy()
    want = np.array([_fmaf_exact(*t) for t in cases], np.float32)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    assert got[0] == one_up and np.float32(
        np.float64(one_up) * np.float64(b) + np.float64(one_up)) == 1.0


def test_xla_log1p_exhaustive():
    """The arrival gap's ``log1p(-min(u, 0.999999))`` over all 2**23 u."""
    want = jax.jit(lambda u: jnp.log1p(-jnp.minimum(u, 0.999999)))(U_ALL)
    got = xm.log1p_f32(-torch.clamp_max(torch.from_numpy(U_ALL), 0.999999))
    assert _bitwise_off(want, got) == 0


@jax.jit
def _jax_zipf_k(u, n_pages, a):
    """``_zipf_from_u``'s two float expressions, as it jits them: the knobs
    are traced, so XLA fuses and contracts as in the generator."""
    n = n_pages.astype(jnp.float32)
    one_m = 1.0 - a
    near1 = jnp.abs(one_m) < 1e-3
    safe = jnp.where(near1, 1.0, one_m)
    return ((u * (n ** safe - 1.0) + 1.0) ** (1.0 / safe),
            jnp.exp(u * jnp.log(n)))


def _port_zipf_k(u, n_pages, a):
    n = torch.tensor(n_pages, dtype=torch.int32, device=u.device).float()
    one_m = 1.0 - torch.tensor(a, dtype=torch.float32, device=u.device)
    near1 = torch.abs(one_m) < 1e-3
    safe = torch.where(near1, torch.ones_like(one_m), one_m)
    return (xm.pow_f32(xm.fma_f32(u, xm.pow_f32(n, safe) - 1.0, 1.0),
                       1.0 / safe),
            xm.exp_f32(u * xm.log_f32(n)))


def _zipf_k_off(u, n_pages, a):
    want = _jax_zipf_k(u, np.int32(n_pages), np.float32(a))
    got = _port_zipf_k(torch.from_numpy(u), n_pages, a)
    return [_bitwise_off(w, g) for w, g in zip(want, got)]


@pytest.mark.parametrize("n_pages,zipf_a", PRESET_KNOBS)
def test_xla_zipf_exhaustive(n_pages, zipf_a):
    """``(u (n**s - 1) + 1) ** (1/s)`` and ``exp(u log n)`` over all 2**23
    u at the presets' knobs: glibc ``powf``, the contracted ``fmaf`` and
    XLA's ``exp`` / ``log``."""
    assert _zipf_k_off(U_ALL, n_pages, zipf_a) == [0, 0]


@pytest.mark.parametrize("app", jtr.ALL_APPS)
def test_xla_zipf_apps(app):
    """The same at each fig-8 app's knobs (``spec_from_apps``), over every
    7th u: zipf_a from 0.9 to 1.4, so both signs of ``1 - a``."""
    ap = ptr.app_params(app)
    assert _zipf_k_off(U_ALL[::7], ap.n_pages, ap.zipf_a) == [0, 0]


# ---------------------------------------------------------------------------
# the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device to generate on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_transcendentals_match_cpu(cuda_device):
    """xla_math on the card against the CPU over all 2**23 u: log1p, and
    the Zipf expressions at the presets' knobs."""
    u = torch.from_numpy(U_ALL)
    arg = -torch.clamp_max(u, 0.999999)
    assert torch.equal(xm.log1p_f32(arg),
                       xm.log1p_f32(arg.to(cuda_device)).cpu())
    for n, a in PRESET_KNOBS:
        cpu = _port_zipf_k(u, n, a)
        card = _port_zipf_k(u.to(cuda_device), n, a)
        for x, y in zip(cpu, card):
            assert torch.equal(x, y.cpu()), (n, a)
