"""The port's workload engine (``repro_torch.core.workload``) against the
JAX package's (``repro.core.workload``), on the CPU.

 * bitwise: the threefry draws along the generator's key tree, the f32
   prefix sum (XLA's CPU addition order), channel assembly, and the port's
   own contracts (spec entries of ``sweep_traces``, ``generate_many`` equal
   to singles, ``content_hash`` digests equal to the JAX package's);
 * within stated bounds: each family's streams before assembly (the f32
   clock within 1e-6 relative; bounded-Zipf pages, and the columns derived
   from them, off by exactly one rank on at most 1e-3 of requests, because
   the transcendentals are float64 rounded to float32 where XLA uses its
   own f32 polynomials) and whole traces (the stream, stride and
   pointer-chase families bitwise but for four named one-tick arrivals;
   every family's ``characterize`` stats within 0.01);
 * the statistical tests of ``tests/test_workload.py`` on the port's
   generator, thresholds unchanged;
 * ``generate_stream`` epochs replayed streamed and monolithic.

``cuda`` cases hold the card against the CPU route and count the device
launches of one ``generate``."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import traces as jtr
from repro.core import workload as jw
from repro.core.timing import GEOM as JGEOM
from repro.core.workload import generators as jg
from repro_torch.core import dram as pd
from repro_torch.core import simulator as ps
from repro_torch.core import streaming as pst
from repro_torch.core import traces as ptr
from repro_torch.core import workload as pw
from repro_torch.core.timing import GEOM, paper_config
from repro_torch.core.workload import generators as pg
from repro_torch.core.workload import rng

CPU = "cpu"
# small-but-significant shapes: 2 cores x 2 channels x 2048 requests
SMALL = dict(n_cores=2, n_channels=2, per_channel=2048)
FAMILY_N = 5242                 # requests per core of the family checks
# (c)'s shapes: FAMILY_N per core, and fig 17's 8 cores x 4 x 6144
FAMILY_SHAPES = {"n5242": dict(n_cores=2, n_channels=2, per_channel=2457),
                 "fig17": dict(n_cores=8, n_channels=4, per_channel=6144)}
ZIPF_FRAC = 1e-3                # pages off by one rank, at most
CLOCK_REL = 1e-6
STAT_TOL = 0.01
EXACT = ("stream", "stride", "pointer_chase")
# generate_stream's epoch seeds for seed 3, epochs 1 and 2
STREAM_SEEDS = tuple((3 + 7919 * e) & 0x7FFFFFFF for e in (1, 2))


def _np(tr):
    return [pd.host_array(x) for x in tr]


def _jspec(spec: pw.WorkloadSpec) -> jw.WorkloadSpec:
    """The JAX package's spec with the same contents."""
    cores = tuple(jw.CoreWorkload(**{
        f: getattr(c, f) for f in c.__dataclass_fields__}) for c in spec.cores)
    return jw.WorkloadSpec(family=spec.family, cores=cores,
                           n_channels=spec.n_channels,
                           per_channel=spec.per_channel, seed=spec.seed)


@functools.lru_cache(maxsize=None)
def _spec(family: str, seed: int = 3, **overrides):
    return pw.preset(family, seed=seed, **{**SMALL, **overrides})


@functools.lru_cache(maxsize=None)
def _trace(family: str, seed: int = 3, **overrides):
    return pw.generate(_spec(family, seed, **overrides), device=CPU)


@functools.lru_cache(maxsize=None)
def _profile(family: str, seed: int = 3, **overrides):
    return pw.characterize(_trace(family, seed, **overrides))


# ---------------------------------------------------------------------------
# (a) draws, bitwise

def _jax_core_keys(seed, n_cores):
    key = jax.random.PRNGKey(seed)
    return jax.vmap(lambda c: jax.random.fold_in(key, c))(
        jnp.arange(n_cores, dtype=jnp.int32))


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
# in numpy: (argument, XLA's op, torch's f32 op, the port's op)
ULP_CASES = {
    "log1p": (lambda u: -np.minimum(u, np.float32(0.999999)), jnp.log1p,
              torch.log1p, pg._log1p),
    "log": (lambda u: u * np.float32(8191) + np.float32(1), jnp.log,
            torch.log, pg._log),
    "exp": (lambda u: u * np.float32(8.3), jnp.exp, torch.exp, pg._exp),
    "pow": (lambda u: u * np.float32(4095) + np.float32(1),
            lambda x: x ** np.float32(-10.0),
            lambda t: torch.pow(t, -10.0),
            lambda t: pg._pow(t, torch.full_like(t, -10.0))),
}


def _ulp_fact():
    """The share of inputs on which an f32 transcendental differs from
    XLA's, for torch's f32 op and for the port's float64 op rounded once
    to float32: the port's is never the farther."""
    u = np.random.default_rng(0).random(1_000_000).astype(np.float32)
    for name, (arg, xla, f32, port) in ULP_CASES.items():
        x = arg(u).astype(np.float32)
        want, t = np.asarray(jax.jit(xla)(x)), torch.from_numpy(x)
        off_f32 = float((f32(t).numpy() != want).mean())
        off_port = float((port(t).numpy() != want).mean())
        print(f"ulp {name}: torch f32 {off_f32}, port {off_port}")
        assert off_port <= off_f32, name


FACTS = {"cumsum": _cumsum_fact, "ulp": _ulp_fact}


@pytest.mark.parametrize("fact", FACTS)
def test_reference_facts(fact):
    """The measured facts behind the port's design, printed under -s."""
    FACTS[fact]()


# ---------------------------------------------------------------------------
# (c) each family before assembly

@functools.lru_cache(maxsize=None)
def _family_pair(family, shape="n5242", seed=3):
    spec = pw.preset(family, seed=seed, **FAMILY_SHAPES[shape])
    n = pg.per_core_requests(spec.n_cores, spec.n_channels, spec.per_channel)
    jfn = jax.jit(jax.vmap(lambda k, p: jg._FAMILY_FNS[family](k, p, n)))
    want = [np.asarray(x) for x in jfn(_jax_core_keys(seed, spec.n_cores),
                                       _jspec(spec).params())]
    got = [x.numpy() for x in pg.family_streams(spec, CPU)]
    return want, got


def _check_streams(family, want, got):
    """(c)'s bound; returns (zipf rank mismatch fraction, clock mismatch
    fraction)."""
    (tw, pw_, cw, ww), (tg, pg_, cg, wg) = want, got
    assert np.array_equal(ww, wg), "write flags"
    rel = np.abs(tw - tg) / np.maximum(np.abs(tw), 1e-30)
    assert rel.max() <= CLOCK_REL, rel.max()
    off = pw_ != pg_
    if family in EXACT:
        assert not off.any() and np.array_equal(cw, cg)
    else:
        assert (np.abs(pw_[off].astype(np.int64) - pg_[off]) == 1).all()
        assert off.mean() <= ZIPF_FRAC, off.mean()
        assert np.array_equal(cw[~off], cg[~off])
    return float(off.mean()), float((tw != tg).mean())


@pytest.mark.parametrize("shape", FAMILY_SHAPES)
@pytest.mark.parametrize("family", jw.FAMILIES)
def test_family_streams_match_jax(family, shape):
    want, got = _family_pair(family, shape)
    if shape == "n5242":
        assert want[0].shape[-1] == FAMILY_N
    zipf, clock = _check_streams(family, want, got)
    rel = np.abs(want[0] - got[0]) / np.maximum(want[0], 1e-30)
    print(f"{family} {shape} ({want[0].size} requests): zipf rank mismatch "
          f"{zipf}, clock mismatch {clock}, largest relative {rel.max()}")


# ---------------------------------------------------------------------------
# (d) assembly, bitwise

def _assembly_case(case):
    want, _ = _family_pair("stream" if case != "zipf" else "zipf_reuse")
    t, page, col, wr = want
    if case == "underfill":           # 2 x 300 requests, 2 x 512 slots
        t, page, col, wr = (x[:, :300] for x in (t, page, col, wr))
        return (t, page, col, wr), 2, 512
    if case == "clamp":               # the late tail past NOOP_ISSUE - 64
        t = t * np.float32(pd.NOOP_ISSUE / t[:, -1].min() * 1.5)
        return (t, page, col, wr), 2, 6000
    return (t, page, col, wr), 2, 2048


@pytest.mark.parametrize("case", ("stream", "zipf", "underfill", "clamp"))
def test_assemble_bitwise(case):
    streams, C, T = _assembly_case(case)
    want = jax.jit(lambda s: jg._assemble(s, C, T, JGEOM))(
        tuple(jnp.asarray(x) for x in streams))
    got = pg._assemble([torch.from_numpy(np.array(x))[None]
                        for x in streams], C, T, GEOM)
    for name, a, b in zip(want._fields, want, got):
        assert np.array_equal(np.asarray(a), b[0].numpy()), name
    t = np.asarray(want.t_issue)
    if case == "underfill":
        assert (t == pd.NOOP_ISSUE).any(), "the case must under-fill"
    if case == "clamp":
        assert (t == pd.NOOP_ISSUE - 64).any(), "the case must clamp"


# ---------------------------------------------------------------------------
# (e) end to end against the JAX package's generate

E2E = dict(n_cores=2, n_channels=2, per_channel=1024)
# (channel, slot) entries whose arrival tick is one below the JAX package's
# at these seeds: a float64-rounded log1p one ulp off XLA's moves the f32
# clock across an integer (the stride case is one burst of three)
ONE_TICK = {("stride", 1): ((0, 70), (0, 71), (1, 71)),
            ("pointer_chase", 1): ((1, 446),)}


def _close_stats(a, b):
    for k in ("row_hit_potential", "visit_footprint_mean",
              "life_footprint_mean", "write_frac"):
        assert abs(a[k] - b[k]) <= STAT_TOL, (k, a[k], b[k])
    gap = np.abs(np.asarray(a["visit_footprint_cdf"])
                 - np.asarray(b["visit_footprint_cdf"])).max()
    assert gap <= STAT_TOL, gap


@pytest.mark.parametrize("seed", (1, 2, 3))
@pytest.mark.parametrize("family", jw.FAMILIES)
def test_generate_matches_jax(family, seed):
    spec = pw.preset(family, seed=seed, **E2E)
    want = jw.generate(_jspec(spec))
    got = pw.generate(spec, device=CPU)
    print(f"{family} seed {seed}: entries off a leaf", {
        name: int((np.asarray(a) != b.numpy()).sum())
        for name, a, b in zip(want._fields, want, got)})
    if family in EXACT:
        for name, a, b in zip(want._fields[1:], want[1:], got[1:]):
            assert np.array_equal(np.asarray(a), b.numpy()), name
        a, b = np.asarray(want.t_issue), got.t_issue.numpy()
        off = tuple(map(tuple, np.argwhere(a != b).tolist()))
        assert off == ONE_TICK.get((family, seed), ()), off
        assert all(a[i] - b[i] == 1 for i in off)
    _close_stats(jw.characterize(want), pw.characterize(got))


def test_spec_from_apps_matches_jax():
    apps = [ptr.app_params(n) for n in ("mcf", "libquantum")]
    spec = pw.spec_from_apps(apps, 2, 4096, seed=5)
    want = jw.generate(_jspec(spec))
    _close_stats(jw.characterize(want),
                 pw.characterize(pw.generate(spec, device=CPU)))


# characterize / summarize: one numpy trace into both packages' copies

def _profile_input(source):
    """A trace with numpy leaves and its AppParams per core (or None): the
    JAX package's generate for a family, else the numpy oracle."""
    if source == "build_trace":
        names = ("mcf", "libquantum")
        tr = ptr.build_trace([ptr.app_params(n) for n in names], 2, 4096, 5)
        return tr, ([ptr.app_params(n) for n in names],
                    [jtr.app_params(n) for n in names])
    return [np.asarray(x) for x in jw.generate(_jspec(_spec(source)))], None


@pytest.mark.parametrize("source", jw.FAMILIES + ("build_trace",))
def test_profile_matches_jax(source):
    """Every key of characterize, and summarize, equal to the JAX
    package's on the same trace (the port's given it as tensors)."""
    leaves, apps = _profile_input(source)
    papps, japps = apps or (None, None)
    want = jw.characterize(pd.Trace(*leaves), apps=japps)
    got = pw.characterize(pd.Trace(*[torch.from_numpy(np.array(x))
                                     for x in leaves]), apps=papps)
    assert want.keys() == got.keys()
    for k in want:
        a, b = want[k], got[k]
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), k
        else:
            assert type(a) is type(b) and a == b, (k, a, b)
    assert jw.summarize(want) == pw.summarize(got)


# ---------------------------------------------------------------------------
# (f) the port's own contracts

def test_sweep_traces_accepts_specs_bitwise():
    specs = [_spec("stream", per_channel=1024),
             _spec("embed", per_channel=1024)]
    cfgs = [paper_config("base"), paper_config("figcache_fast")]
    got = ps.sweep_traces(specs, cfgs, device=CPU)
    ref = ps.sweep_traces([pw.generate(s, device=CPU) for s in specs],
                          cfgs, [s.apps() for s in specs], device=CPU)
    for w in range(len(specs)):
        for i in range(len(cfgs)):
            for name, x, y in zip(got[w][i].counters._fields,
                                  got[w][i].counters, ref[w][i].counters):
                assert np.array_equal(x, y), (w, i, name)


def test_generate_many_batches_and_matches_single():
    """A workload grid sharing one static structure generates as one batch
    AND reproduces per-spec generation bitwise."""
    specs = [_spec("embed", seed=s, per_channel=1024) for s in (1, 2)] + \
            [_spec("embed", seed=1, per_channel=1024, zipf_a=1.4)]
    singles = [pw.generate(s, device=CPU) for s in specs]
    before = pw.gen_trace_count()
    batched = pw.generate_many(specs, device=CPU)
    assert pw.gen_trace_count() - before <= 1, \
        "a same-structure grid must build at most one generator"
    for one, many in zip(singles, batched):
        for name, x, y in zip(one._fields, one, many):
            assert torch.equal(x, y), name


def test_content_hash_discipline():
    """Equal content hashes equal; any knob/seed/shape change splits the
    key; the digests are the JAX package's."""
    a = _spec("embed")
    b = pw.preset("embed", seed=3, **SMALL)
    assert a is not b and pw.content_hash(a) == pw.content_hash(b)
    assert pw.content_hash(a) != pw.content_hash(_spec("embed", seed=4))
    assert pw.content_hash(a) != pw.content_hash(_spec("embed", rw=0.06))
    assert pw.content_hash(a) != pw.content_hash(_spec("stream"))
    apps = tuple(ptr.app_params(n) for n in ("mcf", "lbm"))
    assert pw.content_hash((apps, 1024, 2)) == \
        pw.content_hash((tuple(apps), 1024, 2))
    from repro.core import traces as jtr
    japps = tuple(jtr.app_params(n) for n in ("mcf", "lbm"))
    for spec in (a, _spec("stream", rw=0.4),
                 pw.spec_from_apps(apps, 4, 6144, seed=2)):
        assert pw.content_hash(spec) == jw.content_hash(_jspec(spec))
        assert spec.content_hash() == pw.content_hash(spec)
    assert pw.content_hash((apps, 1024, 2)) == \
        jw.content_hash((japps, 1024, 2))


def test_mechanism_ordering_on_device_trace():
    """Figs 7/8 orderings survive the trace source swap: on a generated
    intensive app, FIGCache-Ideal >= FIGCache-Fast > 1, and LL-DRAM beats
    Base."""
    spec = pw.spec_from_apps([ptr.app_params("mcf")], 1, 3072, seed=1)
    s = ps.speedup_summary(ps.run_scenario(
        spec, mechanisms=("base", "figcache_fast", "figcache_ideal",
                          "lldram"), device=CPU))
    assert s["figcache_fast"] > 1.0
    assert s["figcache_ideal"] >= s["figcache_fast"] - 1e-6
    assert s["lldram"] > 1.0


def test_entry_points_default_to_the_card(monkeypatch):
    """``device=None`` means CUDA: without it generation, spec entries of
    ``sweep_traces`` and ``run_scenario`` raise instead of running on the
    CPU.  CUDA is hidden so this holds on any machine."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = _spec("stream", per_channel=64)
    for call in (lambda: spec.params(), lambda: pw.generate(spec),
                 lambda: pw.generate_many([spec]),
                 lambda: next(pw.generate_stream(spec, 1)),
                 lambda: ps.sweep_traces([spec], [paper_config("base")]),
                 lambda: ps.run_scenario(spec, mechanisms=("base",))):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


# ---------------------------------------------------------------------------
# (g) statistics: tests/test_workload.py on the port's generator

@pytest.mark.parametrize("family", pw.FAMILIES)
def test_trace_well_formed(family):
    tr = _np(_trace(family))
    t = tr[0]
    assert t.shape == (SMALL["n_channels"], SMALL["per_channel"])
    assert t.dtype == np.int32
    for c in range(t.shape[0]):
        assert (np.diff(t[c]) >= 0).all(), "t_issue must be sorted"
        real = t[c] < pd.NOOP_ISSUE
        assert real[: real.sum()].all(), "no-op padding must be a suffix"
        assert real.mean() > 0.9, "channels should fill from the margin"
    _, bank, row, col, wr, core = tr
    assert bank.min() >= 0 and bank.max() < GEOM.n_banks
    assert row.min() >= 0 and row.max() < GEOM.n_rows
    assert col.min() >= 0 and col.max() < GEOM.row_blocks
    assert core.max() < SMALL["n_cores"]
    assert wr.dtype == bool


@pytest.mark.parametrize("family", pw.FAMILIES)
def test_write_fraction_targets_params(family):
    spec, prof = _spec(family), _profile(family)
    assert abs(prof["write_frac"] - spec.cores[0].rw) < 0.05


@pytest.mark.parametrize("family", pw.FAMILIES)
def test_interarrival_targets_params(family):
    spec, prof = _spec(family), _profile(family)
    core = spec.cores[0]
    expect = core.interarrival_ns * spec.n_cores / spec.n_channels
    assert 0.5 * expect < prof["interarrival_ns_mean"] < 2.0 * expect


def test_generation_is_deterministic():
    a = pw.generate(_spec("embed"), device=CPU)
    b = pw.generate(_spec("embed"), device=CPU)
    for name, x, y in zip(a._fields, a, b):
        assert torch.equal(x, y), name


def test_seed_changes_trace():
    assert not torch.equal(_trace("embed", seed=3).row,
                           _trace("embed", seed=4).row)


def test_one_generator_per_structure():
    """Knob and seed changes reuse the structure's generator."""
    pw.generate(_spec("stride"), device=CPU)
    before = pw.gen_trace_count()
    pw.generate(_spec("stride", seed=9, stride=29, rw=0.4), device=CPU)
    assert pw.gen_trace_count() == before


def _zipf_tail():
    spec = _spec("embed", per_channel=8192, n_channels=1, n_cores=1)
    t, _, row, *_ = _np(pw.generate(spec, device=CPU))
    freq = np.sort(np.bincount(row[0][t[0] < pd.NOOP_ISSUE]))[::-1]
    top = freq[: max((freq > 4).sum(), 10)].astype(float)  # resolved head
    k = np.arange(1, top.size + 1, dtype=float)
    slope = np.polyfit(np.log(k), np.log(top), 1)[0]
    assert abs(-slope - spec.cores[0].zipf_a) < 0.35, slope


def _stream_footprint_high():
    prof = pw.characterize(_trace("stream", n_cores=1, n_channels=1))
    assert prof["life_footprint_mean"] > 0.9
    assert prof["row_hit_potential"] > 0.9
    assert prof["visit_len_mean"] > 20


def _stream_partial_footprint():
    prof = pw.characterize(_trace("stream", n_cores=1, n_channels=1,
                                  touch_segs=1))
    assert prof["life_footprint_mean"] < 0.2      # 1 of 8 segments


def _stride_fixed_distance_reuse():
    spec = _spec("stride", n_cores=1, n_channels=1)
    tr = _trace("stride", n_cores=1, n_channels=1)
    assert pw.characterize(tr)["life_footprint_mean"] < 0.5
    assert np.unique(tr.row[0].numpy()).size <= spec.cores[0].n_pages + 1


def _pointer_chase_latency_bound():
    prof = _profile("pointer_chase")
    assert prof["interarrival_ns_mean"] > 25.0      # 90 ns / (8c / 2ch) * tol
    assert prof["visit_len_mean"] < 2.0             # no spatial runs
    assert _profile("embed")["blp_mean"] < prof["blp_mean"]


def _embed_one_hot_segment_per_row():
    prof = _profile("embed")
    assert abs(prof["visit_footprint_mean"] - 1 / 8) < 0.02
    assert abs(prof["life_footprint_mean"] - 1 / 8) < 0.02


def _phase_mix_interpolates():
    mix = _profile("phase_mix")
    zipf, stream = _profile("zipf_reuse"), _profile("stream")
    lo, hi = sorted((zipf["row_hit_potential"], stream["row_hit_potential"]))
    assert lo - 0.05 < mix["row_hit_potential"] < hi + 0.05
    assert mix["life_footprint_mean"] > zipf["life_footprint_mean"]


SHAPES = {
    "zipf_tail_exponent": _zipf_tail,
    "stream_footprint_high": _stream_footprint_high,
    "stream_partial_footprint": _stream_partial_footprint,
    "stride_fixed_distance_reuse": _stride_fixed_distance_reuse,
    "pointer_chase_latency_bound": _pointer_chase_latency_bound,
    "embed_one_hot_segment_per_row": _embed_one_hot_segment_per_row,
    "phase_mix_interpolates": _phase_mix_interpolates,
}


@pytest.mark.parametrize("shape", SHAPES)
def test_family_shape(shape):
    """The per-family statistical properties of tests/test_workload.py."""
    SHAPES[shape]()


def test_zipf_reuse_matches_oracle_headline_stats():
    """The device zipf_reuse port reproduces the numpy oracle's headline
    stats within tests/test_workload.py's tolerances."""
    apps = [ptr.app_params(n) for n in ("mcf", "libquantum")]
    ref = pw.characterize(ptr.build_trace(apps, 2, 4096, 5))
    dev = pw.characterize(pw.generate(
        pw.spec_from_apps(apps, 2, 4096, seed=5), device=CPU))
    assert abs(ref["row_hit_potential"] - dev["row_hit_potential"]) < 0.1
    assert abs(ref["visit_footprint_mean"] - dev["visit_footprint_mean"]) \
        < 0.05
    assert abs(ref["life_footprint_mean"] - dev["life_footprint_mean"]) < 0.1
    assert abs(ref["write_frac"] - dev["write_frac"]) < 0.05
    cdf_gap = np.abs(np.asarray(ref["visit_footprint_cdf"])
                     - np.asarray(dev["visit_footprint_cdf"])).max()
    assert cdf_gap < 0.12, cdf_gap
    assert 0.6 < dev["visit_len_mean"] / ref["visit_len_mean"] < 1.6
    assert 0.5 < (dev["interarrival_ns_mean"]
                  / ref["interarrival_ns_mean"]) < 2.0
    assert 0.7 < dev["blp_mean"] / ref["blp_mean"] < 1.4


# ---------------------------------------------------------------------------
# (h) streaming

STREAM_SPEC = dict(n_cores=2, n_channels=2, per_channel=160, seed=9)


def test_generate_stream_replays_bitwise():
    """The concatenation of generate_stream's segments (epoch-tail no-ops
    landing interior) replays monolithically to the streamed counters, and
    arrival clocks stay continuous across the epoch boundary."""
    spec = pw.preset("stream", **STREAM_SPEC)
    segs = list(pw.generate_stream(spec, 2, device=CPU))
    assert len(segs) == 2
    a, b = (s.t_issue for s in segs)
    assert b[b < pd.NOOP_ISSUE].min() > a[a < pd.NOOP_ISSUE].max()
    cat = pd.Trace(*[np.concatenate(xs, axis=-1) for xs in zip(*segs)])
    cfg = paper_config("figcache_fast", cache_rows=2)
    want = pd.run_channels(cat, cfg, device=CPU)
    got = pst.simulate_stream(iter(segs), cfg, device=CPU)
    for name, x, y in zip(want._fields, want, got):
        assert torch.equal(x, y), name


@pytest.mark.parametrize("family", ("stream", "embed"))
def test_generate_stream_matches_jax(family):
    spec = pw.preset(family, **STREAM_SPEC)
    want = list(jw.generate_stream(_jspec(spec), 3))
    got = list(pw.generate_stream(spec, 3, device=CPU))
    assert len(got) == 3
    for w, g in zip(want, got):
        if family in EXACT:
            for name, a, b in zip(w._fields, w, g):
                assert np.array_equal(np.asarray(a), b), name
        else:
            _close_stats(jw.characterize(w), pw.characterize(g))


# ---------------------------------------------------------------------------
# the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device to generate on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("family", pw.FAMILIES)
def test_cuda_streams_match_cpu(cuda_device, family):
    """Pre-assembly streams on the card against the CPU route, to (c)'s
    bound; prints the card's mismatch fractions."""
    spec = pw.preset(family, seed=3, **FAMILY_SHAPES["n5242"])
    cpu = [x.numpy() for x in pg.family_streams(spec, CPU)]
    card = [pd.host_array(x) for x in pg.family_streams(spec, cuda_device)]
    zipf, clock = _check_streams(family, cpu, card)
    print(f"{family} card vs cpu: zipf rank mismatch {zipf}, "
          f"clock mismatch {clock}")


@pytest.mark.cuda
def test_cuda_generate_many_matches_single(cuda_device):
    specs = [pw.preset(f, seed=s, **E2E) for f in pw.FAMILIES
             for s in (1, 2)]
    many = pw.generate_many(specs, device=cuda_device)
    for spec, tr in zip(specs, many):
        one = pw.generate(spec, device=cuda_device)
        for name, x, y in zip(one._fields, one, tr):
            assert torch.equal(x, y), (spec.family, spec.seed, name)


@pytest.mark.cuda
def test_cuda_generate_launch_count(cuda_device):
    """Reads the device launches of one generate (torch.profiler)."""
    spec = pw.preset("zipf_reuse", n_cores=8, n_channels=4, per_channel=6144,
                     seed=2)
    pw.generate(spec, device=cuda_device)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        pw.generate(spec, device=cuda_device)
        torch.cuda.synchronize()
    launches = sum(e.count for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    print(f"zipf_reuse 8 x 4 x 6144: {launches} device launches")
    assert launches > 0
