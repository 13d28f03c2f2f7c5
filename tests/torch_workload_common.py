"""Helpers shared by the port's workload tests (``test_torch_workload.py``,
``test_torch_xla_math.py`` and ``test_torch_workload_fig17.py``): the JAX
package's spec for a port spec, the generator's per-core keys, each
family's streams from both packages and the checks that hold them
equal."""
import functools

import jax
import jax.numpy as jnp
import numpy as np

from repro.core import workload as jw
from repro.core.workload import generators as jg
from repro_torch.core import dram as pd
from repro_torch.core import workload as pw
from repro_torch.core.workload import generators as pg

CPU = "cpu"
# (c)'s shapes: FAMILY_N per core, and fig 17's 8 cores x 4 x 6144
FAMILY_SHAPES = {"n5242": dict(n_cores=2, n_channels=2, per_channel=2457),
                 "fig17": dict(n_cores=8, n_channels=4, per_channel=6144)}


def _jspec(spec: pw.WorkloadSpec) -> jw.WorkloadSpec:
    """The JAX package's spec with the same contents."""
    cores = tuple(jw.CoreWorkload(**{
        f: getattr(c, f) for f in c.__dataclass_fields__}) for c in spec.cores)
    return jw.WorkloadSpec(family=spec.family, cores=cores,
                           n_channels=spec.n_channels,
                           per_channel=spec.per_channel, seed=spec.seed)


def _jax_core_keys(seed, n_cores):
    key = jax.random.PRNGKey(seed)
    return jax.vmap(lambda c: jax.random.fold_in(key, c))(
        jnp.arange(n_cores, dtype=jnp.int32))


@functools.lru_cache(maxsize=None)
def _family_pair(family, shape="n5242", seed=3):
    spec = pw.preset(family, seed=seed, **FAMILY_SHAPES[shape])
    n = pg.per_core_requests(spec.n_cores, spec.n_channels, spec.per_channel)
    jfn = jax.jit(jax.vmap(lambda k, p: jg._FAMILY_FNS[family](k, p, n)))
    want = [np.asarray(x) for x in jfn(_jax_core_keys(seed, spec.n_cores),
                                       _jspec(spec).params())]
    got = [x.numpy() for x in pg.family_streams(spec, CPU)]
    return want, got


def _check_streams(want, got):
    """(c)'s contract: every stream (clock, page, column, write flag)
    bitwise."""
    for name, a, b in zip(("t", "page", "col", "wr"), want, got):
        assert np.array_equal(a.view(np.int32) if a.dtype == np.float32
                              else a, b.view(np.int32)
                              if b.dtype == np.float32 else b), name


def _assert_trace_equal(want, got, what):
    for name, a, b in zip(want._fields, want, got):
        assert np.array_equal(np.asarray(a), pd.host_array(b)), (what, name)
