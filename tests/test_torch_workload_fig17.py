"""The workload engine at fig 17's scale (8 cores x 4 channels x 6144
requests, ``benchmarks/common.py:scenario_specs``) against the JAX
package's, on the CPU, bitwise: each family's streams before assembly,
whole traces of every family, and fig 17's speedups from
``sweep_traces`` of both packages.  The same checks at small shapes are
in ``test_torch_workload.py``."""
import pytest

torch = pytest.importorskip("torch")

from repro.core import workload as jw
from repro_torch.core import simulator as ps
from repro_torch.core import workload as pw
from torch_workload_common import (CPU, _assert_trace_equal, _check_streams,
                                   _family_pair, _jspec)

FIG17 = dict(n_cores=8, n_channels=4, per_channel=6144)
FIG17_MECHS = ("base", "lisa_villa", "figcache_fast", "figcache_ideal",
               "lldram")


@pytest.mark.parametrize("shape", ["fig17"])
@pytest.mark.parametrize("family", jw.FAMILIES)
def test_family_streams_match_jax(family, shape):
    want, got = _family_pair(family, shape)
    _check_streams(want, got)


@pytest.mark.parametrize("family", jw.FAMILIES)
def test_generate_matches_jax_fig17_scale(family):
    """Fig 17's traces (``benchmarks/common.py:scenario_specs``), every
    leaf."""
    spec = pw.preset(family, seed=2, **FIG17)
    _assert_trace_equal(jw.generate(_jspec(spec)),
                        pw.generate(spec, device=CPU), family)


def test_fig17_speedups_match_jax():
    """Fig 17's printed numbers, from ``sweep_traces`` of both packages on
    the same specs (8 x 4 x 1024, seed 2) and mechanisms: equal floats."""
    from repro.core import simulator as jsim
    specs = [pw.preset(f, seed=2, **{**FIG17, "per_channel": 1024})
             for f in jw.FAMILIES]
    want = jsim.sweep_traces([_jspec(s) for s in specs],
                             jsim.mech_grid(FIG17_MECHS, None))
    got = ps.sweep_traces(specs, ps.mech_grid(FIG17_MECHS, None),
                          device=CPU)
    for fam, w, g in zip(jw.FAMILIES, want, got):
        a = jsim.speedup_summary(dict(zip(FIG17_MECHS, w)))
        b = ps.speedup_summary(dict(zip(FIG17_MECHS, g)))
        print(fam, b)
        assert a == b, (fam, a, b)
