"""The port's system simulator (``repro_torch.core.simulator``) against the
JAX package: the same numpy post-processing runs on bitwise-equal counters,
so every ``RunResult`` float and array must be exactly equal."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import simulator as js
from repro.core import timing as jt
from repro.core import traces as jtr
from repro_torch.core import simulator as ps
from repro_torch.core import timing as pt
from repro_torch.core import traces as ptr
from repro_torch.core import workload as pw

CPU = "cpu"


def _assert_result_equal(ref, got, ctx):
    assert ref.mechanism == got.mechanism, ctx
    for f in ("ipc", "avg_lat_ns"):
        a, b = getattr(ref, f), getattr(got, f)
        assert a.shape == b.shape and np.array_equal(a, b), (ctx, f)
    for f in ("row_hit_rate", "cache_hit_rate", "exec_time_ns",
              "dram_energy_nj", "system_energy_nj"):
        assert getattr(ref, f) == getattr(got, f), (ctx, f)
    assert ref.energy_parts == got.energy_parts, ctx
    for name, a, b in zip(got.counters._fields, ref.counters, got.counters):
        assert np.array_equal(np.asarray(a), b), (ctx, name)


def _assert_results_equal(ref: dict, got: dict, ctx):
    assert list(ref) == list(got)
    for m in ref:
        _assert_result_equal(ref[m], got[m], (ctx, m))
    assert js.speedup_summary(ref) == ps.speedup_summary(got)


def test_run_eight_core_matches_jax():
    ref = js.run_eight_core(jtr.eight_core_workloads()[17], per_channel=512)
    got = ps.run_eight_core(ptr.eight_core_workloads()[17], per_channel=512,
                            device=CPU)
    _assert_results_equal(ref, got, "wl17")


def test_run_single_core_matches_jax():
    ref = js.run_single_core("libquantum", n_reqs=1024)
    got = ps.run_single_core("libquantum", n_reqs=1024, device=CPU)
    _assert_results_equal(ref, got, "libquantum")


def test_run_eight_core_batch_with_kernel_path_matches_jax():
    """The stacked-workload path chip_smoke.py drives on the card, small:
    two workloads, the fused lookup op on, ragged no-op padding unused."""
    mechs = ("base", "figcache_fast", "lisa_villa")
    over = {"fts_kernel": True}
    jw, pw = jtr.eight_core_workloads(), ptr.eight_core_workloads()
    ref = js.run_eight_core_batch([jw[0], jw[15]], mechanisms=mechs,
                                  per_channel=256, cfg_overrides=over)
    got = ps.run_eight_core_batch([pw[0], pw[15]], mechanisms=mechs,
                                  per_channel=256, cfg_overrides=over,
                                  device=CPU)
    for w, (r, g) in enumerate(zip(ref, got)):
        _assert_results_equal(r, g, ("batch", w))


def test_sweep_traces_ragged_single_channel():
    a = ptr.app_params("libquantum")
    trs = [ptr.build_trace([a], 1, n, s) for n, s in ((300, 1), (200, 2))]
    trs = [type(tr)(*[x[0] for x in tr]) for tr in trs]
    cfgs = [pt.paper_config("base"), pt.paper_config("figcache_fast")]
    res = ps.sweep_traces(trs, cfgs, [(a,)] * 2, device=CPU)
    for w, tr in enumerate(trs):
        one = ps.sweep(tr, cfgs, (a,), device=CPU)
        for i in range(len(cfgs)):
            _assert_result_equal(one[i], res[w][i], ("ragged", w, i))


def test_sweep_with_write_drain_matches_jax():
    """A write-drain controller (once refused by the port) schedules the
    trace on the host and replays it: RunResults equal to the JAX
    package's."""
    a_p, a_j = ptr.app_params("mcf"), jtr.app_params("mcf")
    tr = ptr.build_trace([a_p], 1, 64, 1)
    drain = dataclasses.replace(pt.paper_config("base"),
                                sched=pt.SchedConfig(write_drain=True))
    ref = js.sweep(type(tr)(*tr), [dataclasses.replace(
        jt.paper_config("base"), sched=jt.SchedConfig(write_drain=True))],
        (a_j,))
    got = ps.sweep(tr, [drain], (a_p,), device=CPU)
    _assert_result_equal(ref[0], got[0], "drain")


def test_sweep_chunk_len_matches_jax():
    """A streamed sweep (``chunk_len``, once refused by the port) equals
    the monolithic sweep and the JAX package's streamed sweep."""
    a_p, a_j = ptr.app_params("mcf"), jtr.app_params("mcf")
    tr = ptr.build_trace([a_p], 1, 64, 1)
    got = ps.sweep(tr, [pt.paper_config("base")], (a_p,), chunk_len=16,
                   device=CPU)
    ref = js.sweep(type(tr)(*tr), [jt.paper_config("base")], (a_j,),
                   chunk_len=16)
    _assert_result_equal(ref[0], got[0], "chunked")
    mono = ps.sweep(tr, [pt.paper_config("base")], (a_p,), device=CPU)
    _assert_result_equal(mono[0], got[0], "mono")


def test_unported_simulator_paths_raise():
    """Device-generated workloads, unported before, now run: a
    ``WorkloadSpec`` entry beside a numpy trace (its apps given as None)
    gives the results of passing its generated trace, and an entry that is
    neither a trace nor a spec still raises.  Telemetry windows, unported
    before, now run: a telemetry config's results equal the telemetry-off
    config's, monolithic and streamed."""
    a = ptr.app_params("mcf")
    tr = ptr.build_trace([a], 1, 64, 1)
    spec = pw.preset("embed", n_cores=1, n_channels=1, per_channel=64,
                     seed=2)
    cfgs = [pt.paper_config("base"), pt.paper_config("figcache_fast")]
    mixed = ps.sweep_traces([tr, spec], cfgs, [(a,), None], device=CPU)
    ref = ps.sweep_traces([tr, pw.generate(spec, device=CPU)], cfgs,
                          [(a,), spec.apps()], device=CPU)
    for w in range(2):
        for i in range(len(cfgs)):
            _assert_result_equal(ref[w][i], mixed[w][i], ("mixed", w, i))
    with pytest.raises(TypeError, match="WorkloadSpec"):
        ps.sweep_traces([tr, object()], [pt.paper_config("base")],
                        [(a,), (a,)], device=CPU)
    tel = pt.paper_config("base", telemetry=32)
    off = ps.sweep(tr, [pt.paper_config("base")], (a,), device=CPU)[0]
    _assert_result_equal(off, ps.sweep(tr, [tel], (a,), device=CPU)[0],
                         "telemetry")
    _assert_result_equal(off, ps.sweep(tr, [tel], (a,), chunk_len=16,
                                       device=CPU)[0], "telemetry chunked")
