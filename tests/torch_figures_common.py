"""The JAX package's side of the figure tests (``test_torch_figures_*.py``):
what each port figure's ``collect`` returns, made by ``repro.core`` and
``repro.obs`` on the same grids, sizes and seeds, and the checks that hold
the two equal.

The grids come from the port's figure modules (their ``configs`` and
constants, each config rebuilt as the JAX package's ``MechConfig``); the
workloads, trace lengths and seeds are stated here, as the benchmark
scripts of the JAX package state them."""
import dataclasses
import functools
import importlib

import numpy as np
import pytest
import torch

from repro.core import simulator as jsim
from repro.core import streaming as jstream
from repro.core import timing as jt
from repro.core import traces as jtr
from repro.core import workload as jw
from repro.obs.telemetry import WindowCollector as JCollector
from repro_torch.core import dram as pd
from repro_torch.core import timing as pt
from repro_torch.figures import (common, fig07_single_core, fig12_capacity,
                                 fig13_segment_size, fig14_replacement,
                                 fig15_insertion, fig16_scheduler,
                                 fig17_scenarios, fig_tail_latency)
from torch_workload_common import _jspec

CPU = "cpu"
SIZES = common.QUICK
# figure -> (its port module, the trace length of its sweep): figs 12, 14
# and 16 sweep the longer traces
SWEEPS = {"fig12_capacity": (fig12_capacity, "long_8core"),
          "fig13_segment_size": (fig13_segment_size, "reqs_8core"),
          "fig14_replacement": (fig14_replacement, "long_8core"),
          "fig15_insertion": (fig15_insertion, "reqs_8core"),
          "fig16_scheduler": (fig16_scheduler, "long_8core")}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The eager loops run thousands of tiny ops; with several test workers
    on one host, torch's intra-op threads only contend for the cores.
    (Autouse in every test module that imports it.)"""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_config(cfg: pt.MechConfig) -> jt.MechConfig:
    """The JAX package's ``MechConfig`` with the same fields."""
    kw = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if isinstance(v, pt.SchedConfig):
            v = jt.SchedConfig(**dataclasses.asdict(v))
        kw[f.name] = v
    return jt.MechConfig(**kw)


@functools.lru_cache(maxsize=None)
def _eight_trace(idx: int, per_channel: int):
    _, _, apps = jtr.eight_core_workloads()[idx]
    return jtr.build_trace(apps, 4, per_channel, common.SEED_8CORE), apps


@functools.lru_cache(maxsize=None)
def _scenario_trace(family: str, sizes=SIZES):
    return jw.generate(_jspec(common.scenario_specs(sizes)[family]))


@functools.lru_cache(maxsize=None)
def _eight_core_batch(sizes=SIZES):
    wls = [jtr.eight_core_workloads()[i] for i in common.ALL_WL]
    res = jsim.run_eight_core_batch(wls, per_channel=sizes.reqs_8core)
    return dict(zip(common.ALL_WL, res))


@functools.lru_cache(maxsize=None)
def collect(name: str, sizes=SIZES):
    """The JAX package's counterpart of ``<name>.collect(sizes=sizes)``."""
    if name == "fig03_footprint":
        cases = {"oracle": _eight_trace(common.WL_IDX[100][0],
                                        sizes.reqs_8core)[0]}
        for fam in common.scenario_specs(sizes):
            cases[fam] = _scenario_trace(fam, sizes)
        return {k: jw.characterize(tr) for k, tr in cases.items()}
    if name == "fig07_single_core":
        return jsim.run_single_core_batch(fig07_single_core.APPS,
                                          n_reqs=sizes.reqs_1core)
    if name in ("fig08_eight_core", "fig09_cache_hit", "fig10_row_hit",
                "fig11_energy"):
        return _eight_core_batch(sizes)
    if name in SWEEPS:
        mod, length = SWEEPS[name]
        cfgs = [jax_config(c) for c in mod.configs(sizes)]
        out = {}
        for i in (common.WL_IDX[50][0], common.WL_IDX[100][1]):
            tr, apps = _eight_trace(i, getattr(sizes, length))
            out[i] = jsim.sweep(tr, cfgs, apps)
        return out
    if name == "fig17_scenarios":
        specs = common.scenario_specs(sizes)
        res = jsim.sweep_traces([_jspec(s) for s in specs.values()],
                                jsim.mech_grid(fig17_scenarios.MECHS, None))
        return dict(zip(specs, res))
    if name == "fig_tail_latency":
        out = {}
        for fam in common.scenario_specs(sizes):
            tr = _scenario_trace(fam, sizes)
            out[fam] = {}
            for m in fig_tail_latency.MECHS:
                col = JCollector()
                jstream.simulate_stream(
                    jstream.iter_chunks(tr, fig_tail_latency.CHUNK),
                    jax_config(fig_tail_latency.config(m)), telemetry=col)
                out[fam][m] = col.cumulative()
        return out
    raise KeyError(name)


def assert_result_equal(ref, got, ctx):
    """Every field of a ``RunResult``, the counters bitwise."""
    assert ref.mechanism == got.mechanism, ctx
    for f in ("ipc", "avg_lat_ns"):
        a, b = getattr(ref, f), getattr(got, f)
        assert a.shape == b.shape and np.array_equal(a, b), (ctx, f)
    for f in ("row_hit_rate", "cache_hit_rate", "exec_time_ns",
              "dram_energy_nj", "system_energy_nj"):
        assert getattr(ref, f) == getattr(got, f), (ctx, f)
    assert ref.energy_parts == got.energy_parts, ctx
    assert ref.counters._fields == got.counters._fields, ctx
    for name, a, b in zip(got.counters._fields, ref.counters, got.counters):
        assert np.array_equal(np.asarray(a), pd.host_array(b)), (ctx, name)


def assert_collected_equal(ref, got, ctx=()):
    """Two ``collect`` outputs: nested dicts / lists of ``RunResult``s,
    profiles or cumulative planes, equal leaf by leaf."""
    if isinstance(ref, dict):
        assert list(ref) == list(got), ctx
        for k in ref:
            assert_collected_equal(ref[k], got[k], ctx + (k,))
    elif isinstance(ref, (list, tuple)):
        assert len(ref) == len(got), ctx
        for k, (a, b) in enumerate(zip(ref, got)):
            assert_collected_equal(a, b, ctx + (k,))
    elif isinstance(ref, jsim.RunResult):
        assert_result_equal(ref, got, ctx)
    else:
        a, b = np.asarray(ref), np.asarray(got)
        assert a.shape == b.shape and a.dtype == b.dtype, (ctx, a.dtype,
                                                          b.dtype)
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), ctx


def port_run(name: str, sizes=SIZES):
    """``<name>.run(device="cpu", sizes=sizes)`` with what its ``collect``
    returned and the replays it made (``dram.REPLAYS``):
    ``(collected, rows, summary, replays)``."""
    mod = importlib.import_module(f"repro_torch.figures.{name}")
    orig, box = mod.collect, {}

    def capturing(*a, **kw):
        box["collected"] = orig(*a, **kw)
        return box["collected"]

    mod.collect = capturing
    try:
        n0 = pd.REPLAYS.count
        rows, summary = mod.run(device=CPU, sizes=sizes)
        replays = pd.REPLAYS.count - n0
    finally:
        mod.collect = orig
    return box["collected"], rows, summary, replays


def assert_figure_matches_jax(name: str, got):
    """The port's ``collect`` output, rows and summary (``got``, from
    ``port_run``) against the JAX package's results on the same grid, the
    rows and summary by the port figure's ``summarize``: exactly equal."""
    mod = importlib.import_module(f"repro_torch.figures.{name}")
    collected, rows, summary, _ = got
    ref = collect(name)
    assert_collected_equal(ref, collected, (name,))
    want_rows, want_summary = mod.summarize(ref)
    assert summary == want_summary, name
    assert rows == want_rows, name
    assert summary, name


if __name__ == "__main__":
    # the JAX package's summaries at the full sizes, as chip_smoke.py pins
    # them (FIG_GOLD), from the repo's root:
    #   PYTHONPATH=src:tests JAX_PLATFORMS=cpu \
    #       python tests/torch_figures_common.py
    import json

    from repro_torch.figures import NAMES
    gold = {}
    for fig in NAMES:
        mod = importlib.import_module(f"repro_torch.figures.{fig}")
        gold[fig] = mod.summarize(collect(fig, common.FULL))[1]
    print(json.dumps(gold, indent=1))
