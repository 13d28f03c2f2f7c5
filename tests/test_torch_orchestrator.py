"""The port's sharded sweep orchestrator (``repro_torch.launch.orchestrator``)
on the CPU: the 14 resume-equivalence cases of ``tests/test_orchestrator.py``
on ``ci_grid(chunk_len=128)`` with ``devices=["cpu"]`` (the dropped-device
case with two), held against the port's ``sweep_traces``, and the same
faulted run through both packages' orchestrators.

The fault matrix: kill at segment k in {first, interior, last}, corrupt the
latest checkpoint, drop a mesh device, straggler re-issue, transient retry.
A killed-and-resumed sweep produces counters BITWISE identical to the
uninterrupted run, and a poisoned config is quarantined while the rest of
the grid completes.  All faults are deterministic (``runtime/faults.py``:
seeded schedules, logical clock, injectable sleep).

Against the JAX package: one module fixture runs ``repro``'s own
``Orchestrator`` on ``ci_grid(128)`` under ``tests/test_obs.py``'s fault
plan (transient x3, kill + resume, straggler) with a ``Tracer`` on the
plan's clock, then the port does the same.  Counters (the port's unlaned
to the JAX layout), the grid hash, every shard key, ``manifest.json``
(events included) and the span log's bytes are equal; no field is masked.

``cuda`` cases hold the card's orchestrated grid and a kill + resume there
against the CPU's, bitwise.
"""
import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import checkpoint as ckpt
from repro_torch.core import dram, simulator, workload
from repro_torch.core.timing import paper_config, shared_static, stack_params
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import orchestrator as orch_mod
from repro_torch.obs.trace import Tracer
from repro_torch.runtime.faults import FaultEvent, FaultPlan, InjectedKill

CHUNK = 128
CPU = ["cpu"]
ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The eager loop runs thousands of tiny ops; with several test workers
    on one host, torch's intra-op threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def plan():
    return orch_mod.ci_grid(chunk_len=CHUNK)


def _orch(plan, run_dir, devices=CPU, **kw):
    return orch_mod.Orchestrator(plan, str(run_dir), devices=devices,
                                 **{"backoff_s": 0.0, **kw})


@pytest.fixture(scope="module")
def oracle(plan, tmp_path_factory):
    """Uninterrupted orchestrated run, itself pinned against the monolithic
    ``sweep_traces`` in the first test below."""
    o = _orch(plan, tmp_path_factory.mktemp("oracle"))
    assert o.run() == {"done": len(plan.shards)}
    return o.counters_by_config()


def assert_counters_equal(got, exp, missing_ok=()):
    exp = {k: v for k, v in exp.items() if k not in missing_ok}
    assert set(got) == set(exp), (sorted(got), sorted(exp))
    for k, cnt in got.items():
        for name, a, b in zip(type(cnt)._fields, cnt, exp[k]):
            assert np.array_equal(np.asarray(a), np.asarray(b)), (k, name)


# ---------------------------------------------------------------------------
# the ports of tests/test_orchestrator.py

def test_uninterrupted_matches_sweep_traces_oracle(plan, oracle):
    ref = simulator.sweep_traces(plan.specs, plan.cfgs, chunk_len=CHUNK,
                                 device="cpu")
    assert len(oracle) == len(plan.specs) * len(plan.cfgs)
    for (w, i), cnt in oracle.items():
        for name, a, b in zip(type(cnt)._fields, cnt, ref[w][i].counters):
            assert np.array_equal(a, b), (w, i, name)


@pytest.mark.parametrize("segment", [0, 1, 2],
                         ids=["first", "interior", "last"])
def test_kill_and_resume_bitwise(plan, oracle, tmp_path, segment):
    fp = FaultPlan([FaultEvent(kind="kill", shard=1, segment=segment,
                               mode="raise")])
    with pytest.raises(InjectedKill):
        _orch(plan, tmp_path, fault_plan=fp).run()
    assert ("kill", 1, segment) in fp.log
    # resume in a "new process": a fresh Orchestrator over the same run_dir
    o2 = _orch(plan, tmp_path, fault_plan=fp)
    assert o2.run() == {"done": len(plan.shards)}
    assert_counters_equal(o2.counters_by_config(), oracle)


def test_corrupt_latest_checkpoint_falls_back(plan, oracle, tmp_path):
    fp = FaultPlan([FaultEvent(kind="corrupt", shard=1, segment=1,
                               corrupt_mode="truncate_leaf"),
                    FaultEvent(kind="kill", shard=1, segment=2,
                               mode="raise")])
    with pytest.raises(InjectedKill):
        _orch(plan, tmp_path, fault_plan=fp).run()
    o2 = _orch(plan, tmp_path, fault_plan=fp)
    o2.run()
    assert_counters_equal(o2.counters_by_config(), oracle)


def test_drop_mesh_device_replans_and_matches(plan, oracle, tmp_path):
    fp = FaultPlan([FaultEvent(kind="device_loss", shard=2, segment=1)])
    o = _orch(plan, tmp_path, devices=["cpu", "cpu"], fault_plan=fp)
    assert o._mesh_for(2, 2).devices.size == 2
    assert o.run() == {"done": len(plan.shards)}
    assert ("device_loss", 2, 1) in fp.log
    assert o._lost_devices == 1
    assert o._mesh_for(2, 2).devices.shape == (1, 1)
    assert_counters_equal(o.counters_by_config(), oracle)


def test_transient_retries_with_deterministic_backoff(plan, oracle, tmp_path):
    fp = FaultPlan([FaultEvent(kind="transient", shard=0, segment=1)])
    o = _orch(plan, tmp_path, fault_plan=fp, backoff_s=0.05)
    assert o.run() == {"done": len(plan.shards)}
    assert fp.clock.slept == [0.05]          # logical clock, not wall time
    assert o.manifest["shards"][plan.shards[0].key]["attempts"] == 2
    assert_counters_equal(o.counters_by_config(), oracle)


def test_retry_exhaustion_quarantines_shard_only(plan, oracle, tmp_path):
    fp = FaultPlan([FaultEvent(kind="transient", shard=0, times=-1)])
    o = _orch(plan, tmp_path, fault_plan=fp, max_retries=2)
    assert o.run() == {"done": len(plan.shards) - 1, "quarantined": 1}
    dead = {(plan.shards[0].w, i) for i in plan.shards[0].cfg_idxs}
    assert set(o.quarantined()) == dead
    assert_counters_equal(o.counters_by_config(), oracle, missing_ok=dead)


def test_straggler_reissued_under_fresh_worker(plan, oracle, tmp_path):
    # a slow-worker fault on a late shard (the fleet p50 needs earlier
    # healthy beats); the EMA deadline trips on the first slow beat and the
    # shard re-issues from its checkpoint under a new logical worker
    fp = FaultPlan([FaultEvent(kind="slow", shard=4, segment=0, factor=8.0)])
    o = _orch(plan, tmp_path, fault_plan=fp)
    assert o.run() == {"done": len(plan.shards)}
    key = plan.shards[4].key
    assert o.manifest["shards"][key]["reissues"] == 1
    assert f"{key}#r1" in o.monitor.health
    assert_counters_equal(o.counters_by_config(), oracle)


def test_poisoned_config_quarantined_grid_completes(plan, oracle, tmp_path):
    fp = FaultPlan([FaultEvent(kind="poison", shard=1, cfg_pos=0, times=-1)])
    o = _orch(plan, tmp_path, fault_plan=fp)
    assert o.run() == {"done": len(plan.shards)}
    # shard 1 = workload 0, cfg positions (1, 2); pos 0 -> global cfg 1
    poisoned = (plan.shards[1].w, plan.shards[1].cfg_idxs[0])
    q = o.quarantined()
    assert poisoned in q and "negative" in q[poisoned]
    assert_counters_equal(o.counters_by_config(), oracle,
                          missing_ok={poisoned})
    res = o.results()
    assert res[poisoned[0]][poisoned[1]] is None
    healthy = [(w, i) for w in range(len(plan.specs))
               for i in range(len(plan.cfgs)) if (w, i) != poisoned]
    assert all(res[w][i] is not None for w, i in healthy)


def test_resume_skips_done_shards(plan, tmp_path):
    o = _orch(plan, tmp_path)
    o.run()
    attempts = {k: e["attempts"] for k, e in o.manifest["shards"].items()}
    o2 = _orch(plan, tmp_path)
    o2.run()
    assert {k: e["attempts"] for k, e in o2.manifest["shards"].items()} \
        == attempts


def test_manifest_reconcile_repairs_half_states(plan, tmp_path):
    o = _orch(plan, tmp_path)
    o.run()
    key0, key1 = plan.shards[0].key, plan.shards[1].key
    # (a) status says running but the result is committed -> done
    o.manifest["shards"][key0]["status"] = "running"
    # (b) status says done but the result dir vanished -> pending
    shutil.rmtree(o._result_dir(key1))
    orch_mod.write_manifest(o.manifest_path, o.manifest)
    o2 = _orch(plan, tmp_path)
    assert o2.manifest["shards"][key0]["status"] == "done"
    assert o2.manifest["shards"][key1]["status"] == "pending"
    o2.run()
    assert o2.status() == {"done": len(plan.shards)}


def test_shard_keys_content_stable(plan):
    again = orch_mod.ci_grid(chunk_len=CHUNK)
    assert [s.key for s in again.shards] == [s.key for s in plan.shards]
    assert again.grid_hash == plan.grid_hash
    other = orch_mod.ci_grid(chunk_len=64)       # chunking is part of the key
    assert other.grid_hash != plan.grid_hash


def test_mismatched_grid_refused(plan, tmp_path):
    _orch(plan, tmp_path)
    other = orch_mod.make_plan(
        [workload.preset("zipf_reuse", n_cores=2, n_channels=2,
                         per_channel=384, seed=99)],
        [paper_config("base")], chunk_len=CHUNK)
    with pytest.raises(ValueError, match="different grid"):
        _orch(other, tmp_path)


def test_make_plan_rejects_raw_traces():
    with pytest.raises(TypeError, match="WorkloadSpec"):
        orch_mod.make_plan([np.zeros(4)], [paper_config("base")])


def test_shard_groups_match_simulator_dispatch(plan):
    # shards are exactly the simulator's replay units: same grouping
    groups = simulator.static_groups(plan.cfgs)
    per_workload = sorted(idxs for (_s, _sc), idxs in groups.items())
    for w in range(len(plan.specs)):
        got = sorted(list(s.cfg_idxs) for s in plan.shards if s.w == w)
        assert got == per_workload


# ---------------------------------------------------------------------------
# the port's own pieces: the mesh, the untouched input state, the CLI

def test_sweep_mesh_divides_extents():
    """``best_divisor``'s placement: the params axis takes what divides P,
    the channel axis what divides C of the rest, devices in order."""
    devs = [torch.device("cpu")] * 8
    for (P, C), shape in {(2, 2): (2, 2), (1, 2): (1, 2), (3, 4): (3, 2),
                          (5, 3): (5, 1), (2, 8): (2, 4), (1, 1): (1, 1),
                          (7, 7): (7, 1)}.items():
        m = mesh_mod.make_sweep_mesh(P, C, devices=devs)
        assert m.devices.shape == shape, (P, C)
        assert mesh_mod.mesh_axes(m) == {"params": shape[0],
                                         "channel": shape[1]}
    m = mesh_mod.make_sweep_mesh(4, 4, devices=["cpu", "meta"])
    assert [d.type for d in m.devices.ravel()] == ["cpu", "meta"]


def test_mesh_step_blocks_match_one_replay(plan):
    """A (2, 2) block split over four devices equals the (1, 1) replay on
    every lane, and neither touches the input progress."""
    shard = plan.shards[1]
    cfgs = [plan.cfgs[i] for i in shard.cfg_idxs]
    static = shared_static(cfgs)
    batch = stack_params([c.params(device="cpu") for c in cfgs])
    tr = workload.generate(plan.specs[shard.w], device="cpu")
    seg = dram.Trace(*[x[:, :CHUNK] for x in tr])
    prog = orch_mod.init_progress(static, 2, 2, device="cpu")
    prog = orch_mod.shard_step(seg, static, batch, prog, device="cpu")
    before = [x.clone() for x in dram.finalize(prog.sim)]
    seg2 = dram.Trace(*[x[:, CHUNK:2 * CHUNK] for x in tr])
    one = orch_mod.mesh_step(mesh_mod.make_sweep_mesh(2, 2, ["cpu"]), seg2,
                             static, batch, prog)
    four = orch_mod.mesh_step(mesh_mod.make_sweep_mesh(2, 2, ["cpu"] * 4),
                              seg2, static, batch, prog)
    assert four.sim.cnt.reads.shape[0] == 4
    for a, b in zip(dram.finalize(one.sim), dram.finalize(four.sim)):
        assert torch.equal(a, b)
    for a, b in zip(before, dram.finalize(prog.sim)):
        assert torch.equal(a, b)
    assert int(one.seg_done) == int(four.seg_done) == 2
    assert int(one.reqs_done) == int(four.reqs_done) == \
        int((tr.t_issue[:, :2 * CHUNK] < dram.NOOP_ISSUE).sum())


def test_progress_checkpoint_round_trips_lane_layout(plan, tmp_path):
    """``restore_latest(..., kind="shard_prog")`` gives back the lane-layout
    carry and both 0-d int32 accumulators, bytes and dtypes; a state
    without telemetry keeps its field paths."""
    static = shared_static([plan.cfgs[1], plan.cfgs[2]])
    prog = orch_mod.init_progress(static, 2, 2, device="cpu")
    prog = prog._replace(seg_done=prog.seg_done + 3,
                         reqs_done=prog.reqs_done + 77)
    ckpt.save_checkpoint(str(tmp_path), 3, prog, {"kind": "shard_prog"})
    like = orch_mod.init_progress(static, 2, 2, device="cpu")
    got, step, _ = ckpt.restore_latest(str(tmp_path), like,
                                       kind="shard_prog")
    assert step == 3 and got.sim.tel is None
    assert got.seg_done.dtype == got.reqs_done.dtype == torch.int32
    assert got.seg_done.shape == () and int(got.reqs_done) == 77
    leaves = lambda tree: [x for _, x in ckpt.checkpoint._flatten(tree)]
    assert len(leaves(got)) == len(leaves(prog))
    for a, b in zip(leaves(prog), leaves(got)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _cli(*args, cwd):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.orchestrator", *args],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_cli_sigkill_resume_compare(tmp_path):
    """The CLI's kill-and-resume harness on the CPU: a real SIGKILL at
    shard 1 segment 1, a resume, and ``compare`` bitwise against
    ``sweep_traces``."""
    d = str(tmp_path / "run")
    trace = str(tmp_path / "span.jsonl")
    r = _cli("run", "--run-dir", d, "--device", "cpu", "--kill", "1:1",
             "--kill-mode", "sigkill", "--trace", trace, cwd=tmp_path)
    assert r.returncode == -9, r.stderr
    r = _cli("run", "--run-dir", d, "--device", "cpu", "--trace", trace,
             cwd=tmp_path)
    assert r.returncode == 0, r.stderr
    assert "'done': 6" in r.stdout
    assert os.path.exists(str(tmp_path / "span.chrome.json"))
    r = _cli("compare", "--run-dir", d, "--device", "cpu", cwd=tmp_path)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "bitwise equal" in r.stdout


# ---------------------------------------------------------------------------
# against the JAX package's orchestrator, under one fault plan

def _faulted_run(om, FaultEvent_, FaultPlan_, Kill, Tracer_, run_dir, **kw):
    """tests/test_obs.py's ``_traced_faulted_run`` through package ``om``."""
    run_dir.mkdir(parents=True, exist_ok=True)
    plan = om.ci_grid(chunk_len=CHUNK)
    fp = FaultPlan_([
        FaultEvent_(kind="transient", shard=0, times=3),
        FaultEvent_(kind="kill", shard=1, segment=1, mode="raise"),
        FaultEvent_(kind="slow", shard=4, segment=0, factor=8.0),
    ])
    log = run_dir / "span.jsonl"
    tracer = Tracer_(str(log), clock=fp.clock.now)
    o = om.Orchestrator(plan, str(run_dir), fault_plan=fp, backoff_s=0.05,
                        max_retries=3, tracer=tracer, **kw)
    with pytest.raises(Kill):
        o.run()
    o2 = om.Orchestrator(plan, str(run_dir), fault_plan=fp, backoff_s=0.05,
                         max_retries=3, tracer=tracer, **kw)
    assert o2.run() == {"done": len(plan.shards)}
    tracer.close()
    return dict(orch=o2, plan=plan, fault_plan=fp, log=log,
                manifest=json.loads((run_dir / "manifest.json").read_text()))


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    from repro.launch import orchestrator as jom
    from repro.obs.trace import Tracer as JTracer
    from repro.runtime import faults as jf
    d = tmp_path_factory.mktemp("both")
    jax_run = _faulted_run(jom, jf.FaultEvent, jf.FaultPlan, jf.InjectedKill,
                           JTracer, d / "jax")
    port_run = _faulted_run(orch_mod, FaultEvent, FaultPlan, InjectedKill,
                            Tracer, d / "port", devices=CPU)
    return jax_run, port_run


def test_jax_counters_by_config_bitwise(both):
    want, got = (r["orch"].counters_by_config() for r in both)
    assert set(want) == set(got) and len(got) == 10
    for k in want:
        for name, a, b in zip(type(got[k])._fields, want[k], got[k]):
            a = np.asarray(a)
            assert a.shape == b.shape and a.dtype == b.dtype, (k, name)
            assert np.array_equal(a, b), (k, name)


def test_jax_grid_hash_and_shard_keys(both):
    jp, pp = (r["plan"] for r in both)
    assert jp.grid_hash == pp.grid_hash
    assert [(s.key, s.w, s.cfg_idxs) for s in jp.shards] == \
        [(s.key, s.w, s.cfg_idxs) for s in pp.shards]


def test_jax_manifest_equal(both):
    want, got = (r["manifest"] for r in both)
    assert want == got
    assert any(e["events"] for e in got["shards"].values())


def test_jax_span_log_byte_identical(both):
    """The span log with no field masked: every record names shard keys,
    workers, attempts and logical timestamps only, all of which are the
    JAX package's."""
    want, got = (r["log"].read_bytes() for r in both)
    assert len(got) > 0 and want == got
    assert both[0]["fault_plan"].log == both[1]["fault_plan"].log
    assert both[0]["fault_plan"].clock.slept == \
        both[1]["fault_plan"].clock.slept == [0.05, 0.1, 0.2]


# ---------------------------------------------------------------------------
# the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device to orchestrate on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_orchestrated_grid_matches_cpu(cuda_device, plan, oracle,
                                            tmp_path):
    o = _orch(plan, tmp_path, devices=[cuda_device])
    assert o.run() == {"done": len(plan.shards)}
    assert_counters_equal(o.counters_by_config(), oracle)


@pytest.mark.cuda
def test_cuda_kill_and_resume_bitwise(cuda_device, plan, oracle, tmp_path):
    fp = FaultPlan([FaultEvent(kind="kill", shard=3, segment=1,
                               mode="raise")])
    with pytest.raises(InjectedKill):
        _orch(plan, tmp_path, devices=[cuda_device], fault_plan=fp).run()
    o2 = _orch(plan, tmp_path, devices=[cuda_device], fault_plan=fp)
    assert o2.run() == {"done": len(plan.shards)}
    assert_counters_equal(o2.counters_by_config(), oracle)
