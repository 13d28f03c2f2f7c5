"""Checkpoint corruption / crash-consistency coverage of the port
(``repro_torch.checkpoint``, ``repro_torch.runtime``): the 22 cases of
``tests/test_faults.py`` on the port's modules, on the CPU.

The fault model: a kill can land between any two filesystem operations, and
storage can hand back truncated or garbled bytes.  The checkpoint layer's
contract under that model is (a) uncommitted state is invisible, (b) corrupt
committed state raises ``CheckpointError`` (never restores garbage, never an
``assert`` that ``python -O`` strips), and (c) ``restore_latest`` /
``restore_sim_state`` / ``resume_stream`` degrade to the previous committed
step.  ``StepRunner`` additionally restores durable state before retrying.

Where the JAX package validates a treedef, the port validates the stored
field paths (its message says "structure mismatch"); the port's abstract
``like`` is a nest of meta-device tensors.  ``seeded_plan`` draws the JAX
package's events for the same seed.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.runtime import faults as jfaults
from repro_torch import checkpoint as ckpt
from repro_torch.core import dram, streaming, workload
from repro_torch.core.timing import paper_config, shared_static, stack_params
from repro_torch.runtime import fault_tolerance as ft
from repro_torch.runtime import faults

CPU = "cpu"


def _state(x=1.0):
    return {"w": np.full((4, 3), x, np.float32), "step": np.int32(7)}


# ---------------------------------------------------------------------------
# restore_checkpoint validation: real exceptions, field paths + leaf meta

def test_restore_validates_treedef(tmp_path):
    d = str(tmp_path)
    ckpt.save_checkpoint(d, 1, _state())
    wrong_tree = {"w": np.zeros((4, 3), np.float32),
                  "renamed": np.int32(0)}
    with pytest.raises(ckpt.CheckpointError, match="structure mismatch"):
        ckpt.restore_checkpoint(d, 1, like=wrong_tree)


def test_restore_validates_leaf_shape_and_dtype(tmp_path):
    d = str(tmp_path)
    ckpt.save_checkpoint(d, 1, _state())
    bad_shape = {"w": np.zeros((2, 3), np.float32), "step": np.int32(0)}
    with pytest.raises(ckpt.CheckpointError, match="shape"):
        ckpt.restore_checkpoint(d, 1, like=bad_shape)
    bad_dtype = {"w": np.zeros((4, 3), np.float64), "step": np.int32(0)}
    with pytest.raises(ckpt.CheckpointError, match="dtype"):
        ckpt.restore_checkpoint(d, 1, like=bad_dtype)


def test_restore_raises_real_exception_not_assert(tmp_path):
    # every validation failure must be a CheckpointError (a RuntimeError),
    # never a bare `assert` stripped under python -O
    d = str(tmp_path)
    with pytest.raises(ckpt.CheckpointError):
        ckpt.restore_checkpoint(d, 1, like=_state())
    assert issubclass(ckpt.CheckpointError, RuntimeError)


def test_restore_accepts_abstract_like(tmp_path):
    """The port's abstract ``like``: meta-device tensors carry shape and
    dtype only; their leaves restore to the CPU."""
    d = str(tmp_path)
    ckpt.save_checkpoint(d, 2, _state(3.0))
    like = {"w": torch.empty((4, 3), dtype=torch.float32, device="meta"),
            "step": torch.empty((), dtype=torch.int32, device="meta")}
    got, _ = ckpt.restore_checkpoint(d, 2, like=like)
    assert got["w"].device.type == "cpu"
    assert torch.equal(got["w"], torch.full((4, 3), 3.0))
    assert got["step"].dtype == torch.int32 and int(got["step"]) == 7


# ---------------------------------------------------------------------------
# corruption matrix

def test_truncated_leaf_raises_and_latest_falls_back(tmp_path):
    d = str(tmp_path)
    ckpt.save_checkpoint(d, 1, _state(1.0))
    ckpt.save_checkpoint(d, 2, _state(2.0))
    faults.corrupt_checkpoint(d, mode="truncate_leaf")   # newest = step 2
    with pytest.raises(ckpt.CheckpointError, match="leaf_0"):
        ckpt.restore_checkpoint(d, 2, like=_state())
    state, step, _ = ckpt.restore_latest(d, like=_state())
    assert step == 1 and state["w"][0, 0] == 1.0


def test_deleted_leaf_falls_back(tmp_path):
    d = str(tmp_path)
    ckpt.save_checkpoint(d, 1, _state(1.0))
    ckpt.save_checkpoint(d, 2, _state(2.0))
    faults.corrupt_checkpoint(d, mode="delete_leaf")
    state, step, _ = ckpt.restore_latest(d, like=_state())
    assert step == 1


def test_garbage_manifest_falls_back(tmp_path):
    d = str(tmp_path)
    ckpt.save_checkpoint(d, 1, _state(1.0))
    ckpt.save_checkpoint(d, 2, _state(2.0))
    faults.corrupt_checkpoint(d, mode="garbage_manifest")
    with pytest.raises(ckpt.CheckpointError, match="manifest"):
        ckpt.restore_checkpoint(d, 2, like=_state())
    _, step, _ = ckpt.restore_latest(d, like=_state())
    assert step == 1


def test_missing_committed_is_invisible(tmp_path):
    d = str(tmp_path)
    ckpt.save_checkpoint(d, 1, _state(1.0))
    ckpt.save_checkpoint(d, 2, _state(2.0))
    faults.corrupt_checkpoint(d, mode="drop_committed")
    assert ckpt.latest_step(d) == 1
    assert ckpt.committed_steps(d) == [1]


def test_stale_tmp_dir_is_invisible(tmp_path):
    d = str(tmp_path)
    ckpt.save_checkpoint(d, 1, _state(1.0))
    os.makedirs(os.path.join(d, "step_9.tmp"))          # mid-write kill spill
    with open(os.path.join(d, "step_9.tmp", "COMMITTED"), "w") as f:
        f.write("ok")                                    # even "committed"
    os.makedirs(os.path.join(d, "step_junk"))            # unparsable name
    assert ckpt.latest_step(d) == 1


def test_mid_write_kill_leaves_previous_visible(tmp_path):
    # a kill between leaf writes and the COMMITTED marker: a partially
    # populated step dir without the marker
    d = str(tmp_path)
    ckpt.save_checkpoint(d, 1, _state(1.0))
    half = os.path.join(d, "step_2")
    os.makedirs(half)
    np.save(os.path.join(half, "leaf_0.npy"), np.zeros(3))
    assert ckpt.latest_step(d) == 1
    state, step, _ = ckpt.restore_latest(d, like=_state())
    assert step == 1


def test_restore_latest_exhausted_raises(tmp_path):
    d = str(tmp_path)
    ckpt.save_checkpoint(d, 1, _state(1.0))
    faults.corrupt_checkpoint(d, step=1, mode="truncate_leaf")
    with pytest.raises(ckpt.CheckpointError, match="failed validation"):
        ckpt.restore_latest(d, like=_state())


# ---------------------------------------------------------------------------
# sim-state fallback + resume_stream under corruption

def _small_cfg():
    return paper_config("figcache_fast", cache_rows=16)


def _small_trace():
    spec = workload.preset("zipf_reuse", n_cores=2, n_channels=1,
                           per_channel=192, seed=21)
    return dram.Trace(*[x[0] for x in workload.generate(spec, device=CPU)])


def _assert_counters_equal(ref, got):
    for name, a, b in zip(type(ref)._fields, ref, got):
        assert torch.equal(a, b), name


def test_restore_sim_state_skips_corrupt_latest(tmp_path):
    d = str(tmp_path)
    cfg = _small_cfg()
    state = dram.sim_init(cfg.static, device=CPU)
    ckpt.save_sim_state(d, 1, state)
    ckpt.save_sim_state(d, 2, state)
    faults.corrupt_checkpoint(d, mode="truncate_leaf")
    like = dram.sim_init(cfg.static, device=CPU)
    _, chunk = ckpt.restore_sim_state(d, like)
    assert chunk == 1


def test_resume_stream_falls_back_to_previous_committed(tmp_path):
    d = str(tmp_path)
    cfg = _small_cfg()
    tr = _small_trace()
    ref = streaming.simulate_stream(streaming.iter_chunks(tr, 64), cfg,
                                    device=CPU)
    streaming.simulate_stream(streaming.iter_chunks(tr, 64), cfg,
                              checkpoint_dir=d, checkpoint_every=1,
                              device=CPU)
    faults.corrupt_checkpoint(d, mode="truncate_leaf")   # newest snapshot
    got = streaming.resume_stream(streaming.iter_chunks(tr, 64), cfg, d,
                                  device=CPU)
    _assert_counters_equal(ref, got)


def test_sweep_stream_checkpoints_and_resumes(tmp_path):
    d = str(tmp_path)
    cfgs = [paper_config("figcache_fast", cache_rows=cr) for cr in (16, 32)]
    static = shared_static(cfgs)
    batch = stack_params([c.params(device=CPU) for c in cfgs])
    tr = _small_trace()
    ref = streaming.sweep_stream(streaming.iter_chunks(tr, 64), static,
                                 batch, device=CPU)
    streaming.sweep_stream(streaming.iter_chunks(tr, 64), static, batch,
                           checkpoint_dir=d, checkpoint_every=1, device=CPU)
    like = dram.sim_init(static, batch=2, device=CPU)
    state, chunk = ckpt.restore_sim_state(d, like)
    got = streaming.sweep_stream(streaming.iter_chunks(tr, 64), static,
                                 batch, state=state, start_chunk=chunk,
                                 device=CPU)
    _assert_counters_equal(ref, got)


# ---------------------------------------------------------------------------
# StepRunner: restore-before-retry + exponential backoff

def test_step_runner_restores_committed_state_before_retry(tmp_path):
    d = str(tmp_path)
    cp = ckpt.AsyncCheckpointer(d)
    ckpt.save_checkpoint(d, 5, {"x": np.float32(10.0)})  # durable truth
    calls = []

    def step_fn(state, batch):
        calls.append(float(state["x"]))
        if len(calls) == 1:
            raise RuntimeError("flaky")
        return {"x": state["x"] + np.float32(1.0)}, {}

    slept = []
    runner = ft.StepRunner(step_fn, checkpointer=cp, max_retries=2,
                           backoff_s=0.1, sleep=slept.append)
    state, _ = runner.run(6, {"x": np.float32(99.0)}, batch=None)
    # the first attempt saw the stale in-memory 99; the retry must run from
    # the restored checkpoint value, not re-run the stale state
    assert calls == [99.0, 10.0]
    assert float(state["x"]) == 11.0
    assert runner.restores == 1
    assert slept == [0.1]


def test_step_runner_exponential_backoff(tmp_path):
    def step_fn(state, batch):
        raise RuntimeError("always")

    slept = []
    runner = ft.StepRunner(step_fn, max_retries=2, backoff_s=0.05,
                           sleep=slept.append)
    with pytest.raises(RuntimeError):
        runner.run(1, {"x": np.float32(0.0)}, batch=None)
    assert slept == [0.05, 0.1]
    assert runner.failures == 3


def test_step_runner_without_checkpointer_keeps_state(tmp_path):
    calls = []

    def step_fn(state, batch):
        calls.append(state)
        if len(calls) == 1:
            raise RuntimeError("flaky")
        return state + 1, {}

    runner = ft.StepRunner(step_fn, max_retries=1, backoff_s=0.0)
    state, _ = runner.run(1, 0, batch=None)
    assert state == 1 and runner.restores == 0


def test_heartbeat_add_worker():
    clock = faults.LogicalClock()
    mon = ft.HeartbeatMonitor(["a"], now=clock.now)
    mon.add_worker("b")
    mon.beat("b", 1.0)
    assert "b" in mon.alive_workers()
    mon.add_worker("b")                      # idempotent
    assert mon.health["b"].ema == 1.0


# ---------------------------------------------------------------------------
# fault-plan determinism

def test_seeded_plan_is_deterministic():
    a = faults.seeded_plan(42, n_shards=5, n_segments=7)
    b = faults.seeded_plan(42, n_shards=5, n_segments=7)
    assert [vars(x) for x in a.events] == [vars(y) for y in b.events]
    c = faults.seeded_plan(43, n_shards=5, n_segments=7)
    assert [vars(x) for x in a.events] != [vars(z) for z in c.events]
    # the JAX package's plan for the same seed, event for event
    for seed in (42, 43):
        want = jfaults.seeded_plan(seed, n_shards=5, n_segments=7,
                                   kinds=("kill", "transient", "slow",
                                          "corrupt"), n_events=6)
        got = faults.seeded_plan(seed, n_shards=5, n_segments=7,
                                 kinds=("kill", "transient", "slow",
                                        "corrupt"), n_events=6)
        assert [dataclasses.asdict(x) for x in want.events] == \
            [dataclasses.asdict(y) for y in got.events]
        assert jfaults.describe_plan(want) == faults.describe_plan(got)


def test_logical_clock_no_wall_time():
    clock = faults.LogicalClock(start=0.0, tick=1.0)
    assert clock.now() == 1.0 and clock.now() == 2.0
    clock.sleep(5.0)
    assert clock.t == 7.0 and clock.slept == [5.0]


def test_injected_kill_escapes_except_exception():
    try:
        try:
            raise faults.InjectedKill("preempted")
        except Exception:            # a retry loop must NOT swallow a kill
            pytest.fail("InjectedKill was caught as Exception")
    except faults.InjectedKill:
        pass


def test_fault_plan_consumes_times():
    plan = faults.FaultPlan([faults.FaultEvent(kind="transient", shard=0,
                                               segment=1)])
    with pytest.raises(faults.InjectedTransient):
        plan.before_segment(0, 1)
    assert plan.before_segment(0, 1) == 1.0      # times=1: consumed
    assert plan.log == [("transient", 0, 1)]
