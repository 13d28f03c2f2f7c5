"""Fault tolerance & elasticity for 1000+-node operation, PyTorch port of
``repro.runtime.fault_tolerance`` (plain Python; ``StepRunner`` restores
through ``repro_torch.checkpoint``).

Three cooperating pieces (all host-side control plane — the data plane stays
on the device):

* ``HeartbeatMonitor`` — per-worker heartbeats with deadline-based straggler
  and failure detection (deadline = p50 * straggler_factor, EMA-tracked).
  Stragglers get flagged for re-issue; dead workers trigger an elastic event.

* ``ElasticPlanner`` — given the surviving device set, re-plans the mesh:
  drops whole pods first (cleanest re-shard: the "pod" axis is pure DP, so
  losing a pod halves batch but changes no parameter sharding), then shrinks
  the data axis to the largest power-of-two that fits.  Emits a remap plan
  {new_mesh_shape, batch_scale, needs_reshard}.

* ``StepRunner`` — wraps the train step with (1) watchdog timing feeding the
  monitor, (2) checkpoint-on-failure, (3) automatic restore on an elastic
  event.  Recovery = restore latest COMMITTED checkpoint into the new
  mesh's shardings (checkpoints are host-gathered, so any mesh can load any
  checkpoint).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional


@dataclasses.dataclass
class WorkerHealth:
    last_beat: float
    step_times: List[float] = dataclasses.field(default_factory=list)
    ema: float = 0.0
    alive: bool = True


class HeartbeatMonitor:
    def __init__(self, workers: List[str], *, straggler_factor: float = 2.0,
                 dead_after_s: float = 60.0, now: Callable[[], float] = time.monotonic):
        self.now = now
        self.straggler_factor = straggler_factor
        self.dead_after_s = dead_after_s
        self.health: Dict[str, WorkerHealth] = {
            w: WorkerHealth(last_beat=now()) for w in workers}

    def beat(self, worker: str, step_time: Optional[float] = None):
        h = self.health[worker]
        h.last_beat = self.now()
        if step_time is not None:
            h.ema = step_time if h.ema == 0 else 0.9 * h.ema + 0.1 * step_time
            h.step_times.append(step_time)

    def fleet_p50(self) -> float:
        emas = sorted(h.ema for h in self.health.values() if h.ema > 0)
        return emas[len(emas) // 2] if emas else 0.0

    def stragglers(self) -> List[str]:
        p50 = self.fleet_p50()
        if p50 == 0:
            return []
        return [w for w, h in self.health.items()
                if h.alive and h.ema > self.straggler_factor * p50]

    def dead(self) -> List[str]:
        t = self.now()
        out = []
        for w, h in self.health.items():
            if h.alive and t - h.last_beat > self.dead_after_s:
                h.alive = False
                out.append(w)
        return out

    def alive_workers(self) -> List[str]:
        return [w for w, h in self.health.items() if h.alive]

    def add_worker(self, worker: str):
        """Register a worker spun up after construction (straggler re-issue
        spawns a fresh logical worker per attempt)."""
        if worker not in self.health:
            self.health[worker] = WorkerHealth(last_beat=self.now())


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    mesh_shape: tuple
    axis_names: tuple
    batch_scale: float           # new_global_batch / old_global_batch
    dropped_pods: int
    needs_reshard: bool


class ElasticPlanner:
    """Re-plan the (pod, data, model) mesh after failures.

    Policy: never shrink the model axis (that would re-shard every weight);
    drop pods first, then halve the data axis.  Survivors outside the chosen
    sub-mesh become hot spares.
    """

    def __init__(self, pods: int, data: int, model: int):
        self.shape = (pods, data, model)

    def plan(self, lost_devices_per_pod: Dict[int, int]) -> ElasticPlan:
        pods, data, model = self.shape
        dead_pods = {p for p, n in lost_devices_per_pod.items() if n > 0}
        new_pods = pods - len(dead_pods)
        if new_pods >= 1:
            scale = new_pods / pods
            return ElasticPlan(
                mesh_shape=(new_pods, data, model) if new_pods > 1
                else (data, model),
                axis_names=("pod", "data", "model") if new_pods > 1
                else ("data", "model"),
                batch_scale=scale, dropped_pods=len(dead_pods),
                needs_reshard=False)   # pod axis is pure DP
        # all pods degraded: shrink data axis to largest power of two
        new_data = data
        while new_data > 1:
            new_data //= 2
            if new_data * model <= data * model - max(
                    lost_devices_per_pod.values()):
                break
        return ElasticPlan(mesh_shape=(new_data, model),
                           axis_names=("data", "model"),
                           batch_scale=new_data / data, dropped_pods=pods - 1,
                           needs_reshard=True)


class StepRunner:
    """Retry/checkpoint wrapper around a step function.

    On failure the runner restores the latest COMMITTED checkpoint (when a
    checkpointer is configured) so the retry re-runs from durable state
    instead of a possibly-poisoned in-memory carry, and backs off
    exponentially (``backoff_s * 2**attempt``) between attempts.  ``sleep``
    is injectable so fault-injection tests stay wall-clock free.
    """

    def __init__(self, step_fn, *, checkpointer=None, monitor=None,
                 worker: str = "w0", max_retries: int = 2,
                 ckpt_every: int = 100, backoff_s: float = 0.05,
                 sleep: Callable[[float], None] = time.sleep):
        self.step_fn = step_fn
        self.ckpt = checkpointer
        self.monitor = monitor
        self.worker = worker
        self.max_retries = max_retries
        self.ckpt_every = ckpt_every
        self.backoff_s = backoff_s
        self.sleep = sleep
        self.failures = 0
        self.restores = 0

    def _restore_latest(self, state):
        """Latest COMMITTED checkpoint, or the in-memory state when none
        exists (or the checkpoint dir is unreadable)."""
        if self.ckpt is None:
            return state
        from repro_torch import checkpoint as ckpt_mod
        try:
            self.ckpt.wait()
        except Exception:
            pass                      # a failed async write is not fatal here
        step = ckpt_mod.latest_step(self.ckpt.path)
        if step is None:
            return state
        try:
            restored, _ = ckpt_mod.restore_checkpoint(
                self.ckpt.path, step, like=state)
        except ckpt_mod.CheckpointError:
            return state
        self.restores += 1
        return restored

    def run(self, step: int, state, batch, extra=None):
        for attempt in range(self.max_retries + 1):
            t0 = time.monotonic()
            try:
                state, metrics = self.step_fn(state, batch)
                dt = time.monotonic() - t0
                if self.monitor is not None:
                    self.monitor.beat(self.worker, dt)
                if self.ckpt is not None and step % self.ckpt_every == 0 \
                        and step > 0:
                    self.ckpt.save(step, state, extra)
                return state, metrics
            except Exception:
                self.failures += 1
                if attempt == self.max_retries:
                    raise
                if self.backoff_s:
                    self.sleep(self.backoff_s * (2 ** attempt))
                state = self._restore_latest(state)
        raise RuntimeError("unreachable")
