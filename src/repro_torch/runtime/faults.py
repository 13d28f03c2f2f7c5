"""Deterministic fault injection for the sweep orchestrator (DESIGN.md §14),
PyTorch port of ``repro.runtime.faults`` (plain Python, the same events,
draws and firing log).

A ``FaultPlan`` is a list of ``FaultEvent``s consulted at fixed points in the
orchestrator's shard loop — *before* each segment step and *after* each
checkpoint commit — plus a ``LogicalClock`` so heartbeat deadlines, backoff
delays and straggler detection advance without touching the wall clock.
Everything is seeded (``seeded_plan``) or hand-written; there is no
wall-clock randomness, so a plan replays identically across runs and the
resume-equivalence guarantee (interrupted sweep ≡ uninterrupted sweep,
bitwise) is testable.

Fault kinds:

``kill``         stop the process at (shard, segment): ``mode="raise"``
                 raises ``InjectedKill`` (a ``BaseException`` so retry loops
                 catching ``Exception`` cannot swallow it), ``mode="sigkill"``
                 delivers a real ``SIGKILL`` — the CI kill-and-resume step.
``transient``    raise ``InjectedTransient`` (retryable; consumed per firing).
``device_loss``  raise ``InjectedDeviceLoss`` — the orchestrator rebuilds its
                 mesh on the surviving devices and re-runs the shard.
``slow``         return a slowdown factor; the shard's heartbeat reports
                 ``factor ×`` the nominal step time, tripping the
                 ``HeartbeatMonitor`` straggler deadline and forcing re-issue.
``corrupt``      damage the shard's just-committed checkpoint
                 (``corrupt_checkpoint`` modes below) so resume must fall
                 back to the previous committed step.
``poison``       overwrite one config's counters with garbage after the
                 shard computes (models a pathological config): the
                 orchestrator must quarantine it, not fail the sweep.

Add-a-fault-plan recipe: construct ``FaultPlan([FaultEvent(...), ...])`` (or
``seeded_plan(seed, ...)``), hand it to ``Orchestrator(..., fault_plan=plan)``,
run, resume, and assert ``results()`` equals the no-fault run bitwise.
``plan.log`` records every firing as ``(kind, shard, segment)`` for
assertions about *what* was injected.
"""
from __future__ import annotations

import dataclasses
import json
import os
import random
import signal
from typing import Any, List, Optional, Sequence

from repro_torch.checkpoint import latest_step


class FaultError(Exception):
    """Base for injected retryable failures."""


class InjectedTransient(FaultError):
    """A once-off failure the retry loop should absorb."""


class InjectedDeviceLoss(FaultError):
    """A mesh device disappeared; the orchestrator must re-plan."""


class InjectedKill(BaseException):
    """Process death.  Deliberately NOT an ``Exception``: retry loops catch
    ``Exception``, and a kill must tear the whole run down exactly like a
    preemption would — only the test harness (or nothing, for SIGKILL)
    catches it."""


class LogicalClock:
    """Deterministic time source: ``now()`` advances by ``tick`` per read,
    ``sleep`` advances by the requested amount.  Injected as
    ``HeartbeatMonitor(now=...)`` and ``StepRunner(sleep=...)`` so fault
    tests never block on real time."""

    def __init__(self, start: float = 0.0, tick: float = 1.0):
        self.t = float(start)
        self.tick = float(tick)
        self.slept: List[float] = []

    def now(self) -> float:
        self.t += self.tick
        return self.t

    def sleep(self, dt: float):
        self.slept.append(float(dt))
        self.t += float(dt)


@dataclasses.dataclass
class FaultEvent:
    """One injection site.  ``shard`` is matched by equality against the
    reference the orchestrator passes (its shard index in plan order);
    ``None`` matches every shard.  ``segment=None`` matches every segment.
    ``times`` bounds firings (-1 = unlimited — ``poison`` wants this so a
    resumed run re-poisons the same config deterministically)."""
    kind: str                            # kill|transient|device_loss|slow|corrupt|poison
    shard: Any = None
    segment: Optional[int] = None
    times: int = 1
    factor: float = 4.0                  # slow: step-time multiplier
    cfg_pos: int = 0                     # poison: config position in shard
    mode: str = "raise"                  # kill delivery: raise|sigkill
    corrupt_mode: str = "truncate_leaf"
    fired: int = 0

    def _matches(self, kind: str, shard, segment) -> bool:
        if self.kind != kind or (self.times >= 0 and self.fired >= self.times):
            return False
        if self.shard is not None and self.shard != shard:
            return False
        if self.segment is not None and segment is not None \
                and self.segment != segment:
            return False
        return True


class FaultPlan:
    """A deterministic schedule of faults.  ``log`` accumulates
    ``(kind, shard, segment)`` tuples in firing order."""

    def __init__(self, events: Sequence[FaultEvent] = (),
                 clock: Optional[LogicalClock] = None):
        self.events = list(events)
        self.clock = clock if clock is not None else LogicalClock()
        self.log: List[tuple] = []

    def _fire(self, kind: str, shard, segment) -> List[FaultEvent]:
        hits = []
        for ev in self.events:
            if ev._matches(kind, shard, segment):
                ev.fired += 1
                self.log.append((kind, shard, segment))
                hits.append(ev)
        return hits

    def before_segment(self, shard, segment: int) -> float:
        """Consulted before each shard segment step.  Raises for
        kill/transient/device-loss events; returns the slow-worker factor
        (1.0 when healthy)."""
        for ev in self._fire("kill", shard, segment):
            if ev.mode == "sigkill":
                os.kill(os.getpid(), signal.SIGKILL)
            raise InjectedKill(f"kill injected at shard={shard} seg={segment}")
        if self._fire("transient", shard, segment):
            raise InjectedTransient(
                f"transient fault at shard={shard} seg={segment}")
        if self._fire("device_loss", shard, segment):
            raise InjectedDeviceLoss(
                f"device lost at shard={shard} seg={segment}")
        factor = 1.0
        for ev in self._fire("slow", shard, segment):
            factor = max(factor, ev.factor)
        return factor

    def after_checkpoint(self, shard, segment: int, ckpt_dir: str):
        """Consulted after a shard checkpoint commit; ``corrupt`` events
        damage the newest committed step in ``ckpt_dir``."""
        for ev in self._fire("corrupt", shard, segment):
            corrupt_checkpoint(ckpt_dir, mode=ev.corrupt_mode)

    def poison_positions(self, shard) -> List[int]:
        """Config positions within ``shard`` whose counters the harness
        garbles post-compute (no ``times`` consumption — poison is a
        standing property of the config, stable across resume)."""
        out = []
        for ev in self.events:
            if ev.kind == "poison" and \
                    (ev.shard is None or ev.shard == shard):
                self.log.append(("poison", shard, ev.cfg_pos))
                out.append(ev.cfg_pos)
        return out


def seeded_plan(seed: int, n_shards: int, n_segments: int, *,
                kinds: Sequence[str] = ("kill", "transient", "slow"),
                n_events: int = 3) -> FaultPlan:
    """A reproducible random plan: ``n_events`` events drawn from ``kinds``
    at uniform (shard, segment) sites.  Same seed → same plan → same
    firing log — the property the interleaving tests sweep over."""
    rng = random.Random(seed)
    events = []
    for _ in range(n_events):
        kind = rng.choice(list(kinds))
        events.append(FaultEvent(
            kind=kind,
            shard=rng.randrange(n_shards),
            segment=rng.randrange(n_segments),
            factor=2.0 + 4.0 * rng.random(),
            corrupt_mode=rng.choice(
                ["truncate_leaf", "drop_committed", "garbage_manifest"]),
        ))
    return FaultPlan(events)


def corrupt_checkpoint(path: str, step: Optional[int] = None, *,
                       mode: str = "truncate_leaf"):
    """Damage a committed checkpoint in place (crash-consistency tests).

    Modes: ``truncate_leaf`` halves ``leaf_0.npy`` (unreadable npy),
    ``delete_leaf`` removes it, ``drop_committed`` removes the COMMITTED
    marker (step becomes invisible), ``garbage_manifest`` overwrites
    ``manifest.json`` with non-JSON bytes."""
    if step is None:
        step = latest_step(path)
    if step is None:
        raise FileNotFoundError(f"no committed checkpoint under {path}")
    d = os.path.join(path, f"step_{step}")
    if mode == "truncate_leaf":
        leaf = os.path.join(d, "leaf_0.npy")
        size = os.path.getsize(leaf)
        with open(leaf, "r+b") as f:
            f.truncate(max(1, size // 2))
    elif mode == "delete_leaf":
        os.remove(os.path.join(d, "leaf_0.npy"))
    elif mode == "drop_committed":
        os.remove(os.path.join(d, "COMMITTED"))
    elif mode == "garbage_manifest":
        with open(os.path.join(d, "manifest.json"), "w") as f:
            f.write("{not json")
    else:
        raise ValueError(f"unknown corrupt mode: {mode}")
    return d


def describe_plan(plan: FaultPlan) -> str:
    """One-line-per-event rendering for logs and CI summaries."""
    return json.dumps([dataclasses.asdict(ev) for ev in plan.events],
                      indent=2, default=str)
