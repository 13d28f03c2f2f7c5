"""Fault-tolerant sharded sweep orchestration (DESIGN.md §14), PyTorch port
of ``repro.launch.orchestrator``.

The sweep engine (``simulator.sweep_traces``) runs a whole
(mechanism x capacity x segment x scheduler x workload) product as a handful
of replays, but as ONE process-lifetime monolith: any preemption, device
loss, or pathological config kills the entire grid.  This module decomposes
such a product into durable **work shards** and drives them to completion
under faults:

* **Shard** = one workload x one ``(static_group_key, sched)`` config group,
  exactly the unit ``simulator.sweep`` replays as one ``sim_scan`` launch
  per segment.  Each shard is keyed by a content hash of its (workload
  spec, config tuple, chunk_len), so a resumed run recognizes finished work
  across process restarts regardless of enumeration order.  Keys, the grid
  hash and the manifest are the JAX package's, byte for byte.
* **Manifest**: ``<run_dir>/manifest.json`` tracks every shard through
  pending -> running -> done/quarantined.  Writes go through a temp file +
  ``os.replace``, so a kill mid-update leaves the previous manifest intact.
  ``reconcile`` repairs half-states on resume: a shard marked running with
  a committed result becomes done; a shard marked done whose result
  directory is gone becomes pending again.
* **Mid-shard checkpoints**: each shard streams its trace segment by
  segment through ``dram.resume`` (one ``sim_scan`` launch on the card, the
  eager loop on the CPU) carrying a ``ShardProgress`` (the lane-layout
  ``SimState`` plus int32 segment/request accumulators), checkpointed every
  ``checkpoint_every`` segments through ``checkpoint.save_checkpoint``.  A
  killed run resumes by skipping done shards and restoring the in-flight
  shard's newest *valid* committed progress (``checkpoint.restore_latest``
  skips corrupt steps).  Everything a resume reads is under ``run_dir``.
* **Device mesh**: a shard's lanes are laid over a ``("params",
  "channel")`` ``SweepMesh`` (``launch.mesh.make_sweep_mesh``) of the
  orchestrator's device pool: params block ``i`` x channel block ``j``
  replays on ``devices[i, j]``.  Lanes are independent, so the split is
  pure layout and bitwise the single-device replay; losing a device
  rebuilds a smaller mesh and replays from the checkpoint.
* **Faults**: execution wraps in retry with exponential backoff
  (deterministic, via the plan's ``LogicalClock``), straggler re-issue
  under a fresh worker id (``HeartbeatMonitor`` EMA deadline), and
  graceful degradation: a config whose counters come back negative,
  non-finite, or saturated is **quarantined** with a diagnostic record in
  the manifest while the rest of the grid completes.  Only the injected
  ``FaultError``s are retried: a failure to build or launch the replay
  kernel propagates.  Every recovery decision leaves a durable per-attempt
  record in the shard's manifest ``events`` list AND an ``obs.Tracer``
  span/event timestamped off the same logical clock, so seeded runs log
  byte-identically (``--trace``).

Resume equivalence: shard counters are a pure function of (scheduled trace,
params); the scheduler permutation is host-deterministic, chunking is
bitwise-invariant, checkpoint/restore round-trips the exact carry bytes,
and ``dram.resume`` never modifies its input state.  Any interleaving of
kills and resumes therefore yields counters bitwise identical to the
uninterrupted sweep (``tests/test_torch_orchestrator.py``).

    PYTHONPATH=src python -m repro_torch.launch.orchestrator run \\
        --run-dir RUN [--kill SHARD:SEG --kill-mode sigkill] [--trace PATH]
    PYTHONPATH=src python -m repro_torch.launch.orchestrator compare \\
        --run-dir RUN
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch import checkpoint as ckpt_lib
from repro_torch.core import dram, simulator, streaming, workload
from repro_torch.core.sched import policies as sched_policies
from repro_torch.core.timing import (DDR4, DRAMTimings, MechConfig,
                                     MechParams, SchedConfig, paper_config,
                                     shared_static, stack_params)
from repro_torch.core.workload import content_hash
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import SweepMesh, make_sweep_mesh
from repro_torch.obs.trace import Tracer, chrome_from_jsonl
from repro_torch.runtime.fault_tolerance import HeartbeatMonitor
from repro_torch.runtime.faults import (FaultPlan, InjectedDeviceLoss,
                                        InjectedTransient)

MANIFEST_VERSION = 1
I32 = torch.int32


# ---------------------------------------------------------------------------
# device entry point

class ShardProgress(NamedTuple):
    """The checkpointable carry of one shard: the lane-layout simulator
    state (``P * C`` lanes, lane ``p * C + c``) plus int32 progress
    accumulators, 0-d tensors on the state's device."""
    sim: dram.SimState
    seg_done: torch.Tensor    # segments fully simulated
    reqs_done: torch.Tensor   # real (non-no-op) requests retired


def init_progress(static, batch: int, channels: Optional[int],
                  device=None) -> ShardProgress:
    dev = resolve_device(device)
    zero = torch.zeros((), dtype=I32, device=dev)
    return ShardProgress(
        sim=dram.sim_init(static, batch=batch, channels=channels, device=dev),
        seg_done=zero, reqs_done=zero.clone())


def _account(seg: dram.Trace, prog: ShardProgress,
             sim: dram.SimState) -> ShardProgress:
    t = torch.as_tensor(seg.t_issue, device=prog.reqs_done.device)
    real = (t < dram.NOOP_ISSUE).sum(dtype=I32)
    return ShardProgress(sim=sim, seg_done=prog.seg_done + 1,
                         reqs_done=prog.reqs_done + real)


def shard_step(seg: dram.Trace, static, params_batch: MechParams,
               prog: ShardProgress, variant: str = "fused",
               device=None) -> ShardProgress:
    """One segment of a shard: ``dram.resume`` plus progress accounting.
    ``prog`` is not modified."""
    return _account(seg, prog, dram.resume(seg, static, params_batch,
                                           prog.sim, variant, device))


def _zip_map(fn, a, b):
    """``fn(leaf_a, leaf_b)`` over two ``SimState``-shaped nests."""
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        return fn(a, b)
    return type(a)(*[_zip_map(fn, x, y) for x, y in zip(a, b)])


def mesh_step(mesh: SweepMesh, seg: dram.Trace, static,
              params_batch: MechParams, prog: ShardProgress
              ) -> ShardProgress:
    """``shard_step`` laid over ``mesh``, whose first device holds
    ``prog``: params block ``i`` x channel block ``j`` replays on
    ``mesh.devices[i, j]`` and its lanes are copied back.  A (1, 1) mesh is
    one replay."""
    p, c = mesh.devices.shape
    home = mesh.devices[0, 0]
    if p * c == 1:
        return shard_step(seg, static, params_batch, prog, device=home)
    P, C = int(params_batch[0].shape[0]), int(seg.t_issue.shape[0])
    ps, cs = P // p, C // c
    lane = torch.arange(P * C, device=home).reshape(P, C)
    sim = dram.clone_state(prog.sim, home)
    for i in range(p):
        for j in range(c):
            idx = lane[i * ps:(i + 1) * ps, j * cs:(j + 1) * cs].reshape(-1)
            blk = dram.resume(
                dram.Trace(*[x[j * cs:(j + 1) * cs] for x in seg]), static,
                MechParams(*[x[i * ps:(i + 1) * ps] for x in params_batch]),
                dram._map(lambda x: x[idx], prog.sim),
                device=mesh.devices[i, j])
            _zip_map(lambda dst, src: dst.index_copy_(0, idx, src.to(home)),
                     sim, blk)
    return _account(seg, prog, sim)


# ---------------------------------------------------------------------------
# plan / manifest

@dataclasses.dataclass(frozen=True)
class Shard:
    """One durable work unit: workload ``w`` under config positions
    ``cfg_idxs`` (one ``(static_group_key, sched)`` group of the grid)."""
    key: str                     # content hash, stable across runs
    w: int                       # workload index in the plan
    cfg_idxs: tuple              # positions into the plan's config list


@dataclasses.dataclass
class SweepPlan:
    """The full decomposed product.  ``shards`` is deterministic in
    (workload-major, config-group insertion) order; the fault plan's shard
    references are indices into it."""
    specs: List["workload.WorkloadSpec"]
    cfgs: List[MechConfig]
    chunk_len: int
    shards: List[Shard]
    grid_hash: str


def make_plan(specs: Sequence["workload.WorkloadSpec"],
              cfgs: Sequence[MechConfig], *, chunk_len: int = 4096
              ) -> SweepPlan:
    """Decompose workloads x configs into content-hash-keyed shards.

    Grouping reuses ``simulator.static_groups`` so each shard replays as
    exactly one static structure under one controller."""
    specs, cfgs = list(specs), list(cfgs)
    for s in specs:
        if not isinstance(s, workload.WorkloadSpec):
            raise TypeError(
                "make_plan takes WorkloadSpecs (content-hashable, "
                f"regenerable on resume); got {type(s).__name__}")
    shards = []
    groups = simulator.static_groups(cfgs)
    for w, spec in enumerate(specs):
        for (_, _sc), idxs in groups.items():
            key = content_hash((spec, tuple(cfgs[i] for i in idxs),
                                int(chunk_len)))[:16]
            shards.append(Shard(key=key, w=w, cfg_idxs=tuple(idxs)))
    grid_hash = content_hash((tuple(specs), tuple(cfgs), int(chunk_len)))[:16]
    return SweepPlan(specs=specs, cfgs=cfgs, chunk_len=int(chunk_len),
                     shards=shards, grid_hash=grid_hash)


def _fresh_entry(shard: Shard, plan: SweepPlan) -> dict:
    # "events" is the shard's durable diagnostic trail: one record per
    # straggler re-issue / transient retry / device loss, committed to the
    # manifest as it happens so a postmortem after ANY sequence of kills
    # still sees every recovery decision (the span log is the live twin)
    return {"workload": plan.specs[shard.w].content_hash()[:16],
            "cfg_idxs": list(shard.cfg_idxs), "status": "pending",
            "worker": None, "attempts": 0, "reissues": 0,
            "segments_done": 0, "quarantined_cfgs": {}, "diag": None,
            "events": []}


def write_manifest(path: str, manifest: dict):
    """Atomic manifest commit: temp file + ``os.replace``; a kill between
    the two leaves the previous manifest intact (never a torn JSON)."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1)
    os.replace(tmp, path)


def load_manifest(path: str) -> Optional[dict]:
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def _host_counters(cnt: dram.Counters) -> dram.Counters:
    return dram.Counters(*[x.detach().cpu().numpy().copy() for x in cnt])


def _jax_layout(cnts: dram.Counters, P: int, C: int) -> dram.Counters:
    """Lane-layout numpy counters ``(P * C, ...)`` as ``(P, C, ...)``
    views, the JAX package's layout."""
    return dram.Counters(*[a.reshape((P, C) + a.shape[1:]) for a in cnts])


class Orchestrator:
    """Drives a ``SweepPlan`` to completion under faults (DESIGN.md §14).

    ``devices`` is the device pool (``None``: the CUDA device); the first
    one holds every shard's carry, the mesh spreads its replay over the
    pool."""

    def __init__(self, plan: SweepPlan, run_dir: str, *,
                 t: DRAMTimings = DDR4, use_mesh: bool = True,
                 checkpoint_every: int = 1, max_retries: int = 2,
                 max_reissues: int = 2, backoff_s: float = 0.05,
                 fault_plan: Optional[FaultPlan] = None,
                 monitor: Optional[HeartbeatMonitor] = None,
                 nominal_step_s: float = 1.0,
                 tracer: Optional[Tracer] = None, devices=None):
        self.plan = plan
        self.run_dir = run_dir
        self.t = t
        self.use_mesh = use_mesh
        self.devices = [resolve_device(d) for d in
                        (devices if devices is not None else [None])]
        self.home = self.devices[0]
        self.checkpoint_every = checkpoint_every
        self.max_retries = max_retries
        self.max_reissues = max_reissues
        self.backoff_s = backoff_s
        self.faults = fault_plan if fault_plan is not None else FaultPlan()
        self.nominal_step_s = nominal_step_s
        # span-traced orchestration (DESIGN.md §15): timestamps come from
        # the fault plan's LogicalClock, so a seeded run writes a
        # byte-identical span log every time
        self.tracer = tracer if tracer is not None else Tracer(
            clock=self.faults.clock.now)
        self.monitor = monitor if monitor is not None else HeartbeatMonitor(
            [s.key for s in plan.shards], now=self.faults.clock.now)
        self._lost_devices = 0
        os.makedirs(run_dir, exist_ok=True)
        self.manifest_path = os.path.join(run_dir, "manifest.json")
        self.manifest = load_manifest(self.manifest_path)
        if self.manifest is None:
            self.manifest = {"version": MANIFEST_VERSION,
                             "grid_hash": plan.grid_hash,
                             "chunk_len": plan.chunk_len,
                             "shards": {s.key: _fresh_entry(s, plan)
                                        for s in plan.shards}}
            write_manifest(self.manifest_path, self.manifest)
        elif self.manifest.get("grid_hash") != plan.grid_hash:
            raise ValueError(
                f"run_dir {run_dir} holds a different grid "
                f"({self.manifest.get('grid_hash')} != {plan.grid_hash}); "
                "refusing to mix sweeps")
        self.reconcile()

    # -- paths ------------------------------------------------------------
    def _shard_dir(self, key: str) -> str:
        return os.path.join(self.run_dir, "shards", key)

    def _ckpt_dir(self, key: str) -> str:
        return os.path.join(self._shard_dir(key), "ckpt")

    def _result_dir(self, key: str) -> str:
        return os.path.join(self._shard_dir(key), "result")

    def _result_committed(self, key: str) -> bool:
        return ckpt_lib.latest_step(self._result_dir(key)) is not None

    # -- manifest ---------------------------------------------------------
    def reconcile(self):
        """Repair manifest half-states after a crash: trust the durable
        result directory (COMMITTED is the source of truth), not the
        status word a kill may have orphaned."""
        changed = False
        for shard in self.plan.shards:
            e = self.manifest["shards"][shard.key]
            committed = self._result_committed(shard.key)
            if e["status"] in ("running", "pending") and committed:
                e["status"] = "done"
                changed = True
            elif e["status"] == "done" and not committed:
                e["status"] = "pending"
                changed = True
            elif e["status"] == "running":
                e["status"] = "pending"       # crashed mid-shard: resume
                changed = True
        if changed:
            write_manifest(self.manifest_path, self.manifest)

    def _set_status(self, key: str, status: str, **fields):
        e = self.manifest["shards"][key]
        e["status"] = status
        e.update(fields)
        write_manifest(self.manifest_path, self.manifest)

    def _record_event(self, e: dict, rec: dict):
        """Append one durable per-attempt diagnostic record to the shard's
        manifest entry and commit it immediately: recovery decisions must
        survive a kill that lands right after them."""
        e.setdefault("events", []).append(rec)
        write_manifest(self.manifest_path, self.manifest)

    # -- shard execution --------------------------------------------------
    def _shard_inputs(self, shard: Shard):
        """Regenerate the shard's (scheduled trace, static, params batch)
        on the home device.  Deterministic: the spec synthesizes the same
        trace on every process, and scheduling is a host-side pure
        permutation."""
        spec = self.plan.specs[shard.w]
        cfgs = [self.plan.cfgs[i] for i in shard.cfg_idxs]
        static = shared_static(cfgs)
        trace = sched_policies.schedule(
            workload.generate(spec, device=self.home), cfgs[0].sched)
        batch = stack_params([c.params(self.t, self.home) for c in cfgs])
        return trace, static, batch

    def _mesh_for(self, P: int, C: int) -> SweepMesh:
        devs = self.devices if self.use_mesh else self.devices[:1]
        if self._lost_devices:
            devs = devs[:max(1, len(devs) - self._lost_devices)]
        return make_sweep_mesh(P, C, devices=devs)

    def _restore_progress(self, key: str, static, P: int,
                          C: Optional[int]) -> tuple:
        """(progress, segments_done): the newest valid committed
        checkpoint, or a fresh carry.  Corrupt steps fall back
        automatically (``restore_latest`` skips them)."""
        fresh = init_progress(static, P, C, device=self.home)
        try:
            prog, step, _ = ckpt_lib.restore_latest(
                self._ckpt_dir(key), fresh, kind="shard_prog")
        except ckpt_lib.CheckpointError:
            self.tracer.event("checkpoint.fresh", shard=key)
            return fresh, 0
        self.tracer.event("checkpoint.restore", shard=key, segment=step)
        return prog, step

    def _execute_shard(self, shard_idx: int, shard: Shard, worker: str):
        """One attempt at one shard: resume from the newest checkpoint,
        stream the remaining segments, commit the result.  Raises the
        injected fault exceptions for the caller's retry logic."""
        trace, static, batch = self._shard_inputs(shard)
        sh = tuple(trace.t_issue.shape)
        C = sh[0] if len(sh) == 2 else None
        P = len(shard.cfg_idxs)
        L = self.plan.chunk_len
        n_seg = max(1, -(-sh[-1] // L))
        prog, start_seg = self._restore_progress(shard.key, static, P, C)
        mesh = self._mesh_for(P, C if C is not None else 1)
        e = self.manifest["shards"][shard.key]
        for i, seg in enumerate(streaming.iter_chunks(trace, L)):
            if i < start_seg:
                continue
            factor = self.faults.before_segment(shard_idx, i)
            prog = mesh_step(mesh, seg, static, batch, prog)
            if self.monitor is not None:
                self.monitor.beat(worker, self.nominal_step_s * factor)
                if e["reissues"] < self.max_reissues and \
                        worker in self.monitor.stragglers():
                    raise _StragglerReissue(worker)
            if self.checkpoint_every and \
                    (i + 1) % self.checkpoint_every == 0 and (i + 1) < n_seg:
                # a span, not an instant: injected kills fire right after
                # the commit (after_checkpoint), so a log ending inside an
                # open checkpoint.save span pinpoints the death site
                with self.tracer.span("checkpoint.save", shard=shard.key,
                                      segment=i + 1):
                    ckpt_lib.save_checkpoint(self._ckpt_dir(shard.key),
                                             i + 1, prog,
                                             {"kind": "shard_prog"})
                    self.faults.after_checkpoint(shard_idx, i,
                                                 self._ckpt_dir(shard.key))
                e["segments_done"] = i + 1
                write_manifest(self.manifest_path, self.manifest)
        cnts = _host_counters(dram.finalize(prog.sim))
        quarantined = self._apply_poison_and_diagnose(shard_idx, shard, cnts,
                                                      C or 1)
        ckpt_lib.save_checkpoint(
            self._result_dir(shard.key), 0, cnts,
            {"kind": "shard_result", "quarantined": quarantined,
             "reqs_done": int(prog.reqs_done)})
        return quarantined

    def _apply_poison_and_diagnose(self, shard_idx: int, shard: Shard,
                                   cnts: dram.Counters, C: int
                                   ) -> Dict[str, str]:
        """Inject plan poison (a config position's counters garbled
        post-compute, in the host copy), then diagnose every config slice;
        returns {cfg position within shard: diagnostic} for the
        quarantined ones."""
        per_cfg = _jax_layout(cnts, len(shard.cfg_idxs), C)   # views
        for pos in self.faults.poison_positions(shard_idx):
            if 0 <= pos < len(shard.cfg_idxs):
                per_cfg.req_cnt[pos] = -5    # models an int32-wrapped config
        quarantined = {}
        for pos in range(len(shard.cfg_idxs)):
            diag = counters_diagnosis(
                dram.Counters(*[a[pos] for a in per_cfg]))
            if diag is not None:
                quarantined[str(pos)] = diag
        return quarantined

    # -- the driver loop --------------------------------------------------
    def run(self) -> dict:
        """Drive every non-done shard to done/quarantined.  Injected kills
        (``InjectedKill``/SIGKILL) escape: re-instantiate and ``run()``
        again to resume; everything retryable is absorbed here."""
        with self.tracer.span("run", grid=self.plan.grid_hash,
                              shards=len(self.plan.shards)):
            for idx, shard in enumerate(self.plan.shards):
                e = self.manifest["shards"][shard.key]
                if e["status"] in ("done", "quarantined"):
                    continue
                self._run_shard(idx, shard)
        return self.status()

    def _run_shard(self, idx: int, shard: Shard):
        e = self.manifest["shards"][shard.key]
        worker = shard.key
        attempt = 0
        while True:
            self._set_status(shard.key, "running", worker=worker,
                             attempts=e["attempts"] + 1)
            # one span per ATTEMPT: an attempt that dies (kill) leaves its
            # span open in the log (the death marker); every other outcome
            # closes it with an explicit verdict
            self.tracer.begin("shard", key=shard.key, worker=worker,
                              attempt=e["attempts"])
            try:
                quarantined = self._execute_shard(idx, shard, worker)
                for pos in sorted(quarantined):
                    self.tracer.event("quarantine", key=shard.key,
                                      cfg_pos=int(pos),
                                      diag=quarantined[pos])
                self._set_status(shard.key, "done",
                                 quarantined_cfgs=quarantined)
                self.tracer.end("shard", outcome="done")
                return
            except _StragglerReissue:
                # re-issue under a fresh logical worker; the checkpointed
                # prefix is reused, so the slow attempt costs only its tail
                e["reissues"] += 1
                new_worker = f"{shard.key}#r{e['reissues']}"
                self._record_event(e, {
                    "kind": "straggler_reissue", "worker": worker,
                    "new_worker": new_worker, "attempt": e["attempts"],
                    "reissue": e["reissues"]})
                self.tracer.event("straggler_reissue", key=shard.key,
                                  worker=worker, new_worker=new_worker,
                                  reissue=e["reissues"])
                self.tracer.end("shard", outcome="reissued")
                worker = new_worker
                self.monitor.add_worker(worker)
                continue
            except InjectedDeviceLoss:
                # shrink the device pool and replay from the checkpoint:
                # placement-only blocks make the re-run bitwise equal
                self._lost_devices += 1
                self._record_event(e, {
                    "kind": "device_loss", "worker": worker,
                    "attempt": e["attempts"],
                    "devices_lost": self._lost_devices})
                self.tracer.event("device_loss", key=shard.key,
                                  devices_lost=self._lost_devices)
                self.tracer.end("shard", outcome="device_loss")
                continue
            except InjectedTransient as exc:
                attempt += 1
                if attempt > self.max_retries:
                    self._record_event(e, {
                        "kind": "retries_exhausted", "worker": worker,
                        "attempt": attempt})
                    self.tracer.event("quarantine", key=shard.key,
                                      diag=f"retries exhausted: {exc}")
                    self.tracer.end("shard", outcome="quarantined")
                    self._set_status(shard.key, "quarantined",
                                     diag=f"retries exhausted: {exc}")
                    return
                backoff = (self.backoff_s * 2 ** (attempt - 1)
                           if self.backoff_s else 0.0)
                self._record_event(e, {
                    "kind": "transient_retry", "worker": worker,
                    "attempt": attempt, "backoff_s": backoff})
                self.tracer.event("transient_retry", key=shard.key,
                                  worker=worker, attempt=attempt,
                                  backoff_s=backoff)
                self.tracer.end("shard", outcome="retry")
                if backoff:
                    self.faults.clock.sleep(backoff)
                continue

    # -- results ----------------------------------------------------------
    def status(self) -> dict:
        counts: Dict[str, int] = {}
        for e in self.manifest["shards"].values():
            counts[e["status"]] = counts.get(e["status"], 0) + 1
        return counts

    def counters_by_config(self) -> Dict[tuple, dram.Counters]:
        """{(workload index, config index): numpy ``Counters`` slice in the
        JAX package's layout} for every healthy config of every done shard:
        the bitwise unit the resume-equivalence tests compare.  Quarantined
        configs are absent."""
        out = {}
        for shard in self.plan.shards:
            e = self.manifest["shards"][shard.key]
            if e["status"] != "done":
                continue
            cnts, _, extra = self._load_result(shard)
            for pos, cfg_idx in enumerate(shard.cfg_idxs):
                if str(pos) in extra.get("quarantined", {}):
                    continue
                out[(shard.w, cfg_idx)] = dram.Counters(
                    *[a[pos] for a in cnts])
        return out

    def _load_result(self, shard: Shard):
        """The shard's committed counters as numpy ``(P, C, ...)``."""
        spec = self.plan.specs[shard.w]
        cfgs = [self.plan.cfgs[i] for i in shard.cfg_idxs]
        static = shared_static(cfgs)
        # workload.generate always emits (C, T) traces, so the shard ran
        # with an explicit channel axis even when n_channels == 1
        C = spec.n_channels
        like = dram.finalize(dram.sim_init(static, batch=len(cfgs),
                                           channels=C, device="cpu"))
        step = ckpt_lib.latest_step(self._result_dir(shard.key))
        cnts, extra = ckpt_lib.restore_checkpoint(
            self._result_dir(shard.key), step, like)
        return _jax_layout(_host_counters(cnts), len(cfgs), C), step, extra

    def results(self) -> List[List[Optional[simulator.RunResult]]]:
        """``results[w][i]`` like ``simulator.sweep_traces``; ``None`` for
        quarantined configs (their diagnostics live in the manifest)."""
        W, N = len(self.plan.specs), len(self.plan.cfgs)
        out: List[List[Optional[simulator.RunResult]]] = [
            [None] * N for _ in range(W)]
        for shard in self.plan.shards:
            e = self.manifest["shards"][shard.key]
            if e["status"] != "done":
                continue
            cnts, _, extra = self._load_result(shard)
            spec = self.plan.specs[shard.w]
            cfgs = [self.plan.cfgs[i] for i in shard.cfg_idxs]
            res = simulator._results_from_counters_batch(
                cnts, cfgs, spec.apps(), spec.n_channels)
            for pos, cfg_idx in enumerate(shard.cfg_idxs):
                if str(pos) in extra.get("quarantined", {}):
                    continue
                out[shard.w][cfg_idx] = res[pos]
        return out

    def quarantined(self) -> Dict[tuple, str]:
        """{(workload, config index): diagnostic} across the whole run:
        both per-config counter quarantines and whole-shard retry
        exhaustion."""
        out = {}
        for shard in self.plan.shards:
            e = self.manifest["shards"][shard.key]
            if e["status"] == "quarantined":
                for cfg_idx in shard.cfg_idxs:
                    out[(shard.w, cfg_idx)] = e.get("diag") or "shard failed"
            for pos, diag in e.get("quarantined_cfgs", {}).items():
                out[(shard.w, shard.cfg_idxs[int(pos)])] = diag
        return out


class _StragglerReissue(Exception):
    """Internal control flow: this attempt tripped the straggler deadline;
    abandon it and re-issue from the checkpoint under a new worker."""


def counters_diagnosis(cnt) -> Optional[str]:
    """Health verdict for one config's ``Counters`` slice, or ``None``.

    The counters are int32, so "NaN" manifests as wrap (negative) rather
    than a float NaN; the float cast covers any future float counter."""
    for name, arr in zip(type(cnt)._fields, cnt):
        a = np.asarray(arr)
        if not np.all(np.isfinite(a.astype(np.float64))):
            return f"non-finite {name}"
        if np.any(a < 0):
            return f"negative {name} (int32 wrap?)"
    if np.any(np.asarray(cnt.lat_sum_ns) >= dram.LAT_SUM_CAP):
        return "saturated lat_sum_ns"
    return None


# ---------------------------------------------------------------------------
# CLI: the kill-and-resume harness

def ci_grid(chunk_len: int = 128):
    """The fixed small grid the kill-and-resume harness runs: 2 workloads x
    5 configs (base + figcache_fast capacity points under two
    controllers)."""
    specs = [workload.preset("zipf_reuse", n_cores=2, n_channels=2,
                             per_channel=384, seed=11),
             workload.preset("stream", n_cores=2, n_channels=2,
                             per_channel=384, seed=12)]
    frfcfs = SchedConfig(policy="frfcfs")
    cfgs = [paper_config("base"),
            paper_config("figcache_fast", cache_rows=32),
            paper_config("figcache_fast", cache_rows=64),
            dataclasses.replace(paper_config("figcache_fast", cache_rows=32),
                                sched=frfcfs),
            dataclasses.replace(paper_config("figcache_fast", cache_rows=64),
                                sched=frfcfs)]
    return make_plan(specs, cfgs, chunk_len=chunk_len)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    runp = sub.add_parser("run", help="run (or resume) the sweep")
    runp.add_argument("--run-dir", required=True)
    runp.add_argument("--chunk-len", type=int, default=128)
    runp.add_argument("--kill", default=None, metavar="SHARD:SEG",
                      help="inject a kill at shard index SHARD, segment SEG")
    runp.add_argument("--kill-mode", choices=("raise", "sigkill"),
                      default="sigkill")
    runp.add_argument("--trace", default=None, metavar="PATH",
                      help="append the span/event log (JSONL) here; a "
                           "successful run also writes PATH's .chrome.json "
                           "Perfetto export")
    cmpp = sub.add_parser("compare", help="check run results against the "
                          "uninterrupted sweep_traces oracle, bitwise")
    cmpp.add_argument("--run-dir", required=True)
    cmpp.add_argument("--chunk-len", type=int, default=128)
    for p in (runp, cmpp):
        p.add_argument("--device", default=None,
                       help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    devices = [resolve_device(args.device)]
    plan = ci_grid(args.chunk_len)
    if args.cmd == "run":
        fault_plan = FaultPlan()
        if args.kill:
            from repro_torch.runtime.faults import FaultEvent
            s, k = (int(x) for x in args.kill.split(":"))
            fault_plan = FaultPlan([FaultEvent(
                kind="kill", shard=s, segment=k, mode=args.kill_mode)])
        tracer = None
        if args.trace:
            tracer = Tracer(args.trace, clock=fault_plan.clock.now)
        orch = Orchestrator(plan, args.run_dir, fault_plan=fault_plan,
                            backoff_s=0.0, tracer=tracer, devices=devices)
        counts = orch.run()
        print(f"shards: {counts}")
        if args.trace:
            tracer.close()
            dst = os.path.splitext(args.trace)[0] + ".chrome.json"
            n = chrome_from_jsonl(args.trace, dst)
            print(f"trace: {args.trace} -> {dst} ({n} events)")
        return 0
    # compare
    orch = Orchestrator(plan, args.run_dir, devices=devices)
    got = orch.counters_by_config()
    oracle = simulator.sweep_traces(plan.specs, plan.cfgs,
                                    chunk_len=args.chunk_len,
                                    device=devices[0])
    bad = 0
    for (w, i), cnt in sorted(got.items()):
        ref = oracle[w][i].counters
        for name, a, b in zip(type(cnt)._fields, cnt, ref):
            if not np.array_equal(np.asarray(a), np.asarray(b)):
                print(f"MISMATCH w={w} cfg={i} field={name}")
                bad += 1
    expect = len(plan.specs) * len(plan.cfgs)
    if len(got) != expect:
        print(f"MISSING results: {len(got)}/{expect}")
        bad += 1
    print("bitwise equal" if not bad else f"{bad} mismatches")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
