"""Host-side chunked streaming replay of the simulator, PyTorch port of
``repro.core.streaming`` (DESIGN.md §13).

The monolithic replay holds the whole trace on the device.  This module
feeds fixed-shape trace segments through the segment-carried API
(``dram.sim_init`` -> ``dram.resume`` per segment -> ``dram.finalize``), so
a stream of any length replays with O(chunk) device memory, one
``sim_scan`` launch per segment on the card (the eager loop on the CPU).
Because the monolithic replay is a left fold of the same step over the
same ``dram.SimState`` and chunk padding uses the counter-inert no-op
sentinel, ANY chunking of ANY trace is bitwise identical to the monolithic
replay (``tests/test_torch_streaming.py``).

Pipeline, per stream:

 * segments arrive from ``iter_chunks`` (slices of a materialized trace),
   ``decoded_segments`` (the ``traces`` chunk codec, decoded on the
   device) or any generator;
 * a non-identity controller is applied by ``scheduled_segments`` — the
   carried ``policies.StreamScheduler`` window reproduces the monolithic
   permutation exactly across chunk boundaries;
 * ``simulate_stream`` advances the ``SimState`` one segment at a time; on
   the card the launches are asynchronous, so the host prepares the next
   segment while the device replays the current one;
 * every ``checkpoint_every`` segments the carry is snapshotted via
   ``checkpoint.save_sim_state``; ``resume_stream`` restores it and skips
   the already-simulated prefix.

With a telemetry collector (``obs.WindowCollector``, anything with
``add(frames)`` / ``close(state)``) and a config whose ``telemetry`` is
the window period, segments run through ``dram.resume_tel`` /
``sweep_resume_tel``: each segment's frames go to the collector, and the
cursor rides in ``SimState.tel``, so the collected series is chunking-
invariant (DESIGN.md §15).
"""
from __future__ import annotations

import itertools
from typing import Iterable, Iterator, List, Optional

import numpy as np
import torch

from repro_torch import checkpoint as ckpt_lib
from repro_torch.core import dram
from repro_torch.core import traces as traces_lib
from repro_torch.core.dram import host_array
from repro_torch.core.sched import policies as sched_policies
from repro_torch.core.sched import wavefront
from repro_torch.core.timing import DDR4, GEOM, DRAMTimings, MechConfig
from repro_torch.device import resolve_device

__all__ = ["iter_chunks", "decoded_segments", "scheduled_segments",
           "simulate_stream", "sweep_stream", "resume_stream"]

_FIELD_DTYPES = dict(zip(dram.Trace._fields, (np.int32,) * 4 +
                         (np.bool_, np.int32)))


def iter_chunks(trace: dram.Trace, chunk_len: int) -> Iterator[dram.Trace]:
    """Slice a materialized (T,)/(C, T) trace (numpy or tensor leaves) into
    ``chunk_len`` segments (ragged tail no-op padded to the shared fixed
    shape)."""
    T = trace.t_issue.shape[-1]
    for lo in range(0, max(T, 1), chunk_len):
        part = dram.Trace(*[x[..., lo:lo + chunk_len] for x in trace])
        yield dram.noop_pad(part, chunk_len)


def decoded_segments(encoded, device=None) -> Iterator[dram.Trace]:
    """Decode codec chunks into replay segments on ``device``.

    ``encoded`` is a ``List[TraceChunk]`` (single channel -> (L,)
    segments) or a per-channel ``List[List[TraceChunk]]`` (-> (C, L)
    segments).  Channels fragment independently (each chunk holds a
    channel-specific number of real requests before its filler tail), so
    multi-channel alignment stacks each channel's i-th chunk — chunk-
    interior no-ops keep the per-channel streams exact — and channels that
    ran out of chunks feed all-no-op rows."""
    if not encoded:
        return
    dev = resolve_device(device)
    if isinstance(encoded[0], traces_lib.TraceChunk):
        for c in encoded:
            yield traces_lib.decode_chunk(c, dev)
        return
    L = int(np.asarray(encoded[0][0].dt).shape[0])
    if any(not per or int(np.asarray(per[0].dt).shape[0]) != L
           for per in encoded):
        raise ValueError("all channels must share one codec chunk_len")
    empty = dram.noop_pad(dram.Trace(*[
        torch.zeros(0, dtype=dt, device=dev) for dt in dram._TRACE_DTYPES]),
        L)
    for i in range(max(len(per) for per in encoded)):
        rows = [traces_lib.decode_chunk(per[i], dev) if i < len(per)
                else empty for per in encoded]
        yield dram.Trace(*[torch.stack(xs) for xs in zip(*rows)])


def scheduled_segments(segments: Iterable[dram.Trace],
                       sc, geom=GEOM) -> Iterator[dram.Trace]:
    """Apply a controller to a segment stream with a carried window.

    Wraps one ``StreamScheduler`` per channel and re-packs their emitted
    requests into numpy segments of the input's fixed shape (no-op fill
    where a channel's window is still holding requests back).  The
    concatenated per-channel output is bitwise the monolithic ``schedule``
    order, so a scheduled streamed replay equals the scheduled monolithic
    one."""
    it = iter(segments)
    try:
        first = next(it)
    except StopIteration:
        return
    shape = tuple(first.t_issue.shape)
    multi = len(shape) == 2
    C, L = shape if multi else (1, shape[0])
    scheds = [sched_policies.StreamScheduler(sc, geom) for _ in range(C)]
    pending: List[dict] = [
        {f: [np.zeros(0, dt)] for f, dt in _FIELD_DTYPES.items()}
        for _ in range(C)]

    def take(c: int) -> dram.Trace:
        cat = {f: np.concatenate(v) for f, v in pending[c].items()}
        pending[c] = {f: [v[L:]] for f, v in cat.items()}
        return dram.noop_pad(dram.Trace(**{f: v[:L] for f, v in cat.items()}),
                             L)

    def pack(flush: bool) -> Iterator[dram.Trace]:
        # emit full segments while any channel holds >= L requests (at the
        # end of the stream, while any holds one); a channel with fewer
        # contributes what it has plus no-op fill
        while True:
            most = max(sum(a.shape[0] for a in pending[c]["t_issue"])
                       for c in range(C))
            if most == 0 or (most < L and not flush):
                return
            rows = [take(c) for c in range(C)]
            yield dram.Trace(*[np.stack(xs) for xs in zip(*rows)]) \
                if multi else rows[0]

    for seg in itertools.chain([first], it):
        seg = dram.Trace(*[host_array(x) for x in seg])
        for c in range(C):
            row = dram.Trace(*[x[c] for x in seg]) if multi else seg
            for f, x in zip(dram.Trace._fields, scheds[c].feed(row)):
                pending[c][f].append(x)
        yield from pack(flush=False)
    for c in range(C):
        for f, x in zip(dram.Trace._fields, scheds[c].flush()):
            pending[c][f].append(x)
    yield from pack(flush=True)


def _check_telemetry(telemetry, static, wavefront_exec=False):
    """Validate a telemetry collector against the run's static config."""
    if telemetry is None:
        return
    if not static.telemetry:
        raise ValueError(
            "a telemetry collector needs a telemetry-enabled config "
            "(set MechConfig.telemetry to the window period)")
    if wavefront_exec:
        raise ValueError("telemetry windows are not supported under "
                         "wavefront execution")


def _lead(seg: dram.Trace) -> tuple:
    """The channel axis of a segment: ``(C,)`` for (C, L) leaves."""
    sh = tuple(seg.t_issue.shape)
    return sh[:1] if len(sh) == 2 else ()


def _replay(segments: Iterable[dram.Trace], static, params, state,
            start_chunk: int, checkpoint_dir, checkpoint_every: int,
            batch: Optional[int], wavefront_exec: bool, telemetry, dev):
    """Advance ``state`` (a fresh one when None) over every segment from
    ``start_chunk`` on, handing each segment's frames to ``telemetry``
    when given and closing it at the end; returns the final state and the
    channel axis."""
    lead = None
    for i, seg in enumerate(segments):
        if lead is None:
            lead = _lead(seg)
        if i < start_chunk:
            continue
        if state is None:
            state = dram.sim_init(static, channels=lead[0] if lead else None,
                                  batch=batch, device=dev)
        if wavefront_exec:
            state = wavefront.resume_waves(wavefront.form_waves(seg), static,
                                           params, state, dev)
        elif telemetry is not None:
            run = dram.resume_tel if batch is None else \
                dram.sweep_resume_tel
            state, frames = run(seg, static, params, state, device=dev)
            telemetry.add(frames)
        else:
            state = dram.resume(seg, static, params, state, device=dev)
        if checkpoint_dir and checkpoint_every and \
                (i + 1) % checkpoint_every == 0:
            ckpt_lib.save_sim_state(checkpoint_dir, i + 1, state)
    if state is None or lead is None:
        raise ValueError("empty segment stream")
    if telemetry is not None:
        telemetry.close(state)
    return state, lead


def simulate_stream(segments: Iterable[dram.Trace], cfg: MechConfig,
                    t: DRAMTimings = DDR4, *, wavefront_exec: bool = False,
                    state: Optional[dram.SimState] = None,
                    start_chunk: int = 0,
                    checkpoint_dir: Optional[str] = None,
                    checkpoint_every: int = 0,
                    telemetry=None, device=None) -> dram.Counters:
    """Replay a segment stream under one config; returns final counters,
    shaped like ``dram.run_channel(s)``'s.

    Bitwise-equal to the monolithic ``dram.run_channel(s)`` on the
    concatenated stream (after ``cfg.sched`` scheduling, applied here via
    the carried ``scheduled_segments`` window).  ``wavefront_exec`` forms
    per-segment waves and replays them through ``wavefront.resume_waves``
    instead.  ``state``/``start_chunk`` resume a checkpointed replay (see
    ``resume_stream``); ``checkpoint_dir`` + ``checkpoint_every`` snapshot
    the carry every N segments.  ``telemetry`` is a window-frame collector
    and requires ``cfg.telemetry > 0`` (see the module docstring)."""
    static = cfg.static
    _check_telemetry(telemetry, static, wavefront_exec)
    dev = resolve_device(device)
    it: Iterable[dram.Trace] = segments
    if cfg.sched is not None and not cfg.sched.is_identity:
        it = scheduled_segments(it, cfg.sched)
    state, lead = _replay(it, static, cfg.params(t, dev), state,
                          start_chunk, checkpoint_dir, checkpoint_every,
                          None, wavefront_exec, telemetry, dev)
    return dram._unlane(dram.finalize(state), lead)


def resume_stream(segments: Iterable[dram.Trace], cfg: MechConfig,
                  checkpoint_dir: str, t: DRAMTimings = DDR4,
                  **kw) -> dram.Counters:
    """Restore the newest committed ``SimState`` under ``checkpoint_dir``
    and finish the stream.  ``segments`` must be the SAME stream the
    interrupted run consumed (the already-simulated prefix is skipped by
    segment count); the result is bitwise the uninterrupted replay's."""
    peek = iter(segments)
    first = next(peek)
    lead = _lead(first)
    like = dram.sim_init(cfg.static, channels=lead[0] if lead else None,
                         device=resolve_device(kw.get("device")))
    state, chunk = ckpt_lib.restore_sim_state(checkpoint_dir, like)
    return simulate_stream(itertools.chain([first], peek), cfg, t,
                           state=state, start_chunk=chunk, **kw)


def sweep_stream(segments: Iterable[dram.Trace],
                 static, params_batch, *,
                 state: Optional[dram.SimState] = None,
                 start_chunk: int = 0,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 0,
                 telemetry=None, device=None) -> dram.Counters:
    """Batched streamed replay: ``dram.run_sweep``'s semantics over a
    segment stream (params leaves (P,)), counters ``(P, ...)`` or ``(P, C,
    ...)``.  Callers pre-schedule or stream identity-order traces — the
    sweep layer (``simulator.sweep``) owns controller grouping.
    ``state``/``start_chunk``/``checkpoint_dir``/``checkpoint_every``
    mirror ``simulate_stream``; ``telemetry`` collects the whole grid's
    frames (leaves gain the (P, [C,]) lead axes)."""
    _check_telemetry(telemetry, static)
    P = dram._n_params(params_batch)
    if P is None:
        raise ValueError("sweep_stream needs params leaves with a (P,) axis")
    state, lead = _replay(segments, static, params_batch, state, start_chunk,
                          checkpoint_dir, checkpoint_every, P, False,
                          telemetry, resolve_device(device))
    return dram._unlane(dram.finalize(state), (P,) + lead)
