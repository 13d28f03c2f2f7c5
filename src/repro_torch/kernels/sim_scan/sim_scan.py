"""Wrapper of the Hopper ``sim_scan`` kernel (``csrc/sim_scan.cu``).

Replaces, on the card, the eager step loop of ``core/dram.py`` (its plain
version, ``dram._advance_eager``), which ports the JAX package's fused
``lax.scan`` of ``repro/core/dram.py``; the Pallas TPU kernel
``repro/kernels/fts_lookup/fts_lookup.py`` (``fts_lookup``) runs inside it
as ``fts_lookup_warp()``.  One launch replays a whole ``(T, N)`` trace and
updates every state and counter leaf in place.  What bounds it: a lane's
steps form one chain of dependent loads and stores, so T times a step's
dependent round trips, far above the bytes it moves (see the note in the
CUDA source).  With a telemetry period (``StaticConfig.telemetry``) the
launch runs the kernel's telemetry instantiation, which also advances a
``dram.TelScan`` (the open window, the cumulative §16 planes and the
segment's ring of closed windows) in place, as the eager loop's
``dram._telemetry_step`` does.

``host_replay`` runs the same per-request code (``csrc/sim_step.cuh``)
built by the host C++ compiler with a scalar lookup; the CPU tests hold
it against the eager loop.

The library is built and loaded at the first launch, never at import, so
this module imports on machines without CUDA or ``nvcc``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import List, Tuple

import torch

from repro_torch.core.timing import MECHANISMS
from repro_torch.kernels import _build

KERNEL = "sim_scan"
HOST = "sim_host"
POLICIES = ("row_benefit", "segment_benefit", "lru", "random")
N_MSHR = 8   # dram.N_MSHR
HIST_BUCKETS = 28   # dram.HIST_BUCKETS
TEL_LANES = 12      # len(dram._TEL_SCALARS)


def ring_rows(T: int, period: int) -> int:
    """Rows of a T-step segment's window ring: the most windows it can
    close plus the live row (the JAX package's ``_scan_segment``)."""
    return min(T, T // period + 2) + 1


class _Counter:
    """Launches of the kernel in this process (one per successful launch)."""
    launches = 0


COUNTER = _Counter()


def _lib() -> ctypes.CDLL:
    lib = _build.load(KERNEL)
    fn = lib.sim_scan_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3
        fn.restype = ctypes.c_int
    return lib


def _leaves(bank, cnt, tel=None) -> List[Tuple[str, torch.Tensor]]:
    """(name, tensor) of every state leaf in the kernel's order: BankState
    with the FTS flattened, then Counters, then (with telemetry) the
    ``dram.TelScan`` leaves."""
    out = []
    for name, x in zip(bank._fields, bank):
        if isinstance(x, torch.Tensor):
            out.append((name, x))
        else:
            out.extend((f"fts.{f}", y) for f, y in zip(x._fields, x))
    out += list(zip(cnt._fields, cnt))
    if tel is not None:
        out += [(f"tel.{f}", x) for f, x in zip(tel._fields, tel)]
    return out


def pack(trace, params, bank, cnt, static, geom, device: torch.device,
         tel=None):
    """Check every leaf and lay out the kernel's arguments: the
    ``(pointers, dims)`` ctypes arrays of ``csrc/sim_step.cuh``'s
    ``make_args``.

    ``trace`` leaves (T, N), ``params`` leaves (N,), ``bank`` a
    ``dram.BankState`` and ``cnt`` a ``dram.Counters`` with lane axis N,
    and with ``static.telemetry > 0`` (and only then) ``tel`` a
    ``dram.TelScan`` of W ring rows, all contiguous on ``device``.
    Raises ``ValueError`` on any other device, dtype, shape or layout,
    and on an unknown mechanism or policy."""
    if static.mechanism not in MECHANISMS or static.policy not in POLICIES:
        raise ValueError(f"sim_scan: unknown mechanism/policy "
                         f"{static.mechanism!r}/{static.policy!r}")
    period = int(static.telemetry)
    if (period > 0) != (tel is not None):
        raise ValueError(f"sim_scan: telemetry period {period} needs "
                         f"{'a' if period > 0 else 'no'} TelScan carry")
    if trace.t_issue.dim() != 2:
        raise ValueError("sim_scan: trace leaves must be (T, N)")
    T, N = trace.t_issue.shape
    nb, nc = geom.n_banks, geom.n_cores
    fts = bank.fts
    S, MS, NT = fts.tags.shape[-1], fts.evict_mask.shape[-1], \
        fts.miss_tags.shape[-1]
    want_slots = static.max_slots if static.has_cache else 1
    want_segs = static.max_segs_per_row if static.has_cache else 1
    if (S, MS) != (want_slots, want_segs):
        raise ValueError(f"sim_scan: FTS of {S} slots x {MS} segments per "
                         f"row does not match the static ({want_slots}, "
                         f"{want_segs})")
    i32, b8 = torch.int32, torch.bool
    shapes = {"open_row": (N, nb), "busy": (N, nb), "fts.tags": (N, nb, S),
              "fts.valid": (N, nb, S), "fts.dirty": (N, nb, S),
              "fts.benefit": (N, nb, S), "fts.last_use": (N, nb, S),
              "fts.evict_row": (N, nb), "fts.evict_mask": (N, nb, MS),
              "fts.miss_tags": (N, nb, NT), "fts.miss_cnt": (N, nb, NT),
              "fts.row_sum": (N, nb, S), "fts.free_list": (N, nb, S),
              "fts.n_valid": (N, nb), "mshr_ring": (N, nc, N_MSHR),
              "mshr_idx": (N, nc), "bus_free": (N,),
              "lat_sum_ns": (N, nc), "req_cnt": (N, nc)}
    W = 0
    if tel is not None:
        W = int(tel.buf_scalars.shape[1]) if tel.buf_scalars.dim() == 3 \
            else -1
        if W != ring_rows(T, period):
            raise ValueError(f"sim_scan: telemetry ring of {W} rows, a "
                             f"{T}-step segment at period {period} needs "
                             f"{ring_rows(T, period)}")
        nl, hb = TEL_LANES, HIST_BUCKETS
        shapes.update({
            "tel.scalars": (N, nl), "tel.bank_issues": (N, nb),
            "tel.hist_win": (N, hb), "tel.hist": (N, 2, nc, hb),
            "tel.slo": (N, nc), "tel.buf_scalars": (N, W, nl),
            "tel.buf_banks": (N, W, nb), "tel.buf_hist": (N, W, hb)})
    bools = {"is_write", "fts.valid", "fts.dirty", "fts.evict_mask"}
    leaves = [(f, x, (T, N)) for f, x in zip(trace._fields, trace)]
    leaves += [(f, x, (N,)) for f, x in zip(params._fields, params)]
    leaves += [(f, x, shapes.get(f, (N,)))
               for f, x in _leaves(bank, cnt, tel)]
    for name, x, shape in leaves:
        if not isinstance(x, torch.Tensor) or x.device != device:
            raise ValueError(f"sim_scan: {name} must be a tensor on {device}")
        dt = b8 if name in bools else i32
        if x.dtype != dt:
            raise ValueError(f"sim_scan: {name} must be {dt}, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"sim_scan: {name} has shape {tuple(x.shape)}, "
                             f"expected {shape}")
        if not x.is_contiguous():
            raise ValueError(f"sim_scan: {name} must be contiguous")
    ptrs = (ctypes.c_void_p * len(leaves))(*[x.data_ptr()
                                             for _, x, _ in leaves])
    dims = (ctypes.c_int * 14)(
        T, N, nb, S, MS, NT, nc, geom.n_rows, geom.rows_per_subarray,
        geom.n_subarrays, MECHANISMS.index(static.mechanism),
        POLICIES.index(static.policy), period, W)
    return ptrs, dims


def sim_scan(trace, params, bank, cnt, static, geom, tel=None) -> None:
    """Launch the CUDA kernel: replay every step of ``trace`` ((T, N) int32
    leaves, ``is_write`` bool) over N lanes with ``params`` ((N,) int32),
    updating ``bank`` (a ``dram.BankState``), ``cnt`` (a ``dram.Counters``)
    and, with a telemetry period, ``tel`` (a ``dram.TelScan``) IN PLACE,
    bitwise as ``T`` calls of ``dram.make_step(static, geom)`` would.

    Runs on the current stream without synchronising; raises if the launch
    is refused."""
    dev = trace.t_issue.device
    if dev.type != "cuda":
        raise ValueError("sim_scan launches the CUDA kernel and needs CUDA "
                         f"tensors; got {dev}")
    ptrs, dims = pack(trace, params, bank, cnt, static, geom, dev, tel)
    if dims[0] == 0 or dims[1] == 0:
        return
    err = _lib().sim_scan_launch(
        ctypes.cast(ptrs, ctypes.c_void_p), ctypes.cast(dims, ctypes.c_void_p),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sim_scan kernel launch failed: CUDA error {err}")
    COUNTER.launches += 1


def host_library() -> Path:
    """Build (once) the host C++ library of ``csrc/sim_host.cpp``."""
    return _build.build_host(HOST)


def host_replay(trace, params, bank, cnt, static, geom, tel=None) -> None:
    """``sim_scan``'s contract on CPU tensors, through the host build of
    the same step (``csrc/sim_step.cuh``) with a scalar lookup, telemetry
    included.  For the tests: the port's CPU path is the eager loop."""
    dev = trace.t_issue.device
    if dev.type != "cpu":
        raise ValueError(f"host_replay needs CPU tensors; got {dev}")
    ptrs, dims = pack(trace, params, bank, cnt, static, geom, dev, tel)
    fn = _build.load_host(HOST).sim_replay_host
    fn.argtypes = [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    if fn(ctypes.cast(ptrs, ctypes.c_void_p),
          ctypes.cast(dims, ctypes.c_void_p)) != 0:
        raise RuntimeError("sim_replay_host failed")
