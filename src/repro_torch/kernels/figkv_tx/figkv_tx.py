"""Wrapper of the Hopper ``figkv_tx`` kernel (``csrc/figkv_tx.cu``).

Replaces on the FIGCache-KV path the two launches a decode step made of
the Pallas TPU kernel ``repro/kernels/figaro_reloc/figaro_reloc.py``
(``reloc``: the inserted segment's K and V), together with the tag-store
transaction around them (the JAX package's ``_fts_step``; the port's
``ref.fts_step``).  One launch per step does, for every sequence, the
lookups and touches of the selected ids, the insert of the first live miss
with the policy's eviction, the repaired slot map and both moves; the FTS
leaves and the fast pools are updated in place.  What bounds it: launch
and one chain of dependent round trips per sequence, not the bytes (see
the note in the CUDA source).

``host_tx`` runs the same per-sequence code (``csrc/figkv_tx.cuh``)
built by the host C++ compiler with scalar scans; the CPU tests hold it
against the plain version.

The library is built and loaded at the first launch, never at import, so
this module imports on machines without CUDA or ``nvcc``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import torch

from repro_torch.configs import FIGKVConfig
from repro_torch.core import fts as fts_lib
from repro_torch.kernels import _build

KERNEL = "figkv_tx"
HOST = "figkv_tx_host"
POLICIES = ("row_benefit", "segment_benefit", "lru", "random")
MAX_SEL = 256          # figkv_tx.cu kMaxSel
# the FTS leaves the transaction reads or writes, in the kernel's order
LEAVES = ("tags", "valid", "dirty", "benefit", "last_use", "evict_row",
          "evict_mask", "row_sum", "free_list", "n_valid")
BOOLS = ("valid", "dirty", "evict_mask")
# the ctypes array types of make_args' pointers and dims (built once: a
# new array type costs more than the rest of a launch's packing)
_PTRS = ctypes.c_void_p * (2 + len(LEAVES) + 6)
_DIMS = ctypes.c_longlong * 20


class _Counter:
    """Launches of the kernel in this process (one per successful launch)."""
    launches = 0


COUNTER = _Counter()


def _lib() -> ctypes.CDLL:
    lib = _build.load(KERNEL)
    fn = lib.figkv_tx_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3
        fn.restype = ctypes.c_int
    return lib


def _rows(name, x, b, device):
    if not isinstance(x, torch.Tensor) or x.device != device:
        raise ValueError(f"figkv_tx: {name} must be a tensor on {device}")
    if x.dim() != 3 or x.shape[0] != b:
        raise ValueError(f"figkv_tx: {name} must be (B={b}, rows, E), got "
                         f"{tuple(x.shape)}")
    if x.shape[2] > 1 and x.stride(2) != 1:
        raise ValueError(f"figkv_tx: the rows of {name} must be contiguous")


def pack(sel: torch.Tensor, step: int, n_live: int, fts: fts_lib.FTS,
         pool_k: torch.Tensor, pool_v: torch.Tensor, fast_k: torch.Tensor,
         fast_v: torch.Tensor, fig: FIGKVConfig, device: torch.device):
    """Check every argument and lay out the kernel's: the ``(pointers,
    dims)`` ctypes arrays of ``csrc/figkv_tx.cuh``'s ``make_args`` and the
    three outputs (slots, ins_seg, ins_slot: views of one allocation).

    Raises ``ValueError`` on any other device, dtype, shape or layout, an
    unknown policy, a store whose slots are not whole rows of
    ``segs_per_row``, or more than ``MAX_SEL`` selected ids a row."""
    if fig.policy not in POLICIES:
        raise ValueError(f"figkv_tx: unknown policy {fig.policy!r}")
    if not isinstance(sel, torch.Tensor) or sel.device != device \
            or sel.dtype != torch.int32 or sel.dim() != 2 \
            or not sel.is_contiguous():
        raise ValueError(f"figkv_tx: sel must be a contiguous (B, n_sel) "
                         f"int32 tensor on {device}")
    B, n_sel = sel.shape
    if n_sel > MAX_SEL:
        raise ValueError(f"figkv_tx: {n_sel} selected ids a row; the kernel "
                         f"takes at most {MAX_SEL}")
    S, MS, R = fts.tags.shape[-1], fts.evict_mask.shape[-1], \
        fts.row_sum.shape[-1]
    spr = fig.segs_per_row
    if spr <= 0 or S % spr:
        raise ValueError(f"figkv_tx: {S} slots are not whole rows of "
                         f"{spr} segments")
    shapes = {"evict_row": (B,), "n_valid": (B,), "evict_mask": (B, MS),
              "row_sum": (B, R)}
    ptrs = [sel.data_ptr()]
    for name in LEAVES:
        x = getattr(fts, name)
        want = shapes.get(name, (B, S))
        dt = torch.bool if name in BOOLS else torch.int32
        if not isinstance(x, torch.Tensor) or x.device != device \
                or x.dtype != dt or x.shape != want \
                or not x.is_contiguous():
            raise ValueError(f"figkv_tx: fts.{name} must be a contiguous "
                             f"{dt} tensor of shape {want} on {device}")
        ptrs.append(x.data_ptr())
    pools = (pool_k, pool_v, fast_k, fast_v)
    for name, x in zip(("pool_k", "pool_v", "fast_k", "fast_v"), pools):
        _rows(name, x, B, device)
    n_segs, E = pool_k.shape[1], pool_k.shape[2]
    dt = pool_k.dtype
    if pool_v.shape[1:] != pool_k.shape[1:] or any(
            x.dtype != dt for x in pools) or any(
            x.shape[1:] != (S, E) for x in (fast_k, fast_v)):
        raise ValueError(f"figkv_tx: pools {tuple(pool_k.shape)} / "
                         f"{tuple(pool_v.shape)} and fast pools "
                         f"{tuple(fast_k.shape)} / {tuple(fast_v.shape)} "
                         f"({dt}) do not match {S} slots")
    item = pool_k.element_size()
    out = torch.empty(B * (n_sel + 2), dtype=torch.int32, device=device)
    slots = out[:B * n_sel].view(B, n_sel)
    ins_seg, ins_slot = out[B * n_sel:B * (n_sel + 1)], out[B * (n_sel + 1):]
    ptrs += [x.data_ptr() for x in pools]
    ptrs += [slots.data_ptr(), ins_seg.data_ptr(), ins_slot.data_ptr()]
    dims = [B, n_sel, S, MS, R, n_segs, POLICIES.index(fig.policy), step,
            n_live, (1 << fig.benefit_bits) - 1, spr, E * item]
    for x in pools:
        dims += [x.stride(0) * item, x.stride(1) * item]
    return _PTRS(*ptrs), _DIMS(*dims), (slots, ins_seg, ins_slot)


def figkv_tx(sel: torch.Tensor, step: int, n_live: int, fts: fts_lib.FTS,
             pool_k: torch.Tensor, pool_v: torch.Tensor, fast_k: torch.Tensor,
             fast_v: torch.Tensor, fig: FIGKVConfig
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel: one decode step's transaction for every
    sequence, IN PLACE on ``fts`` (leaves (B, ...)) and on the fast pools,
    bitwise as ``ref.figkv_tx_ref``.

    sel (B, n_sel) int32, distinct ids a row; ``step`` the position (the
    LRU stamp and the Random hash's input); ids below ``n_live`` are
    insertable.  pool_k/pool_v (B, n_segs, E) rows at any sequence and
    segment strides, fast_k/fast_v (B, slots, E), one dtype, contiguous
    rows.  Returns (slots (B, n_sel), ins_seg (B,), ins_slot (B,)) int32.
    Runs on the current stream without synchronising, and raises if the
    launch is refused."""
    dev = sel.device
    if dev.type != "cuda":
        raise ValueError("figkv_tx launches the CUDA kernel and needs CUDA "
                         f"tensors; got {dev}")
    ptrs, dims, out = pack(sel, step, n_live, fts, pool_k, pool_v, fast_k,
                           fast_v, fig, dev)
    if sel.shape[0] == 0:
        return out
    err = _lib().figkv_tx_launch(
        ctypes.cast(ptrs, ctypes.c_void_p), ctypes.cast(dims, ctypes.c_void_p),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"figkv_tx kernel launch failed: CUDA error {err}")
    COUNTER.launches += 1
    return out


def host_library() -> Path:
    """Build (once) the host C++ library of ``csrc/figkv_tx_host.cpp``."""
    return _build.build_host(HOST)


def host_tx(sel, step, n_live, fts, pool_k, pool_v, fast_k, fast_v, fig):
    """``figkv_tx``'s contract on CPU tensors, through the host build of
    the same per-sequence code (``csrc/figkv_tx.cuh``) with scalar scans.
    For the tests: the port's CPU path is the plain version."""
    dev = sel.device
    if dev.type != "cpu":
        raise ValueError(f"host_tx needs CPU tensors; got {dev}")
    ptrs, dims, out = pack(sel, step, n_live, fts, pool_k, pool_v, fast_k,
                           fast_v, fig, dev)
    fn = _build.load_host(HOST).figkv_tx_host
    fn.argtypes = [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    if fn(ctypes.cast(ptrs, ctypes.c_void_p),
          ctypes.cast(dims, ctypes.c_void_p)) != 0:
        raise RuntimeError("figkv_tx_host failed")
    return out
