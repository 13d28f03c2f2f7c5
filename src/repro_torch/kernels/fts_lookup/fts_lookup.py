"""Wrapper of the Hopper ``fts_lookup`` kernel (``csrc/fts_lookup.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/fts_lookup/fts_lookup.py``
(``fts_lookup``).  The kernel is batched over simulator lanes: one launch
answers every lane's bank row.  It is bound by launch latency, not by the
2 * N * S * 4 bytes it reads (see the note in the CUDA source).

The library is built and loaded at the first launch, never at import, so
this module imports on machines without CUDA or ``nvcc``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

KERNEL = "fts_lookup"


class _Counter:
    """Launches of the kernel in this process (one per successful launch)."""
    launches = 0


COUNTER = _Counter()


def _lib() -> ctypes.CDLL:
    lib = _build.load(KERNEL)
    fn = lib.fts_lookup_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check(name, x, shape, device):
    if not isinstance(x, torch.Tensor) or x.device != device:
        raise ValueError(f"fts_lookup: {name} must be a tensor on {device}")
    if x.dtype != torch.int32:
        raise ValueError(f"fts_lookup: {name} must be int32, got {x.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"fts_lookup: {name} has shape {tuple(x.shape)}, "
                         f"expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"fts_lookup: {name} must be contiguous")


def fts_lookup(tags: torch.Tensor, score: torch.Tensor, bank: torch.Tensor,
               seg: torch.Tensor, limit: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel: tags/score (N, n_banks, S) int32, bank/seg/
    limit (N,) int32, all contiguous on one CUDA device -> (N, 3) int32
    ``[hit, hit_slot, victim_cand]`` (contract of ``ref.fts_lookup_ref``).

    Runs on the current stream without synchronising; raises if the launch
    is refused."""
    if tags.device.type != "cuda":
        raise ValueError("fts_lookup launches the CUDA kernel and needs CUDA "
                         f"tensors; got {tags.device}")
    if tags.dim() != 3:
        raise ValueError(f"fts_lookup: tags must be (N, n_banks, S), got "
                         f"{tuple(tags.shape)}")
    n, n_banks, s = tags.shape
    dev = tags.device
    _check("tags", tags, (n, n_banks, s), dev)
    _check("score", score, (n, n_banks, s), dev)
    for name, x in (("bank", bank), ("seg", seg), ("limit", limit)):
        _check(name, x, (n,), dev)
    out = torch.empty((n, 3), dtype=torch.int32, device=dev)
    launch = _lib().fts_lookup_launch
    args = (tags.data_ptr(), score.data_ptr(), bank.data_ptr(),
            seg.data_ptr(), limit.data_ptr(), out.data_ptr(), n, n_banks, s,
            torch.cuda.current_stream(dev).cuda_stream)
    err = launch(*args)
    if err != 0:
        raise RuntimeError(f"fts_lookup kernel launch failed: CUDA error "
                           f"{err}")
    COUNTER.launches += 1
    return out
