"""Wrapper of the Hopper ``figaro_reloc`` kernel (``csrc/figaro_reloc.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/figaro_reloc/figaro_reloc.py``
(``reloc``).  One launch carries every move of a batch of groups, one
thread block per move, and writes the fast pool in place.  It is a byte
mover bound by launch latency, not by the bytes it moves (see the note in
the CUDA source).

The library is built and loaded at the first launch, never at import, so
this module imports on machines without CUDA or ``nvcc``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

KERNEL = "figaro_reloc"


class _Counter:
    """Launches of the kernel in this process (one per successful launch)."""
    launches = 0


COUNTER = _Counter()


def _lib() -> ctypes.CDLL:
    lib = _build.load(KERNEL)
    fn = lib.figaro_reloc_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + \
            [ctypes.c_longlong] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check_rows(name, x, device):
    if not isinstance(x, torch.Tensor) or x.device != device:
        raise ValueError(f"figaro_reloc: {name} must be a tensor on {device}")
    if x.dim() != 3:
        raise ValueError(f"figaro_reloc: {name} must be (groups, rows, E), "
                         f"got {tuple(x.shape)}")
    if x.shape[2] > 1 and x.stride(2) != 1:
        raise ValueError(f"figaro_reloc: the rows of {name} must be "
                         "contiguous")


def reloc(pool: torch.Tensor, fast: torch.Tensor, src: torch.Tensor,
          dst: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel: ``fast[g, dst[g, m]] <- pool[g, src[g, m]]``.

    pool (G, n_segs, E) and fast (G, n_slots, E) of one dtype, any group
    and row strides, contiguous rows; src/dst (G, M) int32, contiguous, on
    the same CUDA device.  A move with a negative (or out-of-range) src or
    dst is a no-op.  The destinations of the moves that run must be
    distinct.  Writes ``fast`` in place and returns it; runs on the current
    stream without synchronising, and raises if the launch is refused."""
    if fast.device.type != "cuda":
        raise ValueError("figaro_reloc launches the CUDA kernel and needs "
                         f"CUDA tensors; got {fast.device}")
    dev = fast.device
    _check_rows("pool", pool, dev)
    _check_rows("fast", fast, dev)
    if pool.dtype != fast.dtype:
        raise ValueError(f"figaro_reloc: pool is {pool.dtype} but fast is "
                         f"{fast.dtype}")
    g, n_segs, e = pool.shape
    if fast.shape[0] != g or fast.shape[2] != e:
        raise ValueError(f"figaro_reloc: fast {tuple(fast.shape)} does not "
                         f"match pool {tuple(pool.shape)}")
    for name, x in (("src", src), ("dst", dst)):
        if (x.device != dev or x.dtype != torch.int32 or x.dim() != 2
                or x.shape[0] != g or not x.is_contiguous()):
            raise ValueError(f"figaro_reloc: {name} must be a contiguous "
                             f"(G={g}, M) int32 tensor on {dev}")
    if src.shape != dst.shape:
        raise ValueError("figaro_reloc: src and dst differ in shape")
    m = src.shape[1]
    if g * m == 0 or e == 0:
        return fast
    item = pool.element_size()
    err = _lib().figaro_reloc_launch(
        pool.data_ptr(), fast.data_ptr(), src.data_ptr(), dst.data_ptr(),
        g, m, n_segs, fast.shape[1], pool.stride(0) * item,
        pool.stride(1) * item, fast.stride(0) * item, fast.stride(1) * item,
        e * item, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"figaro_reloc kernel launch failed: CUDA error "
                           f"{err}")
    COUNTER.launches += 1
    return fast
