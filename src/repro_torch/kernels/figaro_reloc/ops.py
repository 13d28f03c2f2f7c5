"""Dispatch of FIGARO RELOC over model-shaped tensors: CUDA kernel or plain
PyTorch version.

The choice follows the tensors alone: a CPU tensor goes to the plain
version (``ref.py``), a CUDA tensor launches the kernel
(``figaro_reloc.py``) or raises.  There is no fallback from the kernel to
the plain version.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.figaro_reloc.figaro_reloc import reloc
from repro_torch.kernels.figaro_reloc.ref import reloc_ref


def segment_rows(pool: torch.Tensor, fast: torch.Tensor,
                 src_segs: torch.Tensor, dst_slots: torch.Tensor):
    """Views of the arguments of ``reloc_segments`` in the kernel's layout:
    pool (G, n_segs, E), fast (G, n_slots, E), ids (G, M) int32.

    Never copies ``pool`` or ``fast``: a payload that cannot be seen as
    rows of E elements raises.  The pool's group and segment strides stay
    free, so a slice of a longer buffer works as it is."""
    batched = src_segs.dim() == 2
    if src_segs.dim() not in (1, 2) or dst_slots.shape != src_segs.shape:
        raise ValueError("reloc_segments: src_segs and dst_slots must share "
                         "a (n_moves,) or (G, n_moves) shape")
    if not batched:
        pool, fast = pool[None], fast[None]
    g = pool.shape[0]
    e = math.prod(pool.shape[2:])
    if tuple(fast.shape[2:]) != tuple(pool.shape[2:]):
        raise ValueError(f"reloc_segments: segments of pool {tuple(pool.shape)}"
                         f" and fast {tuple(fast.shape)} differ")
    ids = [x.to(torch.int32).reshape(g, -1).contiguous()
           for x in (src_segs, dst_slots)]
    return (pool.view(g, pool.shape[1], e), fast.view(g, fast.shape[1], e),
            *ids)


def reloc_segments(pool: torch.Tensor, fast: torch.Tensor,
                   src_segs: torch.Tensor, dst_slots: torch.Tensor
                   ) -> torch.Tensor:
    """``fast[dst_slots[i]] <- pool[src_segs[i]]``, in place on ``fast``.

    pool (n_segs, *seg_shape), fast (n_slots, *seg_shape), ids (n_moves,)
    int32, as the JAX package's ``reloc_segments``; or, batched over
    groups, pool (G, n_segs, *seg_shape), fast (G, n_slots, *seg_shape),
    ids (G, n_moves).  A negative id masks the move.  The destinations of
    the moves that run must be distinct.  Returns ``fast``."""
    args = segment_rows(pool, fast, src_segs, dst_slots)
    if fast.device.type == "cpu":
        reloc_ref(*args)
    else:
        reloc(*args)
    return fast
