"""FIGARO substrate — the data-plane relocation ops (paper §4), PyTorch port
of ``repro.core.figaro``.

In DRAM, RELOC moves one column between the local row buffers of two
subarrays through the shared global row buffer, with unaligned src/dst
column addressing and distance-independent latency.  On the GPU the
analogue is a fine-grained segment move between a large slow region and a
small contiguous fast pool.  ``reloc_in`` and ``reloc_out`` go through
``kernels/figaro_reloc`` (the CUDA kernel on a CUDA device, its plain
version on the CPU) and, unlike the JAX package's pure functions, write
their destination IN PLACE and return it.

Layout convention:
  slow:  (n_rows, segs_per_row, seg_elems, ...feat)  — the full data
  fast:  (fast_rows, segs_per_row, seg_elems, ...feat) — the cache region
A *segment id* linearizes (row, seg) as ``row * segs_per_row + seg``; a
*slot* linearizes the fast pool the same way.  A negative id masks its
move; the destinations of the moves that run must be distinct.
"""
from __future__ import annotations

import torch

from repro_torch.core.timing import DDR4
from repro_torch.kernels.figaro_reloc.ops import reloc_segments


def _flatten_segs(x: torch.Tensor) -> torch.Tensor:
    """(rows, spr, seg, ...) -> (rows*spr, seg, ...), a view."""
    return x.view((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))


def reloc_in(slow: torch.Tensor, fast: torch.Tensor, seg_ids: torch.Tensor,
             slots: torch.Tensor) -> torch.Tensor:
    """Relocate segments slow[seg_ids] -> fast[slots] (cache fill), in
    place on ``fast``; seg_ids/slots (n,) int32."""
    reloc_segments(_flatten_segs(slow), _flatten_segs(fast), seg_ids, slots)
    return fast


def reloc_out(slow: torch.Tensor, fast: torch.Tensor, slots: torch.Tensor,
              seg_ids: torch.Tensor) -> torch.Tensor:
    """Write back segments fast[slots] -> slow[seg_ids] (dirty eviction),
    in place on ``slow``: the fast pool is the source."""
    reloc_segments(_flatten_segs(fast), _flatten_segs(slow), slots, seg_ids)
    return slow


def gather_segments(slow: torch.Tensor, seg_ids: torch.Tensor
                    ) -> torch.Tensor:
    """Read segments at block granularity (the READ path through the GRB);
    ids are clipped to the pool, as the JAX package's gather."""
    sflat = _flatten_segs(slow)
    return sflat[seg_ids.clamp(0, sflat.shape[0] - 1).long()]


def reloc_cost_ns(n_segments, seg_blocks: int, timings=None):
    """Model cost of relocating n segments with an already-open source row
    (§8.1: the first ACTIVATE is elided on the miss path): seg_blocks
    RELOCs + destination ACTIVATE."""
    t = timings or DDR4
    return n_segments * (seg_blocks * t.tRELOC + t.tRCD)
