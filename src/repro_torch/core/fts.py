"""FIGCache Tag Store (FTS), PyTorch port of the fused-step helpers.

Counterpart of ``repro.core.fts``: the paper's §6 policy engine (tag lookup,
insert-any-miss, RowBenefit / SegmentBenefit / LRU / Random replacement)
over a store padded to ``max_slots`` slots, with the *effective* geometry
``n_slots``/``segs_per_row`` arriving as int32 tensors.  Slots with index
``>= n_slots`` are padding: their tags stay -1 and no code path selects
them.

The port carries lanes as a tensor dimension where the JAX package used
``vmap``: every helper here works on a leading lane axis ``(N, ...)`` and
reduces over the last axis, and the simulator's store is laned *and*
banked, ``(N, n_banks, ...)``.  Ported so far is what the fused simulator
step needs; ``lookup`` / ``touch`` / ``should_insert`` / ``insert``, the
recompute oracle and ``invalidate`` are left for a later slice (ROADMAP.md,
Queue 1).  All ops are branch-free selects, so a step never reads a device
value back to the host.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.device import resolve_device

BIG = 1 << 30


class FTS(NamedTuple):
    tags: torch.Tensor      # (..., max_slots) int32 — segment id, -1 invalid
    valid: torch.Tensor     # (..., max_slots) bool
    dirty: torch.Tensor     # (..., max_slots) bool
    benefit: torch.Tensor   # (..., max_slots) int32 — saturating counter
    last_use: torch.Tensor  # (..., max_slots) int32 — step stamp (LRU)
    evict_row: torch.Tensor   # (...,) int32 — row marked for eviction
    evict_mask: torch.Tensor  # (..., max_segs_per_row) bool — bitvector
    miss_tags: torch.Tensor   # (..., n_track) int32 — insertion threshold
    miss_cnt: torch.Tensor    # (..., n_track) int32
    row_sum: torch.Tensor     # (..., max_rows) int32 — per-row benefit sum
    free_list: torch.Tensor   # (..., max_slots) int32 — LIFO free stack
    n_valid: torch.Tensor     # (...,) int32 — valid count == stack pointer


def init(max_slots: int, max_segs_per_row: int, n_track: int = 256,
         device=None) -> FTS:
    """One empty tag store at its padded geometry (no lane or bank axis;
    ``dram.init_state`` broadcasts it to ``(N, n_banks, ...)``)."""
    dev = resolve_device(device)
    i32 = torch.int32
    return FTS(
        tags=torch.full((max_slots,), -1, dtype=i32, device=dev),
        valid=torch.zeros((max_slots,), dtype=torch.bool, device=dev),
        dirty=torch.zeros((max_slots,), dtype=torch.bool, device=dev),
        benefit=torch.zeros((max_slots,), dtype=i32, device=dev),
        last_use=torch.zeros((max_slots,), dtype=i32, device=dev),
        evict_row=torch.tensor(-1, dtype=i32, device=dev),
        evict_mask=torch.zeros((max_segs_per_row,), dtype=torch.bool,
                               device=dev),
        miss_tags=torch.full((n_track,), -1, dtype=i32, device=dev),
        miss_cnt=torch.zeros((n_track,), dtype=i32, device=dev),
        row_sum=torch.zeros((max_slots,), dtype=i32, device=dev),
        free_list=torch.arange(max_slots, dtype=i32, device=dev),
        n_valid=torch.tensor(0, dtype=i32, device=dev),
    )


def masked_argmin(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """First index of the minimum of ``x`` over its last axis, restricted
    to ``mask`` (BIG outside).  An all-False mask gives index 0, like
    ``jnp.argmin``; ``torch.argmin`` also returns the first of equal
    minima."""
    return torch.argmin(torch.where(mask, x, BIG), dim=-1).to(torch.int32)


def pick_victim_row(row_sum: torch.Tensor, evict_row: torch.Tensor,
                    evict_mask: torch.Tensor, segs_per_row, n_slots,
                    new_row=None):
    """RowBenefit, O(max_rows) half: (victim row, refreshed bitvector).

    Lane-batched: ``row_sum (N, max_rows)``, ``evict_row (N,)``,
    ``evict_mask (N, max_segs)``, ``segs_per_row``/``n_slots (N,)``.  When
    a lane's bitvector is exhausted its victim row becomes the live row
    with the lowest ``row_sum`` — or ``new_row``, the candidate the fused
    lookup already computed, in which case ``row_sum`` is not read — and
    the bitvector is refreshed to the full row."""
    spr = segs_per_row
    max_segs = evict_mask.shape[-1]
    need_new = (evict_row < 0) | ~evict_mask.any(dim=-1)
    if new_row is None:
        rows = torch.arange(row_sum.shape[-1], dtype=torch.int32,
                            device=row_sum.device)
        new_row = masked_argmin(row_sum,
                                rows * spr[..., None] < n_slots[..., None])
    row = torch.where(need_new, new_row, evict_row)
    fresh = torch.arange(max_segs, dtype=torch.int32,
                         device=evict_mask.device) < spr[..., None]
    mask = torch.where(need_new[..., None], fresh, evict_mask)
    return row, mask


def pick_victim_in_row(benefit_row: torch.Tensor, mask: torch.Tensor,
                       row: torch.Tensor, segs_per_row):
    """RowBenefit, O(max_segs_per_row) half: the lowest-benefit marked slot
    of each lane's victim row.  ``benefit_row (N, max_segs)`` is the gather
    of ``benefit`` at ``row * segs_per_row + j``; returns (slot, mask with
    the chosen bit cleared)."""
    spr = segs_per_row
    j = torch.arange(mask.shape[-1], dtype=torch.int32, device=mask.device)
    jj = masked_argmin(benefit_row, (j < spr[..., None]) & mask)
    return row * spr + jj, mask & (j != jj[..., None])


def random_victim(step: torch.Tensor, n_slots) -> torch.Tensor:
    """O(1) LCG-hashed victim slot for the Random policy.

    The JAX package multiplies in int32 and relies on wraparound; the low
    31 bits of the exact int64 product are the same bits, so the port
    computes in int64 and masks (the same form a CUDA kernel must use,
    where signed overflow is undefined)."""
    h = (step.to(torch.int64) * 1103515245 + 12345) & 0x7FFFFFFF
    return torch.remainder(h, n_slots.to(torch.int64)).to(torch.int32)


class SlotWrite(NamedTuple):
    """The per-(bank, slot) FTS write-back of one simulator step: exactly
    one slot ``w`` per lane is written, and every value equals the old one
    when the step changed nothing.  Leaves are ``(N,)``, except
    ``evict_mask (N, max_segs_per_row)``."""
    w: torch.Tensor          # slot written (hit slot or insertion landing)
    tag: torch.Tensor
    valid: torch.Tensor
    dirty: torch.Tensor
    benefit: torch.Tensor
    last_use: torch.Tensor
    row_delta: torch.Tensor  # row_sum increment at w // segs_per_row
    evict_row: torch.Tensor
    evict_mask: torch.Tensor
    tr_idx: torch.Tensor     # miss-tracker index touched
    miss_tag: torch.Tensor
    miss_cnt: torch.Tensor
    n_valid_inc: torch.Tensor


def apply_write(fts: FTS, bank: torch.Tensor, segs_per_row,
                wr: SlotWrite, lanes: torch.Tensor) -> FTS:
    """Apply one step's ``SlotWrite`` to a laned, banked store (leaves
    ``(N, n_banks, ...)``), IN PLACE: lane ``lanes[i]`` writes one slot of
    its bank ``bank[i]``, so every scatter index is distinct and the result
    is deterministic.  Returns ``fts`` for symmetry with the JAX API."""
    b = bank.long()
    w = wr.w.long()
    fts.tags[lanes, b, w] = wr.tag
    fts.valid[lanes, b, w] = wr.valid
    fts.dirty[lanes, b, w] = wr.dirty
    fts.benefit[lanes, b, w] = wr.benefit
    fts.last_use[lanes, b, w] = wr.last_use
    r = torch.div(wr.w, segs_per_row, rounding_mode="floor").long()
    fts.row_sum[lanes, b, r] += wr.row_delta
    fts.evict_row[lanes, b] = wr.evict_row
    fts.evict_mask[lanes, b] = wr.evict_mask
    t = wr.tr_idx.long()
    fts.miss_tags[lanes, b, t] = wr.miss_tag
    fts.miss_cnt[lanes, b, t] = wr.miss_cnt
    fts.n_valid[lanes, b] += wr.n_valid_inc
    return fts
