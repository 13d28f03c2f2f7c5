"""FIGCache Tag Store (FTS), PyTorch port of the fused-step helpers.

Counterpart of ``repro.core.fts``: the paper's §6 policy engine (tag lookup,
insert-any-miss, RowBenefit / SegmentBenefit / LRU / Random replacement)
over a store padded to ``max_slots`` slots, with the *effective* geometry
``n_slots``/``segs_per_row`` arriving as int32 tensors.  Slots with index
``>= n_slots`` are padding: their tags stay -1 and no code path selects
them.

The port carries lanes as a tensor dimension where the JAX package used
``vmap``: every helper here works on a leading lane axis ``(N, ...)`` and
reduces over the last axis.  The simulator's store is laned *and* banked,
``(N, n_banks, ...)``, and only uses the fused-step helpers
(``pick_victim_*``, ``random_victim``, ``apply_write``).  The transaction
API — ``lookup`` / ``touch`` / ``should_insert`` / ``insert`` (with the
``recompute=True`` oracle) / ``invalidate`` — takes one store per lane,
leaves ``(N, max_slots)``, as FIGCache-KV keeps one per sequence.  It is
functional like the JAX package's: each call returns new leaves and leaves
its input alone.  ``segs_per_row`` / ``n_slots`` / ``step`` may be Python
ints or ``(N,)`` int32 tensors.  All ops are branch-free selects, so no
call reads a device value back to the host.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.obs import trace as obs_trace

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
    ``dram.init_state`` broadcasts it to ``(N, n_banks, ...)``).  Its two
    scalars are copies from the host, counted as ``h2d_copies`` /
    ``h2d_bytes``."""
    dev = resolve_device(device)
    i32 = torch.int32
    fts = FTS(
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
    obs_trace.count(h2d_copies=2,
                    h2d_bytes=fts.evict_row.nbytes + fts.n_valid.nbytes)
    return fts


def init_lanes(lanes: int, max_slots: int, max_segs_per_row: int,
               n_track: int = 256, device=None) -> FTS:
    """``lanes`` independent empty stores, leaves ``(lanes, ...)``."""
    one = init(max_slots, max_segs_per_row, n_track, device=device)
    return FTS(*[a.expand((lanes,) + tuple(a.shape)).clone() for a in one])


def select(mask: torch.Tensor, a: FTS, b: FTS) -> FTS:
    """Per lane: ``a`` where ``mask (N,)`` is set, else ``b``."""
    return FTS(*[torch.where(mask.view((-1,) + (1,) * (x.dim() - 1)), x, y)
                 for x, y in zip(a, b)])


def _lanes(x, n: int, device, dtype=torch.int32) -> torch.Tensor:
    """A Python scalar or a tensor as an ``(n,)`` lane vector.  Scalars are
    filled on the device (``torch.full``), never copied from the host."""
    if isinstance(x, torch.Tensor):
        x = x.to(device=device, dtype=dtype)
        return x.expand(n) if x.dim() == 0 else x
    return torch.full((n,), x, dtype=dtype, device=device)


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``a[i, idx[i]]`` for each lane i of an ``(N, S)`` leaf."""
    return a.gather(1, idx.long()[:, None])[:, 0]


def _put(a: torch.Tensor, idx: torch.Tensor, val) -> torch.Tensor:
    """A copy of ``a (N, S)`` with ``a[i, idx[i]] = val[i]``."""
    val = _lanes(val, a.shape[0], a.device, a.dtype)
    return a.clone().scatter_(1, idx.long()[:, None], val[:, None])


def _add(a: torch.Tensor, idx: torch.Tensor, val: torch.Tensor):
    """A copy of ``a (N, S)`` with ``a[i, idx[i]] += val[i]`` (int32)."""
    return a.clone().scatter_add_(1, idx.long()[:, None],
                                  val.to(a.dtype)[:, None])


def _floordiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


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


# ---------------------------------------------------------------------------
# transaction API: one store per lane, leaves (N, max_slots)

def lookup(fts: FTS, seg: torch.Tensor):
    """-> (hit: bool, slot: int32), both shaped like ``seg``: ``(N,)`` for
    one id per lane or ``(N, K)`` for K ids per lane.  ``slot`` is the
    first matching slot (0 on a miss, as ``jnp.argmax`` of all False).
    Padding never matches: its tags stay -1 and its valid bits False."""
    view = (seg.shape[0],) + (1,) * (seg.dim() - 1) + (-1,)
    m = (fts.tags.view(view) == seg[..., None]) & fts.valid.view(view)
    return m.any(dim=-1), torch.argmax(m.to(torch.int32), dim=-1).to(
        torch.int32)


def touch(fts: FTS, slot: torch.Tensor, is_write, step, benefit_max,
          segs_per_row, count: Optional[torch.Tensor] = None) -> FTS:
    """Cache hits: saturating benefit increment, dirty on writes, LRU stamp.

    ``slot`` is ``(N,)`` or ``(N, K)``; ``count`` (same shape, default 1)
    is how many hits each entry stands for, 0 for none.  Entries may repeat
    a slot: a slot's hits add up, and ``k`` hits on benefit ``b0`` give
    ``min(b0 + k, benefit_max)`` — what ``k`` one-by-one touches of the JAX
    package give, in any order, since they share ``step``.  ``is_write``
    (bool, broadcast to ``slot``) sets the dirty bit of a hit entry."""
    n, s = fts.benefit.shape
    dev = fts.benefit.device
    idx = slot.reshape(n, -1).long()
    cnt = torch.ones_like(idx, dtype=torch.int32) if count is None else \
        count.reshape(n, -1).to(torch.int32)
    total = torch.zeros((n, s), dtype=torch.int32, device=dev).scatter_add_(
        1, idx, cnt)
    hit = total > 0
    if not isinstance(is_write, torch.Tensor):
        is_write = torch.full((), bool(is_write), device=dev)
    wr = is_write.expand(slot.shape).reshape(n, -1) & (cnt > 0)
    writes = torch.zeros((n, s), dtype=torch.int32, device=dev).scatter_add_(
        1, idx, wr.to(torch.int32)) > 0
    bmax = _lanes(benefit_max, n, dev)[:, None]
    b = torch.where(hit, torch.minimum(fts.benefit + total, bmax),
                    fts.benefit)
    spr = _lanes(segs_per_row, n, dev)
    rows = _floordiv(torch.arange(s, dtype=torch.int32, device=dev)[None],
                     spr[:, None])
    return fts._replace(
        benefit=b,
        dirty=fts.dirty | writes,
        last_use=torch.where(hit, _lanes(step, n, dev)[:, None],
                             fts.last_use),
        row_sum=fts.row_sum.clone().scatter_add_(1, rows.long(),
                                                 b - fts.benefit),
    )


def should_insert(fts: FTS, seg: torch.Tensor, threshold):
    """Insertion policy: advance the consecutive-miss tracker for ``seg
    (N,)`` and return ``(threshold <= 1 or count >= threshold, fts)``.
    Call it on actual misses only."""
    n = fts.miss_tags.shape[-1]
    idx = torch.remainder(seg, n)
    cnt = torch.where(_take(fts.miss_tags, idx) == seg,
                      _take(fts.miss_cnt, idx) + 1, 1)
    fts = fts._replace(miss_tags=_put(fts.miss_tags, idx, seg),
                       miss_cnt=_put(fts.miss_cnt, idx, cnt))
    thr = _lanes(threshold, seg.shape[0], seg.device)
    return (thr <= 1) | (cnt >= thr), fts


def gather_row(benefit: torch.Tensor, row: torch.Tensor, max_segs: int,
               segs_per_row) -> torch.Tensor:
    """``(N, max_segs)`` gather of each lane's cache row ``row (N,)`` of
    benefit counters (indices clipped to the store, as JAX's gather)."""
    n, s = benefit.shape
    spr = _lanes(segs_per_row, n, benefit.device)
    idx = (row * spr)[:, None] + torch.arange(max_segs, dtype=torch.int32,
                                              device=benefit.device)
    return benefit.gather(1, idx.clamp(0, s - 1).long())


def _pick_victim_row_benefit(fts: FTS, segs_per_row, n_slots):
    """RowBenefit from the carried aggregates: argmin over ``row_sum``,
    then over the one gathered row.  ``n_slots`` must be a multiple of
    ``segs_per_row``."""
    row, mask = pick_victim_row(fts.row_sum, fts.evict_row, fts.evict_mask,
                                segs_per_row, n_slots)
    benefit_row = gather_row(fts.benefit, row, fts.evict_mask.shape[-1],
                             segs_per_row)
    slot, mask = pick_victim_in_row(benefit_row, mask, row, segs_per_row)
    return slot, fts._replace(evict_row=row, evict_mask=mask)


def _pick_victim_row_benefit_recompute(fts: FTS, segs_per_row, n_slots):
    """The recompute oracle of RowBenefit: re-derive the per-row sums from
    ``benefit`` with segment sums over ``max_slots`` on every call."""
    n, s = fts.benefit.shape
    dev = fts.benefit.device
    max_segs = fts.evict_mask.shape[-1]
    idx = torch.arange(s, dtype=torch.int32, device=dev)[None]
    active = idx < n_slots[:, None]
    row_of = _floordiv(idx, segs_per_row[:, None])
    seg_of = idx - row_of * segs_per_row[:, None]
    need_new = (fts.evict_row < 0) | ~fts.evict_mask.any(dim=-1)
    zeros = torch.zeros((n, s), dtype=torch.int32, device=dev)
    row_sum = zeros.clone().scatter_add_(
        1, row_of.long(), torch.where(active, fts.benefit, 0))
    row_live = zeros.scatter_add_(1, row_of.long(),
                                  active.to(torch.int32)) > 0
    new_row = masked_argmin(row_sum, row_live)
    row = torch.where(need_new, new_row, fts.evict_row)
    fresh = torch.arange(max_segs, dtype=torch.int32,
                         device=dev)[None] < segs_per_row[:, None]
    mask = torch.where(need_new[:, None], fresh, fts.evict_mask)
    in_row = active & (row_of == row[:, None]) & mask.gather(
        1, seg_of.clamp(0, max_segs - 1).long())
    slot = masked_argmin(fts.benefit, in_row)
    mask = _put(mask, torch.remainder(slot, segs_per_row), False)
    return slot, fts._replace(evict_row=row, evict_mask=mask)


def _pick_victim(fts: FTS, policy: str, segs_per_row, n_slots, step,
                 recompute: bool = False):
    """(victim slot (N,), fts with the RowBenefit bitvector advanced).
    ``segs_per_row`` / ``n_slots`` / ``step`` are ``(N,)`` int32."""
    if policy == "row_benefit":
        if recompute:
            return _pick_victim_row_benefit_recompute(fts, segs_per_row,
                                                      n_slots)
        return _pick_victim_row_benefit(fts, segs_per_row, n_slots)
    idx = torch.arange(fts.tags.shape[-1], dtype=torch.int32,
                       device=fts.tags.device)
    active = idx[None] < n_slots[:, None]
    if policy == "segment_benefit":
        return masked_argmin(fts.benefit, active), fts
    if policy == "lru":
        return masked_argmin(fts.last_use, active), fts
    if policy == "random":
        return random_victim(step, n_slots), fts
    raise ValueError(f"unknown replacement policy {policy!r}")


class InsertResult(NamedTuple):
    fts: FTS
    slot: torch.Tensor           # (N,) where the new segment landed
    evicted_valid: torch.Tensor  # (N,) a valid entry was displaced
    evicted_dirty: torch.Tensor  # (N,) ... and it was dirty
    evicted_tag: torch.Tensor    # (N,) its segment id


def insert(fts: FTS, seg: torch.Tensor, is_write, step, *, policy: str,
           segs_per_row, n_slots=None, benefit_init: int = 1,
           recompute: bool = False) -> InsertResult:
    """Insert ``seg (N,)`` (on a miss): the free-stack top if the store has
    a free slot, else the policy's victim.

    ``n_slots=None`` means all slots are active.  ``recompute=True``
    re-derives every decision from the base arrays (full free-slot argmin,
    segment-summed row benefits) and reorders the free stack so that the
    chosen slot is the one popped — the oracle of the O(1) path, equal to
    it while the free set is a suffix of the slot range."""
    n, s = fts.tags.shape
    dev = fts.tags.device
    n_act = _lanes(s if n_slots is None else n_slots, n, dev)
    spr = _lanes(segs_per_row, n, dev)
    step = _lanes(step, n, dev)
    free_list = fts.free_list
    top = fts.n_valid.clamp(max=s - 1)
    if recompute:
        idx = torch.arange(s, dtype=torch.int32, device=dev)[None]
        active = idx < n_act[:, None]
        has_free = (active & ~fts.valid).any(dim=-1)
        # padding reads as occupied, so the argmin lands on an active slot
        free_slot = torch.argmin(torch.where(active, fts.valid, True).to(
            torch.int32), dim=-1).to(torch.int32)
        pos = masked_argmin(idx.expand(n, s),
                            (free_list == free_slot[:, None])
                            & (idx >= top[:, None]))
        old_top = _take(free_list, top)
        free_list = _put(free_list, top,
                         torch.where(has_free, free_slot, old_top))
        free_list = _put(free_list, pos, torch.where(
            has_free, old_top, _take(free_list, pos)))
    else:
        has_free = fts.n_valid < n_act
        free_slot = _take(free_list, top)
    victim_slot, fts_v = _pick_victim(fts, policy, spr, n_act, step,
                                      recompute=recompute)
    # with a free slot the eviction bitvector is not consumed
    evict_row = torch.where(has_free, fts.evict_row, fts_v.evict_row)
    evict_mask = torch.where(has_free[:, None], fts.evict_mask,
                             fts_v.evict_mask)
    slot = torch.where(has_free, free_slot, victim_slot)
    ev_valid = _take(fts.valid, slot) & ~has_free
    ev_dirty = ev_valid & _take(fts.dirty, slot)
    ev_tag = _take(fts.tags, slot)
    b0 = _take(fts.benefit, slot)
    fts = fts._replace(
        tags=_put(fts.tags, slot, seg),
        valid=_put(fts.valid, slot, True),
        dirty=_put(fts.dirty, slot, _lanes(is_write, n, dev, torch.bool)),
        benefit=_put(fts.benefit, slot, benefit_init),
        last_use=_put(fts.last_use, slot, step),
        evict_row=evict_row,
        evict_mask=evict_mask,
        row_sum=_add(fts.row_sum, _floordiv(slot, spr), benefit_init - b0),
        free_list=free_list,
        n_valid=fts.n_valid + has_free.to(torch.int32),
    )
    return InsertResult(fts, slot, ev_valid, ev_dirty, ev_tag)


def invalidate(fts: FTS, slot: torch.Tensor, segs_per_row) -> FTS:
    """Drop entry ``slot (N,)`` of each lane: clear its bits, return its
    benefit to ``row_sum``, reset its tag to -1 and push it on the free
    stack.  A no-op (bitwise) on a slot that is already invalid."""
    n = slot.shape[0]
    spr = _lanes(segs_per_row, n, slot.device)
    was = _take(fts.valid, slot)
    pos = (fts.n_valid - 1).clamp(min=0)
    return fts._replace(
        tags=_put(fts.tags, slot, torch.where(was, -1,
                                              _take(fts.tags, slot))),
        valid=_put(fts.valid, slot, False),
        dirty=_put(fts.dirty, slot, False),
        benefit=_put(fts.benefit, slot, 0),
        row_sum=_add(fts.row_sum, _floordiv(slot, spr),
                     -torch.where(was, _take(fts.benefit, slot), 0)),
        free_list=_put(fts.free_list, pos, torch.where(
            was, slot, _take(fts.free_list, pos))),
        n_valid=fts.n_valid - was.to(torch.int32),
    )


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
