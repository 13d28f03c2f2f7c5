"""Plain PyTorch version of the ``figkv_tx`` kernel (bit-exact): the
FIGCache-KV tag-store transaction of one decode step, the repair of its
slot map, and the moves of the inserted segment's K and V rows.  The CPU
path of ``ops.figkv_tx`` and the oracle the CUDA kernel is held against on
the card."""
from __future__ import annotations

import torch

from repro_torch.configs import FIGKVConfig
from repro_torch.core import fts as fts_lib
from repro_torch.kernels.figaro_reloc.ref import reloc_ref


def fts_step(fts: fts_lib.FTS, segs: torch.Tensor, step: torch.Tensor,
             fig: FIGKVConfig, n_live: int):
    """Per-sequence FTS transaction for the selected segments ``segs (B,
    n_sel)``: touch hits; insert the best-scoring live miss (RowBenefit
    eviction).  Returns (fts, slot_per_seg, inserted_seg, inserted_slot),
    new leaves, as the JAX package's ``_fts_step`` (slot map unrepaired).

    Only ids below ``n_live`` (complete segments) are inserted.  The
    selection pads with dead ids when fewer than ``n_sel`` segments are
    complete; the JAX package inserts those too (the active segment, or
    one not written yet), and their copies never refresh.

    The n_sel touches of a sequence are one vectorised update: top-k ids
    are distinct, and so are their slots."""
    hits, slots = fts_lib.lookup(fts, segs)
    fts = fts_lib.touch(fts, slots, False, step, (1 << fig.benefit_bits) - 1,
                        fig.segs_per_row, count=hits.to(torch.int32))
    # insert-any-miss: the top-scoring live miss is relocated this step
    miss = ~hits & (segs < n_live)
    miss_order = torch.argmax(miss.to(torch.int32), dim=1)
    any_miss = miss.any(dim=1)
    ins_seg = torch.where(any_miss, segs.gather(1, miss_order[:, None])[:, 0],
                          -1)
    res = fts_lib.insert(fts, ins_seg, False, step, policy=fig.policy,
                         segs_per_row=fig.segs_per_row)
    fts = fts_lib.select(any_miss, res.fts, fts)
    ins_slot = torch.where(any_miss, res.slot, -1)
    slots = torch.where(segs == ins_seg[:, None], ins_slot[:, None],
                        torch.where(hits, slots, -1))
    return fts, slots, ins_seg, ins_slot


def repair_slots(slots: torch.Tensor, segs: torch.Tensor,
                 ins_seg: torch.Tensor, ins_slot: torch.Tensor
                 ) -> torch.Tensor:
    """The slot map with every hit whose slot the same step's insert took
    sent to the slow pool (-1): that slot now holds the inserted segment,
    and the slow pool always holds the hit segment's exact K/V.  The JAX
    package keeps the hit's slot and reads the inserted segment's K/V in
    its place."""
    taken = (slots == ins_slot[:, None]) & (segs != ins_seg[:, None])
    return torch.where(taken, -1, slots)


def figkv_tx_ref(sel: torch.Tensor, step: int, n_live: int,
                 fts: fts_lib.FTS, pool_k: torch.Tensor, pool_v: torch.Tensor,
                 fast_k: torch.Tensor, fast_v: torch.Tensor, fig: FIGKVConfig):
    """One decode step's transaction, IN PLACE on the FTS leaves and the
    fast pools: ``fts_step``, the repaired slot map, then the inserted
    segment's K and V rows moved by ``reloc_ref``.

    sel (B, n_sel) int32; pools (B, n_segs, E) and fast pools (B, slots, E)
    rows.  Returns (slots (B, n_sel), ins_seg (B,), ins_slot (B,)) int32."""
    steps = torch.full((sel.shape[0],), step, dtype=torch.int32,
                       device=sel.device)
    new, slots, ins_seg, ins_slot = fts_step(fts, sel, steps, fig, n_live)
    slots = repair_slots(slots, sel, ins_seg, ins_slot)
    for old, x in zip(fts, new):
        if x is not old:
            old.copy_(x)
    src, dst = ins_seg[:, None], ins_slot[:, None]
    reloc_ref(pool_k, fast_k, src, dst)
    reloc_ref(pool_v, fast_v, src, dst)
    return slots, ins_seg, ins_slot
