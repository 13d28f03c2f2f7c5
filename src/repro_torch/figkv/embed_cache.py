"""FIGCache for embedding-table gathers (FIGCache-Slow analogue), PyTorch
port of ``repro.figkv.embed_cache``.

Hot vocabulary *segments* (``seg_tokens`` consecutive rows) are kept in a
small contiguous fast table managed by the same FTS + insert-any-miss +
RowBenefit machinery; a lookup serves hits from the fast table and inserts
the first missed segment, relocated by ``kernels/figaro_reloc``.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.configs import FIGKVConfig
from repro_torch.core import fts as fts_lib
from repro_torch.device import resolve_device
from repro_torch.kernels.figaro_reloc.ops import reloc_segments

TOUCH_BOUND = 64   # hits per lookup that touch the store (a bounded unroll)


class EmbedCache(NamedTuple):
    fast: torch.Tensor     # (slots, seg_rows, d) hot vocabulary segments
    fts: fts_lib.FTS       # one store: leaves (1, ...)
    hits: torch.Tensor     # () int32 — telemetry
    lookups: torch.Tensor  # () int32


def embed_cache_init(d: int, fig: FIGKVConfig, dtype=torch.bfloat16,
                     device=None) -> EmbedCache:
    dev = resolve_device(device)
    slots = fig.fast_rows * fig.segs_per_row
    return EmbedCache(
        fast=torch.zeros((slots, fig.seg_tokens, d), dtype=dtype, device=dev),
        fts=fts_lib.init_lanes(1, slots, fig.segs_per_row, device=dev),
        hits=torch.zeros((), dtype=torch.int32, device=dev),
        lookups=torch.zeros((), dtype=torch.int32, device=dev))


def embed_cache_lookup(cache: EmbedCache, table: torch.Tensor,
                       tokens: torch.Tensor, fig: FIGKVConfig, step: int
                       ) -> Tuple[EmbedCache, torch.Tensor]:
    """tokens (T,) -> embeddings (T, d); serves hot segments from the fast
    table, misses from the big table, and inserts the first missed
    segment.  Writes ``cache.fast`` in place.

    Needs ``V % seg_tokens == 0`` (raises ``ValueError`` otherwise): a
    segment is then always ``seg_tokens`` whole rows of the table.  The
    fast table must have the table's dtype (the relocation moves bytes).
    Of the first ``min(T, 64)`` tokens each hit touches its slot; hits on
    one slot add up to ``min(b0 + count, benefit_max)``."""
    V, d = table.shape
    st = fig.seg_tokens
    if V % st:
        raise ValueError(f"embed_cache_lookup needs a vocabulary that is a "
                         f"multiple of seg_tokens={st}; got V={V}")
    if table.dtype != cache.fast.dtype:
        raise ValueError(f"table is {table.dtype} but the fast table is "
                         f"{cache.fast.dtype}")
    T = tokens.shape[0]
    segs = torch.div(tokens, st, rounding_mode="floor").to(torch.int32)
    offs = torch.remainder(tokens, st)

    hit, slot = (x[0] for x in fts_lib.lookup(cache.fts, segs[None]))
    from_fast = cache.fast[torch.where(hit, slot, 0).long(),
                           torch.where(hit, offs, 0).long()]
    from_slow = table[tokens.long()]
    out = torch.where(hit[:, None], from_fast, from_slow)

    # touch the hits of the first TOUCH_BOUND tokens; insert the first
    # missed segment
    n = min(T, TOUCH_BOUND)
    fts = fts_lib.touch(cache.fts, slot[None, :n], False, step,
                        (1 << fig.benefit_bits) - 1, fig.segs_per_row,
                        count=hit[None, :n].to(torch.int32))
    missed = torch.where(hit, -1, segs)
    any_miss = (missed >= 0).any()
    ins_seg = missed[torch.argmax((missed >= 0).to(torch.int32))]
    res = fts_lib.insert(fts, ins_seg[None], False, step, policy=fig.policy,
                         segs_per_row=fig.segs_per_row)
    fts = fts_lib.select(any_miss[None], res.fts, fts)
    reloc_segments(table.view(V // st, st, d), cache.fast,
                   torch.where(any_miss, ins_seg, -1)[None], res.slot)
    return EmbedCache(fast=cache.fast, fts=fts,
                      hits=cache.hits + hit.sum(dtype=torch.int32),
                      lookups=cache.lookups + T), out
