"""FIGCache-KV: the paper's fine-grained in-DRAM cache lifted to the KV
cache, PyTorch port of ``repro.figkv.kv_cache``.

Mapping (paper -> here):
  DRAM row segment (16 blocks)   -> KV segment (``seg_tokens`` tokens)
  slow subarrays                 -> the full KV pool (B, S, Hkv, D)
  fast subarrays (64 rows x 8)   -> contiguous fast pool
                                    (B, fast_rows*segs_per_row slots)
  RELOC via global row buffer    -> segment move slow pool -> fast pool
                                    (``kernels/figaro_reloc``)
  FTS {tag,valid,dirty,benefit}  -> identical structure (``core/fts``),
                                    one store per sequence (lane axis B)
  insert-any-miss                -> top-scoring selected-but-uncached
                                    COMPLETE segment is relocated each step
                                    (the JAX package also relocates the
                                    dead ids that pad a short selection)
  RowBenefit row eviction        -> identical

Decode attends over (selected hot segments ∪ recent window) through
``kernels/figcache_decode``, reading K/V in their (B, L, Hkv, D) layout:
the grouped query heads are never repeated.  With n_sel covering all
segments this is exactly full attention (the correctness oracle of the
tests).

The step is eager PyTorch and reads nothing back from the device: the
position is a Python int carried in the state.  It updates the state's
pools, segment summaries and fast pools IN PLACE (the slow pool is the
size of the whole context) and returns new FTS leaves.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.configs import FIGKVConfig
from repro_torch.core import fts as fts_lib
from repro_torch.device import resolve_device
from repro_torch.kernels.figaro_reloc.ops import reloc_segments
from repro_torch.kernels.figcache_decode.ops import decode_attend


class FigKVState(NamedTuple):
    pool_k: torch.Tensor   # (B, Smax, Hkv, D)  slow region
    pool_v: torch.Tensor
    seg_key: torch.Tensor  # (B, n_segs, Hkv, D) f32 — per-segment key sum
    fast_k: torch.Tensor   # (B, slots, seg_tokens, Hkv, D) fast pool
    fast_v: torch.Tensor
    fts: fts_lib.FTS       # leaves (B, ...)
    length: int            # tokens in the slow pool


def figkv_init(batch: int, s_max: int, hkv: int, d: int, fig: FIGKVConfig,
               dtype=torch.bfloat16, device=None) -> FigKVState:
    dev = resolve_device(device)
    n_segs = s_max // fig.seg_tokens
    slots = fig.fast_rows * fig.segs_per_row

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    return FigKVState(
        pool_k=zeros(batch, s_max, hkv, d),
        pool_v=zeros(batch, s_max, hkv, d),
        seg_key=zeros(batch, n_segs, hkv, d, dt=torch.float32),
        fast_k=zeros(batch, slots, fig.seg_tokens, hkv, d),
        fast_v=zeros(batch, slots, fig.seg_tokens, hkv, d),
        # unpadded tag store (max == actual): figkv never sweeps FTS shapes
        fts=fts_lib.init_lanes(batch, slots, fig.segs_per_row, device=dev),
        length=0,
    )


def figkv_prefill(state: FigKVState, k: torch.Tensor, v: torch.Tensor
                  ) -> FigKVState:
    """Fill the slow pool with prompt KV (B, S, Hkv, D) and build segment
    summaries, in place.  The fast pool starts cold (insert-any-miss warms
    it)."""
    B, S, Hkv, D = k.shape
    st = state.fast_k.shape[2]
    state.pool_k[:, :S] = k
    state.pool_v[:, :S] = v
    n_full = S // st
    state.seg_key[:, :n_full] = k[:, :n_full * st].reshape(
        B, n_full, st, Hkv, D).float().sum(dim=2)
    if S - n_full * st:
        state.seg_key[:, n_full] = k[:, n_full * st:].float().sum(dim=1)
    return state._replace(length=S)


def _select_segments(q: torch.Tensor, seg_key: torch.Tensor, n_live: int,
                     n_sel: int) -> torch.Tensor:
    """Quest-style segment scoring: score = max_h q·seg_key.
    q (B,1,H,D) -> (B, n_sel) segment ids (may include dead ids; masked).

    Ranked by a stable descending sort, so equal scores (the -inf of every
    dead segment) come lowest id first, as ``jax.lax.top_k`` orders them."""
    B, _, H, D = q.shape
    Hkv = seg_key.shape[2]
    n_segs = seg_key.shape[1]
    if n_sel > n_segs:
        raise ValueError(f"n_sel={n_sel} exceeds the {n_segs} segments")
    qh = q[:, 0].reshape(B, Hkv, H // Hkv, D).float()
    s = torch.einsum("bhrd,bshd->bsr", qh, seg_key).amax(dim=-1)
    live = torch.arange(n_segs, device=s.device)[None] < n_live
    s = torch.where(live, s, float("-inf"))
    order = torch.sort(s, dim=1, descending=True, stable=True).indices
    return order[:, :n_sel].to(torch.int32)


def _fts_step(fts: fts_lib.FTS, segs: torch.Tensor, step: torch.Tensor,
              fig: FIGKVConfig, n_live: int):
    """Per-sequence FTS transaction for the selected segments ``segs (B,
    n_sel)``: touch hits; insert the best-scoring live miss (RowBenefit
    eviction).  Returns (fts, slot_per_seg, inserted_seg, inserted_slot).

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


def figkv_decode_step(state: FigKVState, q: torch.Tensor,
                      k_new: torch.Tensor, v_new: torch.Tensor,
                      fig: FIGKVConfig, *, n_sel: int = 16, recent: int = 64
                      ) -> Tuple[FigKVState, torch.Tensor]:
    """One decode step.  q (B,1,H,D); k_new/v_new (B,1,Hkv,D).

    Returns (state', attention output (B,1,H,D)).  One ``reloc_segments``
    launch each for K and V (one masked move per sequence) and one
    ``decode_attend`` launch."""
    st = fig.seg_tokens
    if recent < 2 * st:
        raise ValueError("recent window must cover the active (uncacheable) "
                         "segment")
    B, _, H, D = q.shape
    Hkv = k_new.shape[2]
    pos = state.length
    pool_k, pool_v, seg_key = state.pool_k, state.pool_v, state.seg_key
    smax, n_segs = pool_k.shape[1], seg_key.shape[1]
    if not recent <= smax or not 0 <= pos < smax:
        raise ValueError(f"position {pos} / recent {recent} do not fit the "
                         f"{smax}-token pool")
    # -- append token to the slow pool + segment summary ------------------
    pool_k[:, pos] = k_new[:, 0]
    pool_v[:, pos] = v_new[:, 0]
    if pos // st < n_segs:
        seg_key[:, pos // st] += k_new[:, 0].float()
    # only COMPLETE segments are cacheable: the active segment still mutates
    n_live = (pos + 1) // st

    # -- segment selection + FTS transaction, batched over sequences -------
    sel = _select_segments(q, seg_key, n_live, n_sel)          # (B, n_sel)
    step = torch.full((B,), pos, dtype=torch.int32, device=q.device)
    fts, slots, ins_seg, ins_slot = _fts_step(state.fts, sel, step, fig,
                                              n_live)

    # -- RELOC: move the inserted segment into the fast pool.  The segment
    #    views leave out a ragged tail: Smax need not be a multiple of st,
    #    and the kernel takes the pool's own strides (no copy) ------------
    seg_k = pool_k[:, :n_segs * st].view(B, n_segs, st, Hkv, D)
    seg_v = pool_v[:, :n_segs * st].view(B, n_segs, st, Hkv, D)
    reloc_segments(seg_k, state.fast_k, ins_seg[:, None], ins_slot[:, None])
    reloc_segments(seg_v, state.fast_v, ins_seg[:, None], ins_slot[:, None])

    # -- gather selected segments: fast pool when cached, slow pool else ---
    b = torch.arange(B, device=q.device)[:, None]
    use_fast = (slots >= 0)[..., None, None, None]
    fast_slot = slots.clamp(min=0).long()
    sel_l = sel.long()
    ks = torch.where(use_fast, state.fast_k[b, fast_slot], seg_k[b, sel_l])
    vs = torch.where(use_fast, state.fast_v[b, fast_slot], seg_v[b, sel_l])

    # -- recent window (exact) ---------------------------------------------
    start = min(max(pos + 1 - recent, 0), smax - recent)
    rk = pool_k[:, start:start + recent]
    rv = pool_v[:, start:start + recent]

    # -- masks: selected segment tokens valid if <= pos and not inside the
    #    recent window (no double counting) -------------------------------
    tok = torch.arange(st, dtype=torch.int32, device=q.device)
    sel_tok_pos = (sel[..., None] * st + tok).reshape(B, n_sel * st)
    sel_valid = (sel_tok_pos <= pos) & (sel_tok_pos < start)
    rec = start + torch.arange(recent, device=q.device)
    rec_valid = (rec <= pos)[None].expand(B, recent)

    k_all = torch.cat([ks.reshape(B, n_sel * st, Hkv, D), rk], dim=1)
    v_all = torch.cat([vs.reshape(B, n_sel * st, Hkv, D), rv], dim=1)
    valid = torch.cat([sel_valid, rec_valid], dim=1)           # (B, L)
    out = decode_attend(q, k_all, v_all, valid)

    return state._replace(fts=fts, length=pos + 1), out


def _masked_attend(q, k, v, valid):
    """q (B,1,H,D), k/v (B,L,H,D), valid (B,L) -> (B,1,H,D), f32 softmax.
    The plain exact attention the tests hold the step against."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (
        q.shape[-1] ** -0.5)
    s = torch.where(valid[:, None, None, :], s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o.to(q.dtype)
