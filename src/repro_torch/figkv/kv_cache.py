"""FIGCache-KV: the paper's fine-grained in-DRAM cache lifted to the KV
cache, PyTorch port of ``repro.figkv.kv_cache``.

Mapping (paper -> here):
  DRAM row segment (16 blocks)   -> KV segment (``seg_tokens`` tokens)
  slow subarrays                 -> the full KV pool (B, S, Hkv, D)
  fast subarrays (64 rows x 8)   -> contiguous fast pool
                                    (B, fast_rows*segs_per_row slots)
  RELOC via global row buffer    -> segment move slow pool -> fast pool
  FTS {tag,valid,dirty,benefit}  -> identical structure (``core/fts``),
                                    one store per sequence (lane axis B);
                                    transaction and both moves of a step
                                    in one ``kernels/figkv_tx`` launch
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
pools, segment summaries, fast pools and FTS leaves IN PLACE (the slow
pool is the size of the whole context; the transaction kernel writes the
leaves where they lie), so the returned state holds the same tensors.

A selected segment whose hit slot the same step's insert takes is read
from the slow pool, which holds its exact K/V (``repair_slots`` in
``kernels/figkv_tx/ref.py``).  The JAX package reads the inserted
segment's copy in its place; its tag store, pools and fast pools stay
equal to the port's.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.configs import FIGKVConfig
from repro_torch.core import fts as fts_lib
from repro_torch.device import resolve_device
from repro_torch.kernels.figcache_decode.ops import decode_attend
from repro_torch.kernels.figkv_tx.ops import figkv_tx


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


def figkv_decode_step(state: FigKVState, q: torch.Tensor,
                      k_new: torch.Tensor, v_new: torch.Tensor,
                      fig: FIGKVConfig, *, n_sel: int = 16, recent: int = 64
                      ) -> Tuple[FigKVState, torch.Tensor]:
    """One decode step.  q (B,1,H,D); k_new/v_new (B,1,Hkv,D).

    Returns (state', attention output (B,1,H,D)); the state's tensors,
    FTS leaves included, are updated in place.  One ``figkv_tx`` launch
    (every sequence's transaction and K/V move) and one ``decode_attend``
    launch."""
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

    # -- segment selection, then the FTS transaction and the RELOC of the
    #    inserted segment into the fast pool, batched over sequences.  The
    #    segment views leave out a ragged tail: Smax need not be a multiple
    #    of st, and the kernel takes the pool's own strides (no copy) -----
    sel = _select_segments(q, seg_key, n_live, n_sel)          # (B, n_sel)
    seg_k = pool_k[:, :n_segs * st].view(B, n_segs, st, Hkv, D)
    seg_v = pool_v[:, :n_segs * st].view(B, n_segs, st, Hkv, D)
    slots, _, _ = figkv_tx(sel, pos, n_live, state.fts, seg_k, seg_v,
                           state.fast_k, state.fast_v, fig)

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

    return state._replace(length=pos + 1), out


def _masked_attend(q, k, v, valid):
    """q (B,1,H,D), k/v (B,L,H,D), valid (B,L) -> (B,1,H,D), f32 softmax.
    The plain exact attention the tests hold the step against."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (
        q.shape[-1] ** -0.5)
    s = torch.where(valid[:, None, None, :], s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o.to(q.dtype)
