"""Attention for the LM stack: GQA / MQA with RoPE, DeepSeek-V2's
Multi-head Latent Attention (MLA), the prefill through the flash-attention
kernel, the KV cache (a ring for sliding-window models) and the decode
path.

The port's counterpart of ``repro.models.attention``.  Prefill runs
``kernels.flash_attention.ops.mha`` (the Hopper kernel on the card, its
plain version on the CPU), which reads KV head ``h // (H // Hkv)`` and
never repeats K/V.  Decode runs ``attend``, the plain chunked online
softmax of the reference, with GQA groups folded into the query axis.

A sliding-window prefill runs the kernel's window mask; the reference's
``banded_attend`` is only a faster form of the same function.  A
sliding-window model's cache holds the last ``window`` tokens as a ring
(slot ``pos % window``).  MLA caches the latent ``c_kv`` and the shared
RoPE key, and re-expands K and V from them at every decode step, as the
reference does.  Not ported yet (each raises ``NotImplementedError``;
ROADMAP.md Queue 1): the int8 KV cache (``plan.kv_quant``) and
cross-attention (``cross_kv``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs import ModelConfig
from repro_torch.kernels.flash_attention.ops import mha
from repro_torch.models.layers import apply_rope
from repro_torch.models.param import Spec
from repro_torch.models.plan import Plan

NEG = -1e30


def gqa_spec(cfg: ModelConfig, plan: Plan):
    d, hd = cfg.d_model, cfg.hd
    hq = plan.padded_heads(cfg.n_heads)
    hkv = plan.padded_kv_heads(cfg.n_kv_heads)
    p = {
        "wq": Spec((d, hq, hd), ("embed", "q_heads", "head_dim")),
        "wk": Spec((d, hkv, hd), ("embed", "kv_heads", "head_dim")),
        "wv": Spec((d, hkv, hd), ("embed", "kv_heads", "head_dim")),
        "wo": Spec((hq, hd, d), ("q_heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
        p["bq"] = Spec((hq, hd), ("q_heads", "head_dim"), init="zeros")
        p["bk"] = Spec((hkv, hd), ("kv_heads", "head_dim"), init="zeros")
        p["bv"] = Spec((hkv, hd), ("kv_heads", "head_dim"), init="zeros")
    return p


def mla_spec(cfg: ModelConfig, plan: Plan):
    m = cfg.mla
    d = cfg.d_model
    h = plan.padded_heads(cfg.n_heads)
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wq": Spec((d, h, qk), ("embed", "q_heads", "head_dim")),
        "w_dkv": Spec((d, m.kv_lora_rank), ("embed", "kv_lora")),
        "w_kr": Spec((d, m.qk_rope_head_dim), ("embed", None)),
        "w_uk": Spec((m.kv_lora_rank, h, m.qk_nope_head_dim),
                     ("kv_lora", "q_heads", "head_dim")),
        "w_uv": Spec((m.kv_lora_rank, h, m.v_head_dim),
                     ("kv_lora", "q_heads", "head_dim")),
        "wo": Spec((h, m.v_head_dim, d), ("q_heads", "head_dim", "embed")),
    }


def head_mask(cfg: ModelConfig, plan: Plan,
              device=None) -> Optional[torch.Tensor]:
    """1/0 mask zeroing TP-padding q heads (keeps the padded model exact)."""
    hq = plan.padded_heads(cfg.n_heads)
    if hq == cfg.n_heads:
        return None
    return (torch.arange(hq, device=device) < cfg.n_heads).to(torch.bfloat16)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool, window: int = 0, q_offset: int = 0,
           kv_len: Optional[int] = None, chunk: int = 1024) -> torch.Tensor:
    """q (B, Sq, H, D); k/v (B, Skv, H, D) (kv heads pre-repeated or
    folded) -> (B, Sq, H, D).

    Online softmax over KV chunks of ``chunk`` keys, as the reference: q
    scaled by D^-0.5 in its own dtype, f32 scores, the finite -1e30 on
    masked entries; ``q_offset`` is the absolute position of q[0],
    ``kv_len`` masks the valid cache prefix, ``window`` > 0 the sliding
    window.  The last chunk is cut short instead of zero-padded: the padded
    keys weigh exactly 0 in the reference."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    qf = (q * torch.tensor(d ** -0.5, dtype=q.dtype)).float().transpose(1, 2)
    q_pos = q_offset + torch.arange(sq, device=q.device)
    m = torch.full((b, h, sq), NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    for c0 in range(0, skv, chunk):
        c1 = min(skv, c0 + chunk)
        kb = k[:, c0:c1].float().transpose(1, 2)          # (B, H, c, D)
        vb = v[:, c0:c1].float().transpose(1, 2)
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kb)
        kv_pos = torch.arange(c0, c1, device=q.device)
        mask = torch.ones((sq, c1 - c0), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kv_pos[None, :] <= q_pos[:, None]
        if window:
            mask &= kv_pos[None, :] > q_pos[:, None] - window
        if kv_len is not None:
            mask &= kv_pos[None, :] < kv_len
        s = torch.where(mask, s, NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, vb)
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.transpose(1, 2).to(q.dtype)


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return x
    return x.repeat_interleave(n_rep, dim=2)


class KVCache(NamedTuple):
    k: torch.Tensor        # (B, Smax, Hkv, D) bf16
    v: torch.Tensor
    k_scale: Optional[torch.Tensor]   # int8 cache scales (not ported: None)
    v_scale: Optional[torch.Tensor]
    length: int            # valid prefix


def init_kv_cache(batch: int, s_max: int, hkv: int, d: int, quant: bool,
                  device=None) -> KVCache:
    if quant:
        raise NotImplementedError("the int8 KV cache (plan.kv_quant) is not "
                                  "ported yet")
    shape = (batch, s_max, hkv, d)
    return KVCache(k=torch.zeros(shape, dtype=torch.bfloat16, device=device),
                   v=torch.zeros(shape, dtype=torch.bfloat16, device=device),
                   k_scale=None, v_scale=None, length=0)


def cache_update(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor,
                 pos: int) -> KVCache:
    """Write k/v (B, S_new, Hkv, D) at offset ``pos``, in place in the
    caller's cache tensors; the returned cache has the new length.

    Raises ``ValueError`` when the write does not fit the cache: a slice
    past ``s_max`` would be empty, and the token would be dropped while the
    length still grew."""
    if cache.k_scale is not None:
        raise NotImplementedError("the int8 KV cache is not ported yet")
    s_new = k_new.shape[1]
    s_max = cache.k.shape[1]
    if pos < 0 or pos + s_new > s_max:
        raise ValueError(f"cache_update: positions {pos}..{pos + s_new - 1} "
                         f"do not fit the {s_max}-token KV cache")
    cache.k[:, pos:pos + s_new] = k_new
    cache.v[:, pos:pos + s_new] = v_new
    return cache._replace(length=pos + s_new)


def cache_kv(cache: KVCache):
    """K/V of the cache in bf16."""
    if cache.k_scale is not None:
        raise NotImplementedError("the int8 KV cache is not ported yet")
    return cache.k, cache.v


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, S, d) @ w (d, h, k) -> (B, S, h, k)."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).view(*x.shape[:-1], h, k)


def gqa_forward(p, x: torch.Tensor, cfg: ModelConfig, plan: Plan, *,
                rope=None, cache: Optional[KVCache] = None,
                decode: bool = False, cross_kv=None, hmask=None):
    """x (B, S, D) -> (y, cache).  Prefill (``cache`` given) also fills the
    cache; decode (S == 1) appends to it at ``cache.length``."""
    if cross_kv is not None:
        raise NotImplementedError("cross-attention (cross_kv) is not ported "
                                  "yet")
    b, s, _ = x.shape
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if rope is not None:
        q, k = apply_rope(q, rope), apply_rope(k, rope)
    w = cfg.sliding_window

    if decode:
        pos = cache.length
        s_alloc = cache.k.shape[1]
        if w and s_alloc <= w:
            # ring: the cache holds exactly the last ``s_alloc`` tokens, so
            # slot order is irrelevant (attention is a set operation) and
            # only the valid-slot count masks
            cache = cache_update(cache, k, v, pos % s_alloc)._replace(
                length=pos + s)
            kv_len, window = min(pos + s, s_alloc), 0
        else:
            cache = cache_update(cache, k, v, pos)
            kv_len, window = pos + s, w
        hq, hd = q.shape[2], q.shape[3]
        hkv = cache.k.shape[2]
        n_rep = hq // hkv
        # GQA packing: fold the group into the query axis, so each KV head
        # is read once (valid while the mask does not depend on the query
        # position: one query, no window mask)
        pack = plan.opt_gqa_pack and n_rep > 1 and s == 1 and not window
        if pack:
            qx, rep_eff = q.reshape(b, hkv, n_rep, hd).transpose(1, 2), 1
        else:
            qx, rep_eff = q, n_rep
        kf, vf = cache_kv(cache)
        out = attend(qx, repeat_kv(kf, rep_eff), repeat_kv(vf, rep_eff),
                     causal=False, window=window, q_offset=pos,
                     kv_len=kv_len)
        if pack:
            out = out.transpose(1, 2).reshape(b, 1, hq, hd)
    else:
        if cache is not None:
            s_alloc = cache.k.shape[1]
            if s > s_alloc:
                # ring: only the last ``s_alloc`` tokens are ever read; with
                # S % window == 0 they land on the slots the decode ring
                # (pos % window) expects
                cache = cache_update(cache, k[:, -s_alloc:], v[:, -s_alloc:],
                                     0)._replace(length=s)
            else:
                cache = cache_update(cache, k, v, 0)
        out = mha(q, k, v, causal=True, window=w)
    if hmask is not None:
        out = out * hmask[None, None, :, None]
    hq, hd, d = p["wo"].shape
    y = out.reshape(b, s, hq * hd) @ p["wo"].reshape(hq * hd, d)
    return y, cache


def mla_forward(p, x: torch.Tensor, cfg: ModelConfig, plan: Plan, *,
                rope=None, cache: Optional[KVCache] = None,
                decode: bool = False, hmask=None):
    """DeepSeek-V2 Multi-head Latent Attention, x (B, S, D) -> (y, cache).

    The cache holds the compressed latent ``c_kv`` (rank ``kv_lora_rank``)
    in its k slot and the shared RoPE key in its v slot, one "head" each.
    K is ``k_nope ++ k_rope`` (the RoPE key broadcast over the heads) and V
    is zero-padded to the qk head dim, so prefill runs the flash-attention
    kernel at D = qk_nope + qk_rope; decode runs ``attend`` over the whole
    latent cache, re-expanded every step."""
    m = cfg.mla
    b, s, _ = x.shape
    q = _proj(x, p["wq"])
    q_nope, q_rope = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    c_kv = x @ p["w_dkv"]                           # (B, S, rank)
    k_rope = (x @ p["w_kr"])[:, :, None, :]         # (B, S, 1, rope)
    if rope is not None:
        q_rope, k_rope = apply_rope(q_rope, rope), apply_rope(k_rope, rope)

    if decode:
        pos = cache.length
        cache = cache_update(cache, c_kv[:, :, None, :], k_rope, pos)
        c_all, kr_all = cache_kv(cache)
        c_all = c_all[:, :, 0, :]
        kv_len = pos + s
    else:
        if cache is not None:
            cache = cache_update(cache, c_kv[:, :, None, :], k_rope, 0)
        c_all, kr_all, pos = c_kv, k_rope, 0

    k_nope = _proj(c_all, p["w_uk"])
    v = _proj(c_all, p["w_uv"])
    h = q.shape[2]
    k = torch.cat([k_nope, kr_all.expand(-1, -1, h, -1)], dim=-1)
    qfull = torch.cat([q_nope, q_rope], dim=-1)
    # the v head dim may differ from the qk dim: pad v to it
    vp = _pad_last(v, qfull.shape[-1])
    if decode:
        out = attend(qfull, k, vp, causal=False, q_offset=pos, kv_len=kv_len)
    else:
        # the reference's attend scales q in bf16 (the scale rounded to
        # bf16 first), then takes unscaled f32 scores; at D = 192 (or the
        # reduced 24) D^-0.5 is no power of two, so the kernel gets q so
        # scaled and a unit scale
        qs = qfull * torch.tensor(qfull.shape[-1] ** -0.5, dtype=q.dtype)
        out = mha(qs, k, vp, causal=True, scale=1.0)
    out = out[..., :m.v_head_dim]
    if hmask is not None:
        out = out * hmask[None, None, :, None]
    hq, hd, d = p["wo"].shape
    y = out.reshape(b, s, hq * hd) @ p["wo"].reshape(hq * hd, d)
    return y, cache


def _pad_last(x: torch.Tensor, target: int) -> torch.Tensor:
    if x.shape[-1] == target:
        return x
    return torch.nn.functional.pad(x, (0, target - x.shape[-1]))
