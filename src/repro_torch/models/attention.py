"""Attention for the LM stack: GQA / MQA with RoPE, DeepSeek-V2's
Multi-head Latent Attention (MLA), cross-attention over an encoder's K/V
(Whisper), the prefill through the flash-attention kernel, the KV cache
(bf16 or int8, a ring for sliding-window models) and the decode path.

The port's counterpart of ``repro.models.attention``.  Prefill runs
``kernels.flash_attention.ops.mha`` (the Hopper kernel on the card, its
plain version on the CPU) through ``prefill_mha``, which scales q by
D^-0.5 in q's dtype as the reference's ``attend`` does; the kernel reads
KV head ``h // (H // Hkv)`` and never repeats K/V.  Decode and
cross-attention (whose queries and keys differ in length) run ``attend``,
the plain chunked online softmax of the reference, with GQA groups folded
into the query axis.

A sliding-window prefill runs the kernel's window mask; the reference's
``banded_attend`` is only a faster form of the same function.  A
sliding-window model's cache holds the last ``window`` tokens as a ring
(slot ``pos % window``).  The int8 cache (``Plan.kv_quant``) keeps codes
and per-(token, head) f32 scales; its decode hands the codes to ``attend``,
which dequantizes them chunk by chunk (the reference's default route).
MLA caches the latent ``c_kv`` and the shared RoPE key in bf16 (under
``kv_quant`` too, as the reference), and re-expands K and V from them at
every decode step.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs import ModelConfig
from repro_torch.kernels.flash_attention.ops import mha
from repro_torch.models.layers import apply_rope, matmul
from repro_torch.models.param import Spec
from repro_torch.models.plan import Plan
from repro_torch.spmd import is_dtensor, local_call, redistribute_to

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
           kv_len: Optional[int] = None, chunk: int = 1024,
           k_scale: Optional[torch.Tensor] = None,
           v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B, Sq, H, D); k/v (B, Skv, H, D) (kv heads pre-repeated or
    folded) -> (B, Sq, H, D).

    Online softmax over KV chunks of ``chunk`` keys, as the reference: q
    scaled by D^-0.5 in its own dtype, f32 scores, the finite -1e30 on
    masked entries; ``q_offset`` is the absolute position of q[0],
    ``kv_len`` masks the valid cache prefix, ``window`` > 0 the sliding
    window.  The last chunk is cut short instead of zero-padded: the padded
    keys weigh exactly 0 in the reference.  With ``k_scale`` / ``v_scale``
    (B, Skv, H) f32, k / v are int8 codes, dequantized chunk by chunk
    (codes times scales in f32): the int8-native mode."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    qf = (q * torch.tensor(d ** -0.5, dtype=q.dtype)).float().transpose(1, 2)
    q_pos = q_offset + torch.arange(sq, device=q.device)
    m = torch.full((b, h, sq), NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    for c0 in range(0, skv, chunk):
        c1 = min(skv, c0 + chunk)
        kb, vb = k[:, c0:c1].float(), v[:, c0:c1].float()
        if k_scale is not None:
            kb = kb * k_scale[:, c0:c1, :, None]
            vb = vb * v_scale[:, c0:c1, :, None]
        kb, vb = kb.transpose(1, 2), vb.transpose(1, 2)    # (B, H, c, D)
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
    k: torch.Tensor        # (B, Smax, Hkv, D) bf16, or int8 codes
    v: torch.Tensor
    k_scale: Optional[torch.Tensor]   # (B, Smax, Hkv) f32 when int8
    v_scale: Optional[torch.Tensor]
    length: int            # valid prefix


def init_kv_cache(batch: int, s_max: int, hkv: int, d: int, quant: bool,
                  device=None) -> KVCache:
    """A zeroed cache: bf16 K/V, or (``quant``) int8 codes with f32 scales
    per (token, head)."""
    shape = (batch, s_max, hkv, d)
    if quant:
        return KVCache(
            k=torch.zeros(shape, dtype=torch.int8, device=device),
            v=torch.zeros(shape, dtype=torch.int8, device=device),
            k_scale=torch.zeros(shape[:3], dtype=torch.float32, device=device),
            v_scale=torch.zeros(shape[:3], dtype=torch.float32, device=device),
            length=0)
    return KVCache(k=torch.zeros(shape, dtype=torch.bfloat16, device=device),
                   v=torch.zeros(shape, dtype=torch.bfloat16, device=device),
                   k_scale=None, v_scale=None, length=0)


def _quant_kv(x: torch.Tensor):
    """x (..., D) -> (int8 codes, f32 scales (...)): symmetric per row,
    ``s = max|x| / 127`` and ``round(x / max(s, 1e-8))`` clipped to +-127,
    in f32 (round half to even, as ``jnp.round``).  Both divisions take a
    tensor divisor on x's device: CUDA's division by a Python scalar (or a
    CPU scalar tensor) multiplies by its reciprocal, which is not the
    reference's quotient.  ``torch.full`` fills it on the device, with no
    copy from the host."""
    xf = x.float()
    s = xf.abs().amax(dim=-1) / torch.full((), 127.0, device=x.device)
    q = torch.round(xf / torch.clamp(s[..., None], min=1e-8))
    return torch.clamp(q, -127, 127).to(torch.int8), s


def cache_update(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor,
                 pos: int) -> KVCache:
    """Write k/v (B, S_new, Hkv, D) at offset ``pos``, in place in the
    caller's cache tensors (quantized first into an int8 cache); the
    returned cache has the new length.

    Raises ``ValueError`` when the write does not fit the cache: a slice
    past ``s_max`` would be empty, and the token would be dropped while the
    length still grew."""
    s_new = k_new.shape[1]
    s_max = cache.k.shape[1]
    if pos < 0 or pos + s_new > s_max:
        raise ValueError(f"cache_update: positions {pos}..{pos + s_new - 1} "
                         f"do not fit the {s_max}-token KV cache")
    if is_dtensor(cache.k):
        # on a mesh: the new rows in the cache's layout, written into the
        # local shards (the cache's tensors stay the caller's)
        k_new = redistribute_to(k_new, cache.k.placements)
        v_new = redistribute_to(v_new, cache.v.placements)
        local = cache._replace(**{
            f: getattr(cache, f).to_local()
            for f in ("k", "v", "k_scale", "v_scale")
            if getattr(cache, f) is not None})
        cache_update(local, k_new.to_local(), v_new.to_local(), pos)
        return cache._replace(length=pos + s_new)
    if cache.k_scale is not None:
        (k_new, ks), (v_new, vs) = _quant_kv(k_new), _quant_kv(v_new)
        cache.k_scale[:, pos:pos + s_new] = ks
        cache.v_scale[:, pos:pos + s_new] = vs
    cache.k[:, pos:pos + s_new] = k_new
    cache.v[:, pos:pos + s_new] = v_new
    return cache._replace(length=pos + s_new)


def _local_attend(q, k, v, k_scale, v_scale, n_rep: int, **kw):
    """``attend`` without a causal mask, on K/V (and int8 scales) of the
    cache's heads repeated ``n_rep`` times.  On a mesh it runs on the
    local shards (batch and heads split, nothing else: each (batch, head)
    is attended on its own), the result wrapped back."""
    def fn(q, k, v, ks, vs):
        scales = {} if ks is None else dict(k_scale=repeat_kv(ks, n_rep),
                                            v_scale=repeat_kv(vs, n_rep))
        return attend(q, repeat_kv(k, n_rep), repeat_kv(v, n_rep),
                      causal=False, **kw, **scales)
    return local_call(fn, (q, k, v, k_scale, v_scale), (0, 2))


def prefill_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                causal: bool = True, window: int = 0) -> torch.Tensor:
    """``mha`` as the reference's ``attend`` scales: q times D^-0.5 rounded
    to q's dtype (bf16: the scale rounded first), then unscaled f32 scores
    (``scale=1.0``).  Where D^-0.5 is no power of two (D 20, 24, 128, 192)
    scaling the f32 product instead rounds differently."""
    qs = q * torch.tensor(q.shape[-1] ** -0.5, dtype=q.dtype)
    return mha(qs, k, v, causal=causal, window=window, scale=1.0)


def proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, S, d) @ w (d, h, k) -> (B, S, h, k), in the promoted dtype
    (``layers.matmul``)."""
    d, h, k = w.shape
    return matmul(x, w.reshape(d, h * k)).view(*x.shape[:-1], h, k)


def gqa_forward(p, x: torch.Tensor, cfg: ModelConfig, plan: Plan, *,
                rope=None, cache: Optional[KVCache] = None,
                decode: bool = False, cross_kv=None, hmask=None):
    """x (B, S, D) -> (y, cache).  Prefill (``cache`` given) also fills the
    cache; decode (S == 1) appends to it at ``cache.length``.
    ``cross_kv``: (k, v) (B, F, Hkv, D) from an encoder; the queries then
    attend them without a causal mask (no RoPE), through ``attend``;
    Whisper's decoder passes no cache and ``decode`` False at every step."""
    b, s, _ = x.shape
    q = proj(x, p["wq"])
    if "bq" in p:
        q = q + p["bq"]
    q = plan.hint(q, "dp", None, "tp", None)   # Megatron: heads stay sharded
    if cross_kv is None:
        k, v = proj(x, p["wk"]), proj(x, p["wv"])
        if "bk" in p:
            k, v = k + p["bk"], v + p["bv"]
        k = plan.hint(k, "dp", None, "tp", None)
        v = plan.hint(v, "dp", None, "tp", None)
        if rope is not None:
            q, k = apply_rope(q, rope), apply_rope(k, rope)
    else:
        k, v = cross_kv
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
        scales = {}
        if cache.k_scale is not None:
            # int8: the codes stay int8, dequantized per chunk in attend
            scales = dict(k_scale=repeat_kv(cache.k_scale, rep_eff),
                          v_scale=repeat_kv(cache.v_scale, rep_eff))
        out = _local_attend(qx, cache.k, cache.v, cache.k_scale,
                            cache.v_scale, rep_eff, window=window,
                            q_offset=pos, kv_len=kv_len)
        if pack:
            out = out.transpose(1, 2).reshape(b, 1, hq, hd)
    else:
        if cache is not None:
            s_alloc = cache.k.shape[1]
            if k.shape[1] > s_alloc:
                # ring: only the last ``s_alloc`` tokens are ever read; with
                # S % window == 0 they land on the slots the decode ring
                # (pos % window) expects
                cache = cache_update(cache, k[:, -s_alloc:], v[:, -s_alloc:],
                                     0)._replace(length=s)
            else:
                cache = cache_update(cache, k, v, 0)
        if cross_kv is None:
            out = prefill_mha(q, k, v, causal=True, window=w)
        else:
            out = _local_attend(q, k, v, None, None, q.shape[2] // k.shape[2],
                                window=w)
    out = plan.hint(out, "dp", None, "tp", None)
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
    q = plan.hint(proj(x, p["wq"]), "dp", None, "tp", None)
    q_nope, q_rope = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    c_kv = x @ p["w_dkv"]                           # (B, S, rank)
    k_rope = (x @ p["w_kr"])[:, :, None, :]         # (B, S, 1, rope)
    if rope is not None:
        q_rope, k_rope = apply_rope(q_rope, rope), apply_rope(k_rope, rope)

    if decode:
        pos = cache.length
        cache = cache_update(cache, c_kv[:, :, None, :], k_rope, pos)
        c_all, kr_all = cache.k[:, :, 0, :], cache.v
        kv_len = pos + s
    else:
        if cache is not None:
            cache = cache_update(cache, c_kv[:, :, None, :], k_rope, 0)
        c_all, kr_all, pos = c_kv, k_rope, 0

    k_nope = plan.hint(proj(c_all, p["w_uk"]), "dp", None, "tp", None)
    v = plan.hint(proj(c_all, p["w_uv"]), "dp", None, "tp", None)
    h = q.shape[2]
    k = torch.cat([k_nope, kr_all.expand(-1, -1, h, -1)], dim=-1)
    qfull = torch.cat([q_nope, q_rope], dim=-1)
    # the v head dim may differ from the qk dim: pad v to it
    vp = _pad_last(v, qfull.shape[-1])
    if decode:
        out = _local_attend(qfull, k, vp, None, None, 1, q_offset=pos,
                            kv_len=kv_len)
    else:
        out = prefill_mha(qfull, k, vp, causal=True)
    out = plan.hint(out[..., :m.v_head_dim], "dp", None, "tp", None)
    if hmask is not None:
        out = out * hmask[None, None, :, None]
    hq, hd, d = p["wo"].shape
    y = out.reshape(b, s, hq * hd) @ p["wo"].reshape(hq * hd, d)
    return y, cache


def _pad_last(x: torch.Tensor, target: int) -> torch.Tensor:
    if x.shape[-1] == target:
        return x
    return torch.nn.functional.pad(x, (0, target - x.shape[-1]))
