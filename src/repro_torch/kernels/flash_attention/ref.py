"""Plain PyTorch version of the prefill flash-attention kernel.  The CPU
path of ``ops.mha``, the oracle the CUDA kernel is held against on the
card, and (one query block at a time) the graph that ``ops.MHA``'s
backward differentiates."""
from __future__ import annotations

import torch

NEG = -1e30


def grouped(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """q (B, S, H, D), k/v (B, S, Hkv, D) -> f32 q (B, Hkv, H/Hkv, S, D)
    and f32 k/v (B, Hkv, S, D): query head h reads KV head h // (H/Hkv)."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    qf = q.float().reshape(b, s, hkv, h // hkv, d).permute(0, 2, 3, 1, 4)
    return qf, k.float().permute(0, 2, 1, 3), v.float().permute(0, 2, 1, 3)


def key_range(q0: int, q1: int, s: int, causal: bool, window: int):
    """The keys [lo, hi) that query rows [q0, q1) can see."""
    lo = max(0, q0 - window + 1) if window else 0
    return lo, (q1 if causal else s)


def block(qf: torch.Tensor, kf: torch.Tensor, vf: torch.Tensor, q0: int,
          lo: int, *, causal: bool, window: int, scale: float
          ) -> torch.Tensor:
    """One query block in ``grouped``'s layout: qf (B, Hkv, rep, Bq, D)
    at rows q0.., kf/vf (B, Hkv, Bk, D) at keys lo.. -> f32 output (B, Hkv,
    rep, Bq, D): f32 scores times ``scale``, the finite -1e30 on masked
    entries (causal: key <= query; ``window`` > 0: key > query - window),
    softmax, f32 ``p @ v``."""
    dev = qf.device
    sc = torch.einsum("bgrqd,bgkd->bgrqk", qf, kf) * scale
    qp = torch.arange(q0, q0 + qf.shape[3], dtype=torch.int32,
                      device=dev)[:, None]
    kp = torch.arange(lo, lo + kf.shape[2], dtype=torch.int32, device=dev)[None]
    mask = torch.ones((qp.shape[0], kp.shape[1]), dtype=torch.bool,
                      device=dev)
    if causal:
        mask &= kp <= qp
    if window:
        mask &= kp > qp - window
    p = torch.softmax(torch.where(mask, sc, NEG), dim=-1)
    return torch.einsum("bgrqk,bgkd->bgrqd", p, vf)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        block_q: int = 256, scale: float | None = None
                        ) -> torch.Tensor:
    """q (B, S, H, D); k/v (B, S, Hkv, D), query head h reading KV head
    ``h // (H // Hkv)`` -> (B, S, H, D) in q's dtype.

    The JAX package's ``flash_attention_ref`` over query blocks of
    ``block_q`` rows (``block``), so a long prefill never holds the whole
    (S, S) score matrix; scores scaled by ``scale`` (default D^-0.5) on the
    product.  Each block reads only the keys its masks leave open; the
    masked ones it drops weigh exactly 0."""
    b, s, h, d = q.shape
    scale = d ** -0.5 if scale is None else scale
    qf, kf, vf = grouped(q, k, v)
    out = torch.empty_like(qf)                    # (B, Hkv, rep, S, D)
    for q0 in range(0, s, block_q):
        q1 = min(s, q0 + block_q)
        lo, hi = key_range(q0, q1, s, causal, window)
        out[:, :, :, q0:q1] = block(qf[:, :, :, q0:q1], kf[:, :, lo:hi],
                                    vf[:, :, lo:hi], q0, lo, causal=causal,
                                    window=window, scale=scale)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, d).to(q.dtype)
