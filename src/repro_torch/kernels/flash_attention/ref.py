"""Plain PyTorch version of the prefill flash-attention kernel.  The CPU
path of ``ops.mha`` and the oracle the CUDA kernel is held against on the
card."""
from __future__ import annotations

import torch

NEG = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        block_q: int = 256, scale: float | None = None
                        ) -> torch.Tensor:
    """q (B, S, H, D); k/v (B, S, Hkv, D), query head h reading KV head
    ``h // (H // Hkv)`` -> (B, S, H, D) in q's dtype.

    The JAX package's ``flash_attention_ref`` over query blocks of
    ``block_q`` rows, so a long prefill never holds the whole (S, S) score
    matrix: f32 scores scaled by ``scale`` (default D^-0.5) on the
    product, the finite -1e30 on
    masked entries (causal: key <= query; ``window`` > 0: key > query -
    window), softmax, f32 ``p @ v``.  Each block reads only the keys its
    masks leave open; the masked ones it drops weigh exactly 0."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    scale = d ** -0.5 if scale is None else scale
    qf = q.float().reshape(b, s, hkv, h // hkv, d).permute(0, 2, 3, 1, 4)
    kf = k.float().permute(0, 2, 1, 3)            # (B, Hkv, S, D)
    vf = v.float().permute(0, 2, 1, 3)
    out = torch.empty_like(qf)                    # (B, Hkv, rep, S, D)
    for q0 in range(0, s, block_q):
        q1 = min(s, q0 + block_q)
        lo = max(0, q0 - window + 1) if window else 0
        hi = q1 if causal else s
        sc = torch.einsum("bgrqd,bgkd->bgrqk", qf[:, :, :, q0:q1],
                          kf[:, :, lo:hi]) * scale
        qp = torch.arange(q0, q1, dtype=torch.int32, device=q.device)[:, None]
        kp = torch.arange(lo, hi, dtype=torch.int32, device=q.device)[None]
        mask = torch.ones((q1 - q0, hi - lo), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= kp <= qp
        if window:
            mask &= kp > qp - window
        p = torch.softmax(torch.where(mask, sc, NEG), dim=-1)
        out[:, :, :, q0:q1] = torch.einsum("bgrqk,bgkd->bgrqd", p,
                                           vf[:, :, lo:hi])
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, d).to(q.dtype)
