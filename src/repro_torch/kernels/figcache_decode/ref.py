"""Plain PyTorch version of the FIGCache-KV decode attention kernel.  The
CPU path of ``ops.decode_attend`` and the oracle the CUDA kernel is held
against on the card."""
from __future__ import annotations

import torch

NEG = -1e30


def figcache_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        valid: torch.Tensor) -> torch.Tensor:
    """q (B, H, D); k/v (B, L, Hkv, D), query head h reading KV head
    ``h // (H // Hkv)``; valid (B, L) -> (B, H, D) in q's dtype.

    f32 scores scaled by D^-0.5, the finite -1e30 on masked entries (a
    fully masked row averages v uniformly), softmax, f32 ``p @ v``."""
    b, h, d = q.shape
    hkv = k.shape[2]
    qf = q.float().reshape(b, hkv, h // hkv, d)
    s = torch.einsum("bgrd,blgd->bgrl", qf, k.float()) * (d ** -0.5)
    s = torch.where(valid[:, None, None, :], s, NEG)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrl,blgd->bgrd", p, v.float())
    return o.reshape(b, h, d).to(q.dtype)
