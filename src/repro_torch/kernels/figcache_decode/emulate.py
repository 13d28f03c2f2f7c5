"""A model of the CUDA kernel (``csrc/figcache_decode.cu``) in PyTorch, on
any device: its plan (``figcache_decode.plan``: the split count, the split
boundaries, the chunks of each split), the split-local softmax state and
the combine of the splits in rank order.

Not on any main path: the kernel's split and combine logic cannot run on
the CPU, so the tests hold this model against the plain version and the
JAX package's kernel there, on the edge shapes (ragged and empty splits,
fully masked splits and rows).  Per split, in f32: the running max from
-1e30, per chunk the scores (q . k) * D^-0.5 with -1e30 on masked keys,
the chunk max, the probabilities exp(s - m_new) of the split's keys only
(keys past the split's end do not exist for it: p = 0), the rescale
exp(m - m_new) of the running sum l and of acc before p @ v is added.
The combine: m = max over the splits, weights exp(m_s - m), the
denominator and the output summed over the splits in rank order, the
output acc * (1 / max(l, 1e-30)) in the input dtype.  It does not
reproduce the kernel's summation order inside a dot product or across its
key parts, nor the bf16 kernel's approximate exp (ex2.approx) and its P
held as two bf16 parts.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.figcache_decode.figcache_decode import (
    plan, split_bounds)

NEG = -1e30


def figcache_decode_emulated(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, valid: torch.Tensor, *,
                             splits: Optional[int] = None) -> torch.Tensor:
    """q (B, H, D), k/v (B, L, Hkv, D), valid (B, L) bool -> (B, H, D) in
    q's dtype, through the kernel's plan (``splits`` as the wrapper's)."""
    b, h, d = q.shape
    length, hkv = k.shape[1], k.shape[2]
    p = plan(b, h, hkv, length, d, q.element_size(), splits)
    qf = q.float().reshape(b, hkv, h // hkv, d)
    kf, vf = k.float(), v.float()
    scale = torch.tensor(d ** -0.5, dtype=torch.float32)
    neg = torch.tensor(NEG, dtype=torch.float32, device=q.device)
    states = []                             # (m, l, acc) of each split
    for lo, hi in split_bounds(length, p.splits):
        m = torch.full((b, hkv, h // hkv), NEG, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(qf)
        for c0 in range(lo, hi, p.chunk):
            c1 = min(hi, c0 + p.chunk)
            s = torch.einsum("bgrd,blgd->bgrl", qf, kf[:, c0:c1]) * scale
            s = torch.where(valid[:, None, None, c0:c1], s, neg)
            m_new = torch.maximum(m, s.amax(-1))
            e = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + e.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bgrl,blgd->bgrd", e, vf[:, c0:c1])
            m = m_new
        states.append((m, l, acc))
    m = torch.stack([st[0] for st in states]).amax(0)
    den = torch.zeros_like(m)
    out = torch.zeros_like(qf)
    for m_s, l_s, acc_s in states:          # rank order
        w = torch.exp(m_s - m)
        den = den + w * l_s
        out = out + w[..., None] * acc_s
    out = out * (1.0 / den.clamp_min(1e-30))[..., None]
    return out.reshape(b, h, d).to(q.dtype)
