"""Plain PyTorch version of the fused FTS lookup (bit-exact), batched over
lanes.  The CPU path of ``ops.fts_lookup_op`` and the oracle the CUDA kernel
is held against on the card."""
from __future__ import annotations

import torch

BIG = 1 << 30


def fts_lookup_ref(tags: torch.Tensor, score: torch.Tensor,
                   bank: torch.Tensor, seg: torch.Tensor,
                   limit: torch.Tensor) -> torch.Tensor:
    """tags/score (N, n_banks, S) int32; bank/seg/limit (N,) int32 ->
    (N, 3) int32 ``[hit, hit_slot, victim_cand]`` for each lane's bank row.

    ``hit_slot`` is the first slot whose tag equals ``seg`` (``S`` when
    none does); ``victim_cand`` is the first index of the minimum of
    ``score`` masked to ``idx < limit`` (BIG outside), so ``limit <= 0``
    gives 0 — the same ties as ``jnp.argmin``."""
    lanes = torch.arange(tags.shape[0], device=tags.device)
    b = bank.long()
    tags_b = tags[lanes, b]
    score_b = score[lanes, b]
    s = tags_b.shape[-1]
    idx = torch.arange(s, dtype=torch.int32, device=tags.device)
    m = tags_b == seg[:, None]
    hit_slot = torch.where(m, idx, s).amin(dim=-1)
    masked = torch.where(idx < limit[:, None], score_b, BIG)
    cand = torch.argmin(masked, dim=-1).to(torch.int32)
    return torch.stack([m.any(dim=-1).to(torch.int32), hit_slot, cand],
                       dim=-1)
