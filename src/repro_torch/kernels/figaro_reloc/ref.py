"""Plain PyTorch version of the FIGARO RELOC kernel (bit-exact), batched
over groups.  The CPU path of ``ops.reloc_segments`` and the oracle the
CUDA kernel is held against on the card."""
from __future__ import annotations

import torch


def reloc_ref(pool: torch.Tensor, fast: torch.Tensor, src: torch.Tensor,
              dst: torch.Tensor) -> torch.Tensor:
    """``fast[g, dst[g, m]] <- pool[g, src[g, m]]``, in place on ``fast``.

    pool (G, n_segs, E), fast (G, n_slots, E); src/dst (G, M) int32.  A
    move with a negative (or out-of-range) id leaves its destination alone,
    like a RELOC without chip-select.  The moves run one after another,
    each over all groups, so a masked move never undoes a real one."""
    g, n_segs, _ = pool.shape
    n_slots = fast.shape[1]
    if g == 0 or n_segs == 0 or n_slots == 0:
        return fast
    groups = torch.arange(g, device=fast.device)
    for m in range(src.shape[1]):
        s, d = src[:, m], dst[:, m]
        ok = (s >= 0) & (d >= 0) & (s < n_segs) & (d < n_slots)
        sc = s.clamp(0, n_segs - 1).long()
        dc = d.clamp(0, n_slots - 1).long()
        fast[groups, dc] = torch.where(ok[:, None], pool[groups, sc],
                                       fast[groups, dc])
    return fast
