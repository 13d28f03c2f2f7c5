"""Dispatch of the fused FTS lookup: CUDA kernel or plain PyTorch version.

The choice follows the tensors alone: a CPU tensor goes to the plain
version (``ref.py``), a CUDA tensor launches the kernel (``fts_lookup.py``)
or raises.  There is no fallback from the kernel to the plain version.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.fts_lookup.fts_lookup import fts_lookup
from repro_torch.kernels.fts_lookup.ref import fts_lookup_ref


def fts_lookup_op(tags: torch.Tensor, score: torch.Tensor,
                  bank: torch.Tensor, seg: torch.Tensor, limit: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (hit: bool (N,), hit_slot: int32 (N,), victim_cand: int32 (N,)).

    tags/score (N, n_banks, S) int32; bank/seg/limit (N,) int32 select each
    lane's bank row, the looked-up segment id and the active-prefix length
    of the victim argmin."""
    if tags.device.type == "cpu":
        out = fts_lookup_ref(tags, score, bank, seg, limit)
    else:
        out = fts_lookup(tags, score, bank, seg, limit)
    return out[:, 0] != 0, out[:, 1], out[:, 2]
