"""Dispatch of the FIGCache-KV decode step's transaction over model-shaped
tensors: CUDA kernel or plain PyTorch version.

The choice follows the tensors alone: CPU tensors go to the plain version
(``ref.py``), CUDA tensors launch the kernel (``figkv_tx.py``) or raise.
There is no fallback from the kernel to the plain version.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.configs import FIGKVConfig
from repro_torch.core import fts as fts_lib
from repro_torch.kernels.figkv_tx.figkv_tx import figkv_tx as _kernel
from repro_torch.kernels.figkv_tx.ref import figkv_tx_ref


def as_rows(x: torch.Tensor) -> torch.Tensor:
    """A (B, n, *seg_shape) pool or fast pool as (B, n, E) rows, a view
    (never a copy: a segment that is not one run of E elements raises)."""
    return x.view(x.shape[0], x.shape[1], math.prod(x.shape[2:]))


def figkv_tx(sel: torch.Tensor, step: int, n_live: int, fts: fts_lib.FTS,
             seg_k: torch.Tensor, seg_v: torch.Tensor, fast_k: torch.Tensor,
             fast_v: torch.Tensor, fig: FIGKVConfig
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One FIGCache-KV decode step's tag-store transaction and K/V moves,
    IN PLACE on the FTS leaves ``fts`` (B, ...) and the fast pools.

    sel (B, n_sel) int32, distinct ids a row (the step's selection);
    ``step`` the position; ids below ``n_live`` are insertable.
    seg_k/seg_v (B, n_segs, *seg_shape) segment views of the slow pools
    (any sequence and segment strides), fast_k/fast_v (B, slots,
    *seg_shape).  Returns (slots (B, n_sel): the fast-pool slot each
    selected id is read from, -1 for the slow pool; ins_seg (B,); ins_slot
    (B,)), int32, -1 where nothing was inserted."""
    if tuple(fast_k.shape[2:]) != tuple(seg_k.shape[2:]) \
            or tuple(fast_v.shape[2:]) != tuple(seg_v.shape[2:]):
        raise ValueError(f"figkv_tx: segments of pools {tuple(seg_k.shape)} "
                         f"and fast pools {tuple(fast_k.shape)} differ")
    rows = [as_rows(x) for x in (seg_k, seg_v, fast_k, fast_v)]
    if sel.device.type == "cpu":
        return figkv_tx_ref(sel, step, n_live, fts, *rows, fig)
    return _kernel(sel, step, n_live, fts, *rows, fig)
