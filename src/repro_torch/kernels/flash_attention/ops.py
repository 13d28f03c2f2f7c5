"""Dispatch of prefill attention over model-layout tensors: CUDA kernel or
plain PyTorch version.

The choice follows the tensors alone: a CPU tensor goes to the plain
version (``ref.py``), a CUDA tensor launches the kernel
(``flash_attention.py``) or raises.  There is no fallback from the kernel
to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.flash_attention import \
    flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True, window: int = 0,
        scale: float | None = None) -> torch.Tensor:
    """q (B, S, H, D); k/v (B, S, Hkv, D) with ``H % Hkv == 0`` ->
    (B, S, H, D), the f32 scores scaled by ``scale`` (default D^-0.5).

    With Hkv = H this is the JAX package's ``mha``; with Hkv < H, query
    head h reads KV head ``h // (H // Hkv)`` and K/V are never repeated."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   scale=scale)
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=causal, window=window, scale=scale)
