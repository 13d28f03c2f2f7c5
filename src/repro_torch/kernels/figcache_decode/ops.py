"""Dispatch of FIGCache-KV decode attention over model-layout tensors: CUDA
kernel or plain PyTorch version.

The choice follows the tensors alone: a CPU tensor goes to the plain
version (``ref.py``), a CUDA tensor launches the kernel
(``figcache_decode.py``) or raises.  There is no fallback from the kernel
to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.figcache_decode.figcache_decode import \
    figcache_decode
from repro_torch.kernels.figcache_decode.ref import figcache_decode_ref


def decode_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  valid: torch.Tensor) -> torch.Tensor:
    """q (B, 1, H, D); k/v (B, L, Hkv, D) with ``H % Hkv == 0``; valid
    (B, L) bool -> (B, 1, H, D).

    With Hkv = H (heads repeated) this is the JAX package's
    ``decode_attend``; with Hkv < H, query head h reads KV head
    ``h // (H // Hkv)`` and K/V are never repeated."""
    q3 = q[:, 0]
    if q.device.type == "cpu":
        out = figcache_decode_ref(q3, k, v, valid)
    else:
        out = figcache_decode(q3.contiguous(), k.contiguous(),
                              v.contiguous(), valid.contiguous())
    return out[:, None]
