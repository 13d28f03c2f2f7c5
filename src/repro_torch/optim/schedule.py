"""LR schedules, the port's counterpart of ``repro.optim.schedule``."""
from __future__ import annotations

import math

import torch

from repro_torch.models.sincosf import sincos_f32


def cosine_schedule(step, *, peak: float, warmup: int, total: int,
                    floor_frac: float = 0.1) -> torch.Tensor:
    """Linear warmup to ``peak`` over ``warmup`` steps, then a cosine down
    to ``floor_frac * peak`` at ``total`` -> an f32 scalar tensor on
    ``step``'s device (an int is taken on the CPU).

    The reference's f32 operations in its order; the divisors are tensors
    on the step's device (CUDA divides by a Python scalar through its
    reciprocal) and the cosine is glibc's ``cosf`` (``sincos_f32``), which
    the reference's CPU build calls, so on the CPU the values are
    ``jnp``'s bits."""
    s = torch.as_tensor(step).float()
    div = lambda n: torch.full((), float(max(1, n)), device=s.device)
    warm = peak * s / div(warmup)
    prog = torch.clamp((s - warmup) / div(total - warmup), 0.0, 1.0)
    cos = peak * (floor_frac + (1 - floor_frac) * 0.5 *
                  (1 + sincos_f32(math.pi * prog)[1]))
    return torch.where(s < warmup, warm, cos)
