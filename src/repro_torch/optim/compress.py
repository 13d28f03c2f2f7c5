"""Error-feedback int8 gradient compression, the port's counterpart of
``repro.optim.compress``.

Each gradient is quantized to int8 with a per-tensor scale, and the
quantization residual is carried to the next step (error feedback keeps
the accumulated update unbiased).  What lands in the optimizer is the
dequantized gradient, the numerics of the compressed pipeline; on a mesh
the gradients arrive already reduced into the ZeRO layout.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

Tree = Dict[str, torch.Tensor]


def _q(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x f32 -> (int8 codes, f32 scale ``max|x| / 127``): ``round(x /
    max(scale, 1e-20))`` (half to even, as ``jnp.round``) clipped to
    +-127.  The divisors are tensors on x's device."""
    scale = x.abs().amax() / torch.full((), 127.0, device=x.device)
    q = torch.clamp(torch.round(x / torch.clamp(scale, min=1e-20)),
                    -127, 127)
    return q.to(torch.int8), scale


def ef_int8_compress(grads: Tree, err: Tree) -> Tuple[Tree, Tree]:
    """-> (dequantized grads, new error state), leaf by leaf."""
    deq, new_err = {}, {}
    for n, g in grads.items():
        gf = g.float() + err[n]
        q, s = _q(gf)
        deq[n] = q.float() * s
        new_err[n] = gf - deq[n]
    return deq, new_err


def ef_init(params: Tree) -> Tree:
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in params.items()}
