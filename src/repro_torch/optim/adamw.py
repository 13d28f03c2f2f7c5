"""AdamW with f32 master weights, the port's counterpart of
``repro.optim.adamw``.

A state's leaves are dicts keyed by the parameters' dotted names
(``stack.layers.3.attn.wq``), so ``checkpoint`` saves them as they are;
the bf16 forward params are re-derived from the f32 master copy each step.
On a mesh the leaves are ``DTensor``s in the ZeRO-1 layout
(``launch.steps``' sharded step): the update runs on the local shards and
the global norm's sums reduce across them.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from repro_torch.core.workload.xla_math import pow_f32

Tree = Dict[str, torch.Tensor]


class AdamWState(NamedTuple):
    m: Tree
    v: Tree
    master: Tree          # f32 master weights
    count: torch.Tensor   # () int32: updates taken


def adamw_init(params: Tree) -> AdamWState:
    dev = next(iter(params.values())).device
    return AdamWState(
        m={n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for n, p in params.items()},
        v={n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for n, p in params.items()},
        master={n: p.detach().float().clone() for n, p in params.items()},
        count=torch.zeros((), dtype=torch.int32, device=dev))


def global_norm(grads: Tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares."""
    gsq = sum(g.float().square().sum() for g in grads.values())
    return torch.sqrt(gsq)


@torch.no_grad()
def adamw_update(grads: Tree, state: AdamWState, *, lr: torch.Tensor,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1,
                 grad_clip: float = 1.0) -> tuple[Tree, AdamWState]:
    """One step -> (new bf16 params, new state).  The gradients are clipped
    to a global norm of ``grad_clip``; the bias corrections are ``1 -
    b ** count`` in f32 (glibc's ``powf``, as the reference's CPU build).
    Every divisor is a tensor on the state's device."""
    count = state.count + 1
    dev = count.device
    gnorm = global_norm(grads)
    clip = torch.full((), grad_clip, device=dev)
    scale = torch.clamp(clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    c = count.float()
    bc1 = 1 - pow_f32(torch.full((), b1, device=dev), c)
    bc2 = 1 - pow_f32(torch.full((), b2, device=dev), c)

    m, v, master = {}, {}, {}
    for n, g in grads.items():
        g = g.float() * scale
        m[n] = b1 * state.m[n] + (1 - b1) * g
        v[n] = b2 * state.v[n] + (1 - b2) * g.square()
        step = (m[n] / bc1) / (torch.sqrt(v[n] / bc2) + eps)
        w = state.master[n]
        master[n] = w - lr * (step + weight_decay * w)
    params = {n: w.to(torch.bfloat16) for n, w in master.items()}
    return params, AdamWState(m=m, v=v, master=master, count=count)
