"""The port's trainer steps: plan selection and the train step
on one device (the port's counterpart of the one-device part of
``repro.launch.steps``).

The train state is ``{"params", "opt", "err"}``: the bf16 parameters, an
``optim.AdamWState`` and the error-feedback residuals (None without
gradient compression), each a dict keyed by the parameters' dotted names,
so ``checkpoint`` saves and restores it as it is.  The model holds the
parameters it runs with: a step first loads ``state["params"]`` into it
where they are other tensors (a restored checkpoint), and writes the
updated bf16 parameters back into it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import ModelConfig, ShapeConfig
from repro_torch.models.plan import Plan
from repro_torch.optim import (adamw_init, adamw_update, cosine_schedule,
                               ef_init, ef_int8_compress)


def make_plan(cfg: ModelConfig, shape: ShapeConfig, *,
              overrides: Optional[dict] = None) -> Plan:
    """The reference's choices for (arch, shape) on one device: training
    recomputes every layer in the backward, accumulates 4 microbatches
    above 30e9 parameters and drops MoE tokens past capacity 1.25; a big
    model's decode keeps an int8 KV cache; serving is drop-free."""
    big = cfg.n_params() > 30e9
    train = shape.kind == "train"
    kw: Dict[str, Any] = dict(
        kv_quant=(shape.kind == "decode" and big),
        remat="full" if train else "none",
        microbatches=4 if (train and big) else 1,
        moe_capacity=1.25 if train else 0.0,
    )
    if overrides:
        kw.update(overrides)
    return Plan(**kw)


@dataclasses.dataclass(frozen=True)
class Hyper:
    peak_lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10000
    grad_compress: bool = False   # int8 error feedback on the gradients


def init_train_state(model, generator: Optional[torch.Generator],
                     hyper: Hyper):
    """Turn the model's gradients on and build its train state.  The
    weights are drawn from ``generator``; with None the model keeps the
    weights it holds (loaded ones)."""
    if generator is not None:
        model.init_params(generator)
    model.trainable()
    params = {n: p.detach() for n, p in model.named_parameters()}
    return {"params": params, "opt": adamw_init(params),
            "err": ef_init(params) if hyper.grad_compress else None}


def split_microbatches(batch: Dict[str, torch.Tensor], mb: int):
    """``mb`` microbatches of ``batch``: each leaf cut into ``mb`` equal
    parts along dim 0 (``positions3`` (3, B, S) along dim 1), a leaf whose
    dim 0 does not divide repeated whole, as the reference."""
    parts = [{} for _ in range(mb)]
    for k, a in batch.items():
        if k == "positions3":
            cut = a.chunk(mb, dim=1)
        elif a.dim() >= 1 and a.shape[0] % mb == 0:
            cut = a.chunk(mb, dim=0)
        else:
            cut = [a] * mb
        for part, c in zip(parts, cut):
            part[k] = c
    return parts


def make_train_step(model, hyper: Hyper):
    """-> ``step(state, batch) -> (state, metrics)``: value and grad of
    ``model.loss`` (over ``plan.microbatches`` microbatches, the gradients
    accumulated in f32 and divided by their count, the loss and metrics
    averaged), optional error-feedback int8 compression,
    ``cosine_schedule`` at the optimizer's count, ``adamw_update``, and the
    new bf16 parameters written back into the model.  ``batch`` holds
    tensors on the model's device; nothing is read back to the host."""
    plan = model.plan
    named = dict(model.named_parameters())

    def grads_of(batch):
        for p in named.values():
            p.grad = None
        loss, metrics = model.loss(batch)
        loss.backward()
        grads = {n: p.grad for n, p in named.items()}
        for p in named.values():
            p.grad = None
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads

    def step(state, batch):
        with torch.no_grad():
            for n, t in state["params"].items():
                if t.data_ptr() != named[n].data_ptr():
                    named[n].copy_(t)
        mb = plan.microbatches
        if mb > 1:
            losses, ms, acc = [], [], None
            for part in split_microbatches(batch, mb):
                loss, m, g = grads_of(part)
                losses.append(loss)
                ms.append(m)
                if acc is None:
                    acc = {n: x.float() for n, x in g.items()}
                else:
                    for n, x in g.items():
                        acc[n] += x.float()
            div = torch.full((), float(mb), device=losses[0].device)
            grads = {n: x / div for n, x in acc.items()}
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k] for m in ms]).mean()
                       for k in ms[0]}
        else:
            loss, metrics, grads = grads_of(batch)
        err = state["err"]
        if hyper.grad_compress:
            grads, err = ef_int8_compress(grads, err)
        lr = cosine_schedule(state["opt"].count, peak=hyper.peak_lr,
                             warmup=hyper.warmup, total=hyper.total_steps)
        new_params, opt = adamw_update(grads, state["opt"], lr=lr)
        with torch.no_grad():
            for n, t in new_params.items():
                named[n].copy_(t)
        params = {n: p.detach() for n, p in named.items()}
        metrics = dict(metrics, loss=loss, lr=lr)
        return {"params": params, "opt": opt, "err": err}, metrics

    return step
