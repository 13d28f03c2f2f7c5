"""The port's steps, the counterpart of ``repro.launch.steps``:
plan selection, input specs, the train state and its shardings, the train
step and the serving steps, on one device or on a ``DeviceMesh``.

The train state is ``{"params", "opt", "err"}``: the bf16 parameters, an
``optim.AdamWState`` and the error-feedback residuals (None without
gradient compression), each a dict keyed by the parameters' dotted names,
so ``checkpoint`` saves and restores it as it is.  The model holds the
parameters it runs with: a step first loads ``state["params"]`` into it
where they are other tensors (a restored checkpoint), and writes the
updated bf16 parameters back into it.

On a mesh (``make_train_step(model, hyper, mesh)``, ``make_prefill_fn``,
``make_decode_fn``) the model's parameters become ``DTensor``s laid out as
``sharding.param_shardings``, the batch and caches as ``data_shardings`` /
``cache_shardings``; the model runs on them with the plan's hints, plain
tensors (RoPE tables, masks) taken as replicated.  The optimizer state
lives in the ZeRO-1 layout (``zero1_shardings``): each microbatch's
gradients are redistributed to it (the reference's ZeRO-2
reduce-scatter), AdamW runs on the local shards, and the new bf16
parameters are redistributed back to their own layout.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import ModelConfig, ShapeConfig
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import dp_axes, mesh_axes
from repro_torch.models import transformer, whisper
from repro_torch.models.plan import Plan
from repro_torch.optim import (AdamWState, adamw_init, adamw_update,
                               cosine_schedule, ef_init, ef_int8_compress)
from repro_torch.spmd import is_dtensor


def make_plan(cfg: ModelConfig, shape: ShapeConfig, mesh=None, *,
              overrides: Optional[dict] = None) -> Plan:
    """The reference's choices for (arch, shape): training recomputes
    every layer in the backward, accumulates 4 microbatches above 30e9
    parameters and drops MoE tokens past capacity 1.25; a big model's
    decode keeps an int8 KV cache; serving is drop-free.  With a ``mesh``
    also its axis sizes (``tp``, ``dp``, ``pods``), FSDP for a big model's
    training, sequence-sharded decode for ``long_500k``, and with TP the
    sequence-sharded residual stream in training (``act_pspec``) and the
    interior hints (``hint_dp``)."""
    big = cfg.n_params() > 30e9
    train = shape.kind == "train"
    kw: Dict[str, Any] = dict(
        kv_quant=(shape.kind == "decode" and big),
        remat="full" if train else "none",
        microbatches=4 if (train and big) else 1,
        moe_capacity=1.25 if train else 0.0,
    )
    tp, dpa = 1, None
    if mesh is not None:
        ax = mesh_axes(mesh)
        tp = ax.get("model", 1)
        pods = ax.get("pod", 1)
        kw.update(tp=tp, dp=math.prod(ax[a] for a in dp_axes(mesh)),
                  pods=pods, fsdp=(train and big),
                  seq_shard_decode=(shape.name == "long_500k"))
        dpa = ("pod", "data") if pods > 1 else "data"
        if train and tp > 1:
            kw["act_pspec"] = (dpa, "model", None)
    if overrides:
        kw.update(overrides)
    plan = Plan(**kw)
    if tp > 1:
        object.__setattr__(plan, "hint_dp", dpa)   # enable interior hints
    return plan


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Meta-device stand-ins of one step's batch (no allocation)."""
    b, s = shape.global_batch, shape.seq_len
    i32, bf16 = torch.int32, torch.bfloat16

    def sds(shp, dt):
        return torch.empty(shp, dtype=dt, device="meta")
    if shape.kind == "decode":
        return {"tokens": sds((b, 1), i32)}
    if cfg.family == "vlm":
        nv = cfg.n_vision_tokens
        out = {"tokens": sds((b, s - nv), i32),
               "vision_embeds": sds((b, nv, cfg.d_model), bf16),
               "positions3": sds((3, b, s), i32)}
        if shape.kind == "train":
            out["targets"] = sds((b, s - nv), i32)
        return out
    if cfg.is_encdec:
        out = {"audio_embeds": sds((b, cfg.n_audio_frames, cfg.d_model),
                                   bf16),
               "tokens": sds((b, s), i32)}
        if shape.kind == "train":
            out["targets"] = sds((b, s), i32)
        return out
    out = {"tokens": sds((b, s), i32)}
    if shape.kind == "train":
        out["targets"] = sds((b, s), i32)
    return out


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


def abstract_train_state(model, hyper: Hyper):
    """The train state as meta-device tensors (no allocation)."""
    params = model.abstract_params()

    def f32(t):
        return torch.empty(t.shape, dtype=torch.float32, device="meta")
    opt = AdamWState(m={n: f32(p) for n, p in params.items()},
                     v={n: f32(p) for n, p in params.items()},
                     master={n: f32(p) for n, p in params.items()},
                     count=torch.empty((), dtype=torch.int32, device="meta"))
    err = {n: f32(p) for n, p in params.items()} if hyper.grad_compress \
        else None
    return {"params": params, "opt": opt, "err": err}


def train_state_shardings(model, mesh, hyper: Hyper):
    """The train state's shardings: the parameters' own (FSDP under
    ``plan.fsdp``), ZeRO-1 for the optimizer leaves and the residuals, the
    step count replicated."""
    axes, abstract = model.logical_axes(), model.abstract_params()
    p_sh = shd.param_shardings(axes, mesh, fsdp=model.plan.fsdp,
                               abstract=abstract,
                               counts=shd.stack_counts(model.cfg))
    z_sh = shd.zero1_shardings(axes, abstract, mesh)
    opt = AdamWState(m=z_sh, v=z_sh, master=z_sh,
                     count=shd.replicated(mesh))
    return {"params": p_sh, "opt": opt,
            "err": z_sh if hyper.grad_compress else None}


def lay_out(t: torch.Tensor, sharding) -> torch.Tensor:
    """A tensor that every rank holds whole -> its ``DTensor`` in
    ``sharding``'s layout, each rank keeping its own slice (no
    communication); a ``DTensor`` is redistributed; a meta tensor becomes
    a meta ``DTensor`` of the local shard's shape."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    mesh, want = sharding.mesh, sharding.placements
    if is_dtensor(t):
        return t if tuple(t.placements) == want else \
            t.redistribute(mesh, want)
    if t.device.type == "meta":
        local = torch.empty(sharding.shard_shape(t.shape), dtype=t.dtype,
                            device="meta")
        return DTensor.from_local(local, mesh, want, run_check=False,
                                  shape=t.shape, stride=t.stride())
    return distribute_tensor(t, mesh, want, src_data_rank=None)


def lay_out_tree(tree, shardings):
    """``lay_out`` over matching dicts, lists, tuples and NamedTuples
    (ints and Nones pass)."""
    if isinstance(tree, torch.Tensor):
        return lay_out(tree, shardings)
    if isinstance(tree, dict):
        return {k: lay_out_tree(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(lay_out_tree(v, s) for v, s in
                            zip(tree, shardings)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(lay_out_tree(v, s) for v, s in
                          zip(tree, shardings))
    return tree


def shard_model(model, shardings) -> None:
    """Replace each of the model's parameters by its ``DTensor`` in
    ``shardings[name]``'s layout (its ``requires_grad`` kept)."""
    from torch import nn
    for name, mod in model.named_modules():
        for pname, p in list(mod.named_parameters(recurse=False)):
            full = f"{name}.{pname}" if name else pname
            new = nn.Parameter(lay_out(p.detach(), shardings[full]),
                               requires_grad=p.requires_grad)
            setattr(mod, pname, new)


def full(t):
    """A ``DTensor`` gathered whole on every rank; a tensor as it is."""
    return t.full_tensor() if is_dtensor(t) else t


def _spmd():
    """Plain tensors in a ``DTensor`` op are taken as replicated."""
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


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


def make_train_step(model, hyper: Hyper, mesh=None):
    """-> ``step(state, batch) -> (state, metrics)``: value and grad of
    ``model.loss`` (over ``plan.microbatches`` microbatches, the gradients
    accumulated in f32 and divided by their count, the loss and metrics
    averaged), optional error-feedback int8 compression,
    ``cosine_schedule`` at the optimizer's count, ``adamw_update``, and the
    new bf16 parameters written back into the model.  ``batch`` holds
    tensors on the model's device; nothing is read back to the host.

    With a ``mesh`` the step is ``_sharded_train_step``'s."""
    if mesh is not None:
        return _sharded_train_step(model, hyper, mesh)
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


def shard_train_state(state, shardings):
    """A train state that every rank holds whole (``init_train_state``'s)
    -> its ``DTensor``s in ``train_state_shardings``' layouts; the step
    count stays a plain tensor (replicated)."""
    opt = state["opt"]
    sh = shardings["opt"]
    return {"params": lay_out_tree(state["params"], shardings["params"]),
            "opt": AdamWState(m=lay_out_tree(opt.m, sh.m),
                              v=lay_out_tree(opt.v, sh.v),
                              master=lay_out_tree(opt.master, sh.master),
                              count=opt.count),
            "err": None if state["err"] is None else
            lay_out_tree(state["err"], shardings["err"])}


def _sharded_train_step(model, hyper: Hyper, mesh):
    """The train step on ``mesh``.  The model's parameters are laid out as
    ``train_state_shardings``' ``params`` (its state must be
    ``shard_train_state``'s); ``batch`` holds whole tensors (the same on
    every rank), cut into microbatches and laid out per
    ``data_shardings``.  Each microbatch's gradients are redistributed to
    the ZeRO layout (``opt.m``'s, a reduce-scatter over the data axes)
    and accumulated there in f32; AdamW's global-norm clip reduces across
    the shards, its update runs on the local shards, and the new bf16
    parameters are redistributed back to the parameters' layout.  The
    metrics come back whole."""
    plan = model.plan
    sh = train_state_shardings(model, mesh, hyper)
    shard_model(model, sh["params"])
    named = dict(model.named_parameters())
    zero = {n: s.placements for n, s in sh["opt"].m.items()}
    own = {n: s.placements for n, s in sh["params"].items()}

    def grads_of(batch):
        for p in named.values():
            p.grad = None
        loss, metrics = model.loss(batch)
        loss.backward()
        grads = {n: p.grad.redistribute(mesh, zero[n])
                 for n, p in named.items()}
        for p in named.values():
            p.grad = None
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads

    def step(state, batch):
        batch = {k: full(v) for k, v in batch.items()}
        with torch.no_grad():
            for n, t in state["params"].items():
                if t is not named[n] and not (
                        is_dtensor(t) and t.to_local().data_ptr() ==
                        named[n].to_local().data_ptr()):
                    named[n].copy_(lay_out(t, sh["params"][n]))
        mb = plan.microbatches
        parts = split_microbatches(batch, mb) if mb > 1 else [batch]
        with _spmd():
            losses, ms, acc = [], [], None
            for part in parts:
                part = lay_out_tree(part, shd.data_shardings(part, mesh))
                loss, m, g = grads_of(part)
                losses.append(full(loss))
                ms.append({k: full(v) for k, v in m.items()})
                if acc is None:
                    acc = {n: x.float() for n, x in g.items()}
                else:
                    for n, x in g.items():
                        acc[n] = acc[n] + x.float()
            if mb > 1:
                div = torch.full((), float(mb), device=losses[0].device)
                grads = {n: x / div for n, x in acc.items()}
                loss = torch.stack(losses).mean()
                metrics = {k: torch.stack([m[k] for m in ms]).mean()
                           for k in ms[0]}
            else:
                grads, loss, metrics = acc, losses[0], ms[0]
            err = state["err"]
            if hyper.grad_compress:
                grads, err = ef_int8_compress(grads, err)
            lr = cosine_schedule(state["opt"].count, peak=hyper.peak_lr,
                                 warmup=hyper.warmup,
                                 total=hyper.total_steps)
            new_params, opt = adamw_update(grads, state["opt"], lr=lr)
            with torch.no_grad():
                for n, t in new_params.items():
                    named[n].copy_(t.redistribute(mesh, own[n]))
        params = {n: p.detach() for n, p in named.items()}
        metrics = dict(metrics, loss=loss, lr=lr)
        return {"params": params, "opt": opt, "err": err}, metrics

    return step


# --------------------------------------------------------------------------
# Serve steps
# --------------------------------------------------------------------------

def _abstract_caches(model, shape: ShapeConfig):
    """The decode caches of ``shape`` as meta-device tensors."""
    cfg, plan = model.cfg, model.plan
    init = whisper.init_caches if cfg.is_encdec else transformer.init_caches
    return init(cfg, plan, shape.global_batch, shape.seq_len, device="meta")


def _cross_abstract(model, shape: ShapeConfig):
    """Whisper's cross-attention K/V stand-ins: one (B, F, Hkv, D) tensor
    per decoder layer, for K and for V."""
    cfg, plan = model.cfg, model.plan
    hkv = plan.padded_kv_heads(cfg.n_kv_heads)
    a = [torch.empty((shape.global_batch, cfg.n_audio_frames, hkv, cfg.hd),
                     dtype=torch.bfloat16, device="meta")
         for _ in range(cfg.n_layers)]
    return a, list(a)


def make_prefill_fn(model, mesh, shape: ShapeConfig):
    """-> (``prefill(batch, caches) -> (caches, last logits)``, (param
    shardings, batch stand-ins, cache stand-ins)).  The model's
    parameters are laid out as ``param_shardings``; ``batch`` and
    ``caches`` hold whole tensors or ``DTensor``s and are laid out as
    ``data_shardings`` / ``cache_shardings``; the caches come back laid
    out (Whisper's with its cross-attention K/V), the logits whole."""
    cfg = model.cfg
    p_sh = shd.param_shardings(model.logical_axes(), mesh)
    shard_model(model, p_sh)
    batch_abs = input_specs(cfg, shape)
    caches_abs = _abstract_caches(model, shape)
    c_sh = shd.cache_shardings(caches_abs, mesh)
    out_c_sh = c_sh
    if cfg.is_encdec:
        out_c_sh = shd.cache_shardings(
            whisper.WhisperCache(caches_abs, _cross_abstract(model, shape)),
            mesh)

    def prefill(batch, caches):
        batch = lay_out_tree(batch, shd.data_shardings(batch, mesh))
        caches = lay_out_tree(caches, c_sh)
        with _spmd():
            caches, logits = model.prefill(batch, caches)
            caches = lay_out_tree(caches, out_c_sh)
        return caches, full(logits)

    return prefill, (p_sh, batch_abs, caches_abs)


def make_decode_fn(model, mesh, shape: ShapeConfig):
    """-> (``decode(caches, tokens, pos) -> (caches, logits)``, param
    shardings, cache shardings, cache stand-ins): one new token against a
    ``shape.seq_len`` cache, the caches laid out as ``cache_shardings``
    (the KV sequence over the data axes under ``plan.seq_shard_decode``),
    the tokens' batch over the data axes (replicated under it); the
    logits come back whole."""
    cfg, plan = model.cfg, model.plan
    p_sh = shd.param_shardings(model.logical_axes(), mesh)
    shard_model(model, p_sh)
    abstract = _abstract_caches(model, shape)
    if cfg.is_encdec:
        abstract = whisper.WhisperCache(abstract,
                                        _cross_abstract(model, shape))
    c_sh = shd.cache_shardings(abstract, mesh,
                               seq_shard=plan.seq_shard_decode)
    dp = dp_axes(mesh)
    dp = dp[0] if len(dp) == 1 else dp
    tok_sh = shd.NamedSharding(mesh, (None if plan.seq_shard_decode
                                      else dp, None))

    def decode(caches, tokens, pos: int):
        caches = lay_out_tree(caches, c_sh)
        tokens = lay_out(full(tokens), tok_sh)
        with _spmd():
            caches, logits = model.decode_step(caches, tokens, pos)
            caches = lay_out_tree(caches, c_sh)
        return caches, full(logits)

    return decode, p_sh, c_sh, abstract
