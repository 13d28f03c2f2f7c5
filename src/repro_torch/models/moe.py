"""Mixture-of-Experts FFN: top-k routing, sort-based dispatch into
per-expert buffers of a static capacity, shared experts (DeepSeek-V2).

The port's counterpart of ``repro.models.moe``, with the reference's casts
and orders step for step: the router in f32, the softmax over the top k
only, a stable sort by expert (so capacity keeps the earliest tokens of
each expert), silu in f32 cast to bf16, the gating weight rounded to bf16
before the product, and each token's k contributions added in bf16 in
ascending expert order, as XLA's scatter-add adds them.  The expert
products are batched matmuls over the (E, C, D) buffer, as the
reference's einsums (no Pallas kernel computes them).

Tokens are dispatched in ``dp * pods`` groups (one per data shard, when
the batch divides), each with its own capacity, as the reference vmaps
its dispatch over the DP groups; the load-balance auxiliaries stay
global.  On a device mesh each rank dispatches its own groups on its
local tokens, with its "model" slice of every expert's ffn dim
(``_local_groups``).

``moe_dense_ref`` is a plain reference of the same function for the tests
and the card check: expert by expert over its kept tokens, summed in f32.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs import ModelConfig
from repro_torch.models.layers import swiglu
from repro_torch.models.param import Spec
from repro_torch.models.plan import Plan
from repro_torch.spmd import (grad_once, is_dtensor, pair_halves, placements,
                              redistribute_to, split_dim, to_local)

# drop-free capacity (moe_capacity <= 0) holds up to this many assignments;
# past it, twice the mean load of an expert
DROP_FREE_MAX = 8192


class Routing(NamedTuple):
    """The tokens' routing, in the (token, choice) layout."""
    idx: torch.Tensor      # (T, k) expert ids, largest logit first
    keep: torch.Tensor     # (T, k) bool: within the expert's capacity
    slot: torch.Tensor     # (T, k) row e * C + rank of the (E * C)
                           # buffer (e * C where dropped, as the reference)


def moe_spec(cfg: ModelConfig, plan: Plan):
    m = cfg.moe
    d = cfg.d_model
    f = plan.padded_ffn(m.d_expert)
    p = {
        "router": Spec((d, m.n_experts), ("embed", "experts"),
                       dtype=torch.float32),
        "wi": Spec((m.n_experts, d, 2 * f), ("experts", "embed", "ffn")),
        "wo": Spec((m.n_experts, f, d), ("experts", "ffn", "embed")),
    }
    if m.n_shared:
        fs = plan.padded_ffn(m.d_expert * m.n_shared)
        p["shared_wi"] = Spec((d, 2 * fs), ("embed", "ffn"))
        p["shared_wo"] = Spec((fs, d), ("ffn", "embed"))
    return p


def route_topk(logits: torch.Tensor, k: int):
    """logits (T, E) f32 -> (weights (T, k) f32, idx (T, k)): the k largest
    logits in descending order, equal ones lower expert id first (as
    ``lax.top_k``; ``torch.topk`` promises no order among ties), and the
    softmax over those k values only."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :k], idx[..., :k]
    e = torch.exp(vals - vals[..., :1])
    return e / e.sum(dim=-1, keepdim=True), idx


def n_groups(plan: Plan, batch: int) -> int:
    """The reference's token-group count: ``dp * pods`` when it divides the
    batch, else 1."""
    g = max(1, plan.dp * plan.pods)
    return g if batch % g == 0 else 1


def capacity(cfg: ModelConfig, plan: Plan, batch: int, seq: int) -> int:
    """Each expert's capacity C within one token group of the batch's
    ``batch * seq`` tokens."""
    m = cfg.moe
    tk = batch * seq // n_groups(plan, batch) * m.top_k
    if plan.moe_capacity <= 0:
        return tk if tk <= DROP_FREE_MAX else max(1, int(tk / m.n_experts *
                                                         2.0))
    return max(1, int(tk / m.n_experts * plan.moe_capacity))


def _experts(buf: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor,
             pair=None) -> torch.Tensor:
    """The experts' SwiGLU on their buffers: buf (E, C, D) -> (E, C, D).
    ``pair`` maps the (E, C, 2f) product to [gate | up] where the mesh
    splits wi's columns (``spmd.pair_halves``)."""
    gu = torch.bmm(buf, wi)
    g, u = (gu if pair is None else pair(gu)).chunk(2, dim=-1)
    h = F.silu(g.float()).to(buf.dtype) * u
    return torch.bmm(h, wo)


def _dispatch(xt: torch.Tensor, w: torch.Tensor, idx: torch.Tensor,
              experts, m, C: int, routing: bool = False):
    """Sort-based dispatch of the tokens xt (T, D), routed by
    ``route_topk``'s (w, idx) (T, k), through ``experts`` (the (E, C, D)
    buffer -> the experts' outputs, ``_experts``) -> (y (T, D), dropped
    share, ``Routing`` or None)."""
    t, d = xt.shape
    top_k = idx.shape[1]
    n_e = m.n_experts
    dev = xt.device
    tk = t * top_k
    flat_e = idx.reshape(tk)
    flat_t = torch.arange(tk, device=dev) // top_k
    order = torch.argsort(flat_e, stable=True)              # by expert
    e_sorted = flat_e[order]
    t_sorted = flat_t[order]
    w_sorted = w.reshape(tk)[order]
    starts = torch.searchsorted(e_sorted, torch.arange(n_e, device=dev))
    rank = torch.arange(tk, device=dev) - starts[e_sorted]
    keep = rank < C
    slot = e_sorted * C + torch.where(keep, rank, 0)

    # the kept rows land on distinct slots; a dropped row goes to the spare
    # row E * C, which is cut off before the experts read the buffer
    buf = xt.new_zeros((n_e * C + 1, d))
    buf[torch.where(keep, slot, n_e * C)] = xt[t_sorted]
    buf = buf[:n_e * C].view(n_e, C, d)

    out = experts(buf).reshape(n_e * C, d)

    gathered = out[torch.where(keep, slot, 0)] * \
        (w_sorted * keep).to(xt.dtype)[:, None]
    # XLA's scatter-add adds each token's k rows in t_sorted's order, i.e.
    # by ascending expert id: k bf16 adds in that order, from zeros (no
    # index_add_, whose CUDA atomics add in a varying order)
    where = torch.empty_like(order)
    where[order] = torch.arange(tk, device=dev)
    where = where.view(t, top_k).sort(dim=1).values
    y = torch.zeros((t, d), dtype=xt.dtype, device=dev)
    for r in range(top_k):
        y = y + gathered[where[:, r]]
    drop = 1.0 - keep.float().mean()
    if not routing:
        return y, drop, None
    keep_tk, slot_tk = torch.empty_like(keep), torch.empty_like(slot)
    keep_tk[order], slot_tk[order] = keep, slot
    return y, drop, Routing(idx, keep_tk.view(t, top_k),
                            slot_tk.view(t, top_k))


def _groups(xt: torch.Tensor, w: torch.Tensor, idx: torch.Tensor, experts,
            m, C: int, g: int, routing: bool):
    """Dispatch xt (T, D), routed by ``route_topk``'s (w, idx), as ``g``
    consecutive token groups -> (y (T, D), each group's dropped share
    (g,), ``Routing`` or None)."""
    t = xt.shape[0]
    if g == 1:
        y, drop, route = _dispatch(xt, w, idx, experts, m, C, routing)
        return y, drop[None], route
    tg = t // g
    parts = [_dispatch(xt[i * tg:(i + 1) * tg], w[i * tg:(i + 1) * tg],
                       idx[i * tg:(i + 1) * tg], experts, m, C, routing)
             for i in range(g)]
    y = torch.cat([r[0] for r in parts])
    drops = torch.stack([r[1] for r in parts])
    if not routing:
        return y, drops, None
    rs = [r[2] for r in parts]
    return y, drops, Routing(torch.cat([r.idx for r in rs]),
                             torch.cat([r.keep for r in rs]),
                             torch.cat([r.slot for r in rs]))


def _local_groups(p, x, cfg: ModelConfig, plan: Plan, g: int, C: int):
    """``moe_forward``'s dispatch on a mesh: x (B, S, D) a ``DTensor``
    whose batch is split over the data axes.  Each rank dispatches the
    groups of its local tokens (its data shard is whole groups, or the
    batch is one group and every rank holds it all), as the reference's
    ``_dispatch_group`` runs shard-local.  The experts' weights keep
    their ffn dim split over "model" (the reference's specs): every model
    rank routes and dispatches the same tokens, runs its ffn slice of
    every expert (``spmd.pair_halves`` pairs its gate and up columns with
    one all-to-all, of the product or of the weight shard, whichever is
    smaller), and combines its partial sum over the slice; y is reduced
    over "model" into the activation's layout (a reduce-scatter onto the
    sequence split of ``plan.act_pspec``, else an all-reduce).  Only the
    data axes are gathered where FSDP splits a weight over them; a
    weight's gradient is a partial sum over the data axes that split the
    tokens (the router's also over "model").  -> (y, logits' softmax sum
    (E,), top-k counts (E,), dropped shares' sum), the sums replicated
    ``DTensor``s (so autograd carries ``DTensor`` gradients back to
    them)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    m = cfg.moe
    b, s, d = x.shape
    mesh = x.device_mesh
    tp = split_dim(mesh, "model")
    # the mesh dims that keep the batch split: data axes, with groups
    batch_dims = [g > 1 and name != "model" and getattr(pl, "dim", None) == 0
                  for pl, name in zip(x.placements, mesh.mesh_dim_names)]
    x = redistribute_to(x, tuple(pl if keep else Replicate() for pl, keep
                                 in zip(x.placements, batch_dims)))
    # each rank's gradient covers its own tokens: a partial sum over the
    # mesh dims that split them
    split = tuple(Partial() if keep else Replicate() for keep in batch_dims)

    def local(w, model_grad=None):
        """w's local shard, FSDP's split over the data axes gathered and
        "model"'s kept; its gradient ``model_grad`` on "model" (by default
        its own placement there)."""
        if not is_dtensor(w):
            return w
        w = redistribute_to(w, tuple(pl if i == tp else Replicate()
                                     for i, pl in enumerate(w.placements)))
        return to_local(w, tuple((model_grad or pl) if i == tp else split[i]
                                 for i, pl in enumerate(w.placements)))
    router = local(p["router"], Partial())
    wi, wo = local(p["wi"]), local(p["wo"])
    # under TP the tokens' gradient is a partial sum over "model" (each
    # rank adds its ffn slice's part)
    xl = to_local(x, tuple(Partial() if i == tp else pl
                           for i, pl in enumerate(x.placements)))
    bl = xl.shape[0]
    xt = xl.reshape(bl * s, d)
    logits = xt.float() @ router.float()
    w, idx = route_topk(logits, m.top_k)
    ng = max(1, bl * g // b)
    pair = None
    if tp is not None and wi.shape[-1] < p["wi"].shape[-1]:
        if ng * C > d:
            wi = pair_halves(wi, mesh, tp)      # the weight shard is smaller
        else:
            pair = functools.partial(pair_halves, mesh=mesh, dim=tp)
    y, drops, _ = _groups(
        xt, w, idx, functools.partial(_experts, wi=wi, wo=wo, pair=pair), m,
        C, ng, False)
    y = DTensor.from_local(
        y.reshape(bl, s, d), mesh,
        tuple(Partial() if i == tp else pl
              for i, pl in enumerate(x.placements)),
        run_check=False, shape=x.shape, stride=x.stride())
    if m.n_shared:
        y = y + swiglu({"wi": p["shared_wi"], "wo": p["shared_wo"]}, x)
    want = placements(plan.act_pspec, mesh) if plan.act_pspec is not None \
        else tuple(Replicate() if i == tp else pl
                   for i, pl in enumerate(x.placements))
    y = redistribute_to(y, want)
    if tp is not None:
        # the logits' gradient is a partial sum over "model": the
        # auxiliaries', alike on every model rank, joins it once
        logits = grad_once(logits, mesh, tp)
    flat = idx.reshape(-1)
    counts = logits.new_zeros(m.n_experts).index_add_(
        0, flat, torch.ones_like(flat, dtype=torch.float32))
    sums = (torch.softmax(logits, dim=-1).sum(dim=0), counts, drops.sum())
    whole_sum = tuple(Replicate() for _ in split)
    sums = [DTensor.from_local(t, mesh, split, run_check=False)
            .redistribute(mesh, whole_sum) for t in sums]
    return (y, *sums)


def moe_forward(p, x: torch.Tensor, cfg: ModelConfig, plan: Plan, *,
                routing: bool = False):
    """x (B, S, D) -> (y (B, S, D), {"load_balance_loss", "dropped_frac"}),
    and the ``Routing`` as a third value when ``routing``.

    The B * S tokens are dispatched in ``n_groups(plan, B)`` consecutive
    groups, each with its own capacity (``dp * pods`` groups, one per
    data shard; 1 on one device); ``dropped_frac`` is the groups' mean
    dropped share and the load-balance loss is taken over all tokens.
    Nothing here reads a value back to the host."""
    m = cfg.moe
    b, s, d = x.shape
    n_e = m.n_experts
    g = n_groups(plan, b)
    C = capacity(cfg, plan, b, s)
    if is_dtensor(x):
        x = plan.hint(x, "dp", None, None)
        y, me_sum, counts, drop_sum, = _local_groups(p, x, cfg, plan, g, C)
        t = b * s
        aux = {"load_balance_loss": n_e * ((me_sum / t) *
                                           (counts / (t * m.top_k))).sum(),
               "dropped_frac": drop_sum / g}
        return y, aux
    xt = x.reshape(b * s, d)
    logits = xt.float() @ p["router"].float()               # (T, E)
    w, idx = route_topk(logits, m.top_k)                    # (T, k)
    y, drops, route = _groups(
        xt, w, idx, functools.partial(_experts, wi=p["wi"], wo=p["wo"]), m,
        C, g, routing)
    if m.n_shared:
        y = y + swiglu({"wi": p["shared_wi"], "wo": p["shared_wo"]}, xt)

    # load-balancing auxiliaries (Switch-style) over all T tokens; the
    # counts are whole numbers in f32, exact in any order of the adds
    # (``bincount`` would read the ids' range back to the host)
    me = torch.softmax(logits, dim=-1).mean(dim=0)
    flat = idx.reshape(-1)
    ce = logits.new_zeros(n_e).index_add_(
        0, flat, torch.ones_like(flat, dtype=torch.float32)) / flat.numel()
    aux = {"load_balance_loss": n_e * (me * ce).sum(),
           "dropped_frac": drops.mean() if g > 1 else drops[0]}
    if routing:
        return y.reshape(b, s, d), aux, route
    return y.reshape(b, s, d), aux


def _ffn(x: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor):
    g, u = (x @ wi).chunk(2, dim=-1)
    return (F.silu(g.float()).to(x.dtype) * u) @ wo


@torch.no_grad()
def moe_dense_ref(p, x: torch.Tensor, cfg: ModelConfig, plan: Plan
                  ) -> Tuple[torch.Tensor, Routing]:
    """Plain reference of ``moe_forward``'s output for the tests and the
    card check: the same routing (within each token group, the first C
    tokens of each expert, in token order, are kept), then expert by
    expert its kept tokens through its SwiGLU, scaled by their bf16
    weight and summed per token in f32, rounded once; the shared experts
    added in bf16.  Returns y (B, S, D) and the ``Routing`` (its ``slot``
    e * C + the kept rank within the group, as the dispatch's)."""
    m = cfg.moe
    b, s, d = x.shape
    C = capacity(cfg, plan, b, s)
    g = n_groups(plan, b)
    xt = x.reshape(b * s, d)
    w, idx = route_topk(xt.float() @ p["router"].float(), m.top_k)
    keep = torch.zeros_like(idx, dtype=torch.bool)
    slot = idx * C                                          # dropped: e * C
    y = torch.zeros(xt.shape, dtype=torch.float32, device=x.device)
    tg = b * s // g
    for g0 in range(0, b * s, tg):
        for e in range(m.n_experts):
            hit = idx[g0:g0 + tg] == e                      # (Tg, k)
            rows = hit.any(dim=1).nonzero()[:C, 0]          # token order
            if rows.numel() == 0:
                continue
            j = hit[rows].int().argmax(dim=1)
            rows = rows + g0
            keep[rows, j] = True
            slot[rows, j] = e * C + torch.arange(rows.numel(),
                                                 device=x.device)
            out = _ffn(xt[rows], p["wi"][e], p["wo"][e])
            y[rows] += out.float() * w[rows, j].to(x.dtype).float()[:, None]
    y = y.to(x.dtype)
    if m.n_shared:
        y = y + _ffn(xt, p["shared_wi"], p["shared_wo"])
    return y.reshape(b, s, d), Routing(idx, keep, slot)
