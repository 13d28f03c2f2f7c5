"""Decoder stack: layer layouts, parameter specs, caches and the forward.

The port's counterpart of ``repro.models.transformer``: each layer mixes
its sequence by GQA or MLA attention, Mamba or RWKV-6, and (but for RWKV,
whose channel mix is its FFN) feeds a dense or MoE FFN.  The JAX package
groups identical layers (Jamba: its 8-layer period) and scans over each
group's stacked parameters; the port keeps one entry per layer
(``stack.layers[i]``, an ``nn.ModuleList``) and loops over them, so
parameters are allocated and initialised layer by layer.
``group_layout`` stays: it is how the JAX package's stacked trees are read
(``convert.model_params_from_numpy``).  Whisper's encoder-decoder stack is
``models/whisper.py``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs import ModelConfig
from repro_torch.models import attention, mamba, moe, rwkv6
from repro_torch.models.layers import (rms_norm, rms_norm_spec, swiglu,
                                       swiglu_spec)
from repro_torch.models.plan import Plan
from repro_torch.spmd import constrain


@dataclasses.dataclass(frozen=True)
class LayerDef:
    mixer: str           # attn | mla | mamba | rwkv
    ffn: Optional[str]   # dense | moe | None (rwkv: built-in channel mix)


def layer_def(cfg: ModelConfig, i: int) -> LayerDef:
    if cfg.rwkv:
        return LayerDef("rwkv", None)
    if cfg.attn_layer_period:
        mixer = "attn" if i % cfg.attn_layer_period == cfg.attn_layer_offset \
            else "mamba"
    else:
        mixer = "mla" if cfg.mla is not None else "attn"
    ffn = "dense"
    if cfg.moe is not None and i >= cfg.moe.first_dense and \
            i % cfg.moe.layer_period == cfg.moe.layer_offset:
        ffn = "moe"
    return LayerDef(mixer, ffn)


def group_layout(cfg: ModelConfig) -> List[Tuple[int, List[LayerDef]]]:
    """[(repeat_count, block_defs)]: the JAX package's scan groups
    (consecutive identical blocks merge)."""
    defs = [layer_def(cfg, i) for i in range(cfg.n_layers)]
    if cfg.attn_layer_period:
        period = cfg.attn_layer_period if cfg.moe is None else math.lcm(
            cfg.attn_layer_period, cfg.moe.layer_period)
        assert cfg.n_layers % period == 0
        return [(cfg.n_layers // period, defs[:period])]
    groups: List[Tuple[int, List[LayerDef]]] = []
    for d in defs:
        if groups and groups[-1][1] == [d]:
            groups[-1] = (groups[-1][0] + 1, [d])
        else:
            groups.append((1, [d]))
    return groups


def _layer_spec(cfg: ModelConfig, plan: Plan, d: LayerDef):
    """An RWKV layer is its block alone (``rwkv``); any other is ``ln_mix``,
    the mixer (``attn`` or ``mamba``), ``ln_ffn`` and ``ffn``."""
    if d.mixer == "rwkv":
        return {"rwkv": rwkv6.rwkv_spec(cfg, plan)}
    if d.mixer == "mamba":
        mixer = {"mamba": mamba.mamba_spec(cfg, plan)}
    elif d.mixer == "mla":
        mixer = {"attn": attention.mla_spec(cfg, plan)}
    else:
        mixer = {"attn": attention.gqa_spec(cfg, plan)}
    ffn = moe.moe_spec(cfg, plan) if d.ffn == "moe" else \
        swiglu_spec(cfg.d_model, plan.padded_ffn(cfg.d_ff))
    return {"ln_mix": rms_norm_spec(cfg.d_model), **mixer,
            "ln_ffn": rms_norm_spec(cfg.d_model), "ffn": ffn}


def stack_spec(cfg: ModelConfig, plan: Plan):
    return {"layers": [_layer_spec(cfg, plan, layer_def(cfg, i))
                       for i in range(cfg.n_layers)],
            "ln_f": rms_norm_spec(cfg.d_model)}


def init_caches(cfg: ModelConfig, plan: Plan, batch: int, s_max: int,
                device=None) -> list:
    """One cache per layer.  An attention layer's is a ``KVCache``, int8
    under ``plan.kv_quant``: an MLA layer's holds the latent c_kv (k,
    ``(B, s_max, 1, kv_lora_rank)``) and the RoPE key (v, ``(B, s_max, 1,
    qk_rope_head_dim)``) in bf16 always, as the reference; a sliding-window
    layer's is a ring of ``min(s_max, window)`` slots.  A Mamba layer's is
    a ``mamba.MambaState``, an RWKV layer's an ``rwkv6.RWKVState`` (zeros,
    whatever ``s_max``)."""
    hkv = plan.padded_kv_heads(cfg.n_kv_heads)
    s_alloc = min(s_max, cfg.sliding_window) if cfg.sliding_window else s_max
    caches = []
    for i in range(cfg.n_layers):
        mixer = layer_def(cfg, i).mixer
        if mixer == "rwkv":
            caches.append(rwkv6.init_state(cfg, batch, device=device))
        elif mixer == "mamba":
            caches.append(mamba.init_state(cfg, batch, device=device))
        elif mixer == "mla":
            m = cfg.mla
            kv = [torch.zeros((batch, s_max, 1, n), dtype=torch.bfloat16,
                              device=device)
                  for n in (m.kv_lora_rank, m.qk_rope_head_dim)]
            caches.append(attention.KVCache(*kv, k_scale=None, v_scale=None,
                                            length=0))
        else:
            caches.append(attention.init_kv_cache(
                batch, s_alloc, hkv, cfg.hd, plan.kv_quant, device=device))
    return caches


def _layer(p, d: LayerDef, x: torch.Tensor, cfg: ModelConfig, plan: Plan,
           rope, c, decode: bool, hmask):
    """One layer: x (B, S, D) -> (x, new cache, MoE load-balance loss or
    None)."""
    if d.mixer == "rwkv":
        x, nc = rwkv6.rwkv_block(p["rwkv"], x, cfg, plan, state=c)
        return x, nc, None
    # Megatron-SP: a sequence-sharded stream is gathered once before the
    # mixer and once before the FFN (the all-gathers the reference's
    # comment has GSPMD insert), not once for each projection
    gather = plan.act_pspec is not None and not decode
    h = rms_norm(x, p["ln_mix"], cfg.norm_eps)
    if gather:
        h = plan.hint(h, "dp", None, None)
    if d.mixer == "mamba":
        y, nc = mamba.mamba_forward(p["mamba"], h, cfg, plan, state=c,
                                    decode=decode)
    else:
        mixer = attention.mla_forward if d.mixer == "mla" else \
            attention.gqa_forward
        y, nc = mixer(p["attn"], h, cfg, plan, rope=rope, cache=c,
                      decode=decode, hmask=hmask)
    x = x + y
    h = rms_norm(x, p["ln_ffn"], cfg.norm_eps)
    if gather:
        h = plan.hint(h, "dp", None, None)
    if d.ffn == "moe":
        y, a = moe.moe_forward(p["ffn"], h, cfg, plan)
        return x + y, nc, a["load_balance_loss"]
    return x + swiglu(p["ffn"], h), nc, None


def stack_forward(stack, x: torch.Tensor, cfg: ModelConfig, plan: Plan, *,
                  rope=None, caches=None, decode: bool = False):
    """x (B, S, D) -> (normed (B, S, D), new caches or None, aux): aux is
    the MoE layers' load-balance losses summed (f32 scalar).  Outside
    decode, ``plan.act_pspec`` constrains the residual stream at every
    block boundary of the reference's scan groups (on a mesh only).

    With ``plan.remat == "full"``, no caches and autograd recording (a
    training forward), each layer runs under ``torch.utils.checkpoint``
    and is recomputed in the backward, as the reference's
    ``jax.checkpoint(nothing_saveable)`` block: only the layers' inputs
    are kept."""
    hmask = attention.head_mask(cfg, plan, device=x.device)
    new_caches = [] if caches is not None else None
    remat = plan.remat == "full" and caches is None and not decode and \
        torch.is_grad_enabled()
    sp = plan.act_pspec if not decode else None
    edges = _block_edges(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, p in enumerate(stack["layers"]):
        d = layer_def(cfg, i)
        c = None if caches is None else caches[i]
        if i in edges:
            # Megatron-SP: the residual stream lives sequence-sharded at
            # every block boundary (a plain tensor is left as it is)
            x = constrain(x, sp)
        if remat:
            x, nc, a = checkpoint(_layer, p, d, x, cfg, plan, rope, c, decode,
                                  hmask, use_reentrant=False)
        else:
            x, nc, a = _layer(p, d, x, cfg, plan, rope, c, decode, hmask)
        if a is not None:
            aux = aux + a
        if new_caches is not None:
            new_caches.append(nc)
    x = constrain(x, sp)
    return rms_norm(x, stack["ln_f"], cfg.norm_eps), new_caches, aux


def _block_edges(cfg: ModelConfig) -> set:
    """The layers that start a block of the reference's scan groups (every
    layer, but one in eight for Jamba's period blocks)."""
    edges, i = set(), 0
    for count, block in group_layout(cfg):
        for _ in range(count):
            edges.add(i)
            i += len(block)
    return edges
