"""Whisper encoder-decoder (the audio family), the port's counterpart of
``repro.models.whisper``.  The conv frontend is a stub, as in the
reference: the caller supplies frame embeddings (B, n_frames, d).

Whisper uses LayerNorm, GELU MLPs, sinusoidal encoder positions, learned
decoder positions and no RoPE.  The encoder's self-attention is
bidirectional: it runs the flash-attention kernel non-causal over the
frames (``attention.prefill_mha``).  The decoder's self-attention is
``attention.gqa_forward`` (causal prefill through the kernel, then the
cached decode); its cross-attention is ``gqa_forward`` too, given the
encoder's K/V (computed once a prefill per layer, ``cross_kv``), which
runs the plain ``attend``: queries and keys differ in length there, and
the kernel takes one.
The JAX package stacks each stack's layers and scans them; the port keeps
one entry per layer (``params["enc"][i]``, ``params["dec"][i]``).
"""
from __future__ import annotations

from typing import List, NamedTuple, Tuple

import torch

from repro_torch.configs import ModelConfig
from repro_torch.models import attention
from repro_torch.models.layers import (gelu_mlp, gelu_mlp_spec, layer_norm,
                                       layer_norm_spec, matmul,
                                       sinusoid_positions)
from repro_torch.models.param import Spec
from repro_torch.models.plan import Plan

MAX_DEC_LEN = 32768     # learned decoder positions, as the reference


def _enc_layer_spec(cfg: ModelConfig, plan: Plan):
    return {
        "ln1": layer_norm_spec(cfg.d_model),
        "attn": attention.gqa_spec(cfg, plan),
        "ln2": layer_norm_spec(cfg.d_model),
        "mlp": gelu_mlp_spec(cfg.d_model, plan.padded_ffn(cfg.d_ff)),
    }


def _dec_layer_spec(cfg: ModelConfig, plan: Plan):
    s = _enc_layer_spec(cfg, plan)
    s["ln_x"] = layer_norm_spec(cfg.d_model)
    s["xattn"] = attention.gqa_spec(cfg, plan)
    return s


def whisper_spec(cfg: ModelConfig, plan: Plan, vocab_padded: int,
                 max_dec_len: int = MAX_DEC_LEN):
    return {
        "enc": [_enc_layer_spec(cfg, plan)
                for _ in range(cfg.encoder_layers)],
        "enc_ln": layer_norm_spec(cfg.d_model),
        "dec": [_dec_layer_spec(cfg, plan) for _ in range(cfg.n_layers)],
        "dec_ln": layer_norm_spec(cfg.d_model),
        "tok_embed": Spec((vocab_padded, cfg.d_model), ("vocab", "embed"),
                          init="embed"),
        "pos_embed": Spec((max_dec_len, cfg.d_model), (None, "embed"),
                          init="embed"),
    }


def _out(p, o: torch.Tensor, hmask) -> torch.Tensor:
    """The encoder's heads (B, S, H, D) through the output projection,
    TP-padding heads masked to zero first."""
    if hmask is not None:
        o = o * hmask[None, None, :, None]
    b, s = o.shape[:2]
    hq, hd, d = p["wo"].shape
    return matmul(o.reshape(b, s, hq * hd), p["wo"].reshape(hq * hd, d))


def encode(params, audio_embeds: torch.Tensor, cfg: ModelConfig,
           plan: Plan) -> torch.Tensor:
    """audio_embeds (B, F, d), the frontend stub's output -> the encoder's
    normed output (B, F, d).  The encoder runs in the embeddings' dtype
    promoted against the bf16 weights, as ``jnp`` promotes: bf16 frames
    (serving) stay bf16, f32 frames (the training batch) run it in f32,
    and its output then makes f32 cross-attention K/V."""
    x = audio_embeds + sinusoid_positions(
        audio_embeds.shape[1], cfg.d_model,
        device=audio_embeds.device).to(audio_embeds.dtype)
    hmask = attention.head_mask(cfg, plan, device=x.device)
    for p in params["enc"]:
        h = layer_norm(x, p["ln1"], cfg.norm_eps)
        a = p["attn"]
        q, k, v = (attention.proj(h, a[w]) for w in ("wq", "wk", "wv"))
        x = x + _out(a, attention.prefill_mha(q, k, v, causal=False), hmask)
        h = layer_norm(x, p["ln2"], cfg.norm_eps)
        x = x + gelu_mlp(p["mlp"], h)
    return layer_norm(x, params["enc_ln"], cfg.norm_eps)


class WhisperCache(NamedTuple):
    """The decode state: the decoder's self-attention caches, one per
    layer, and the encoder's cross-attention K/V, ``(ks, vs)`` with one
    (B, F, Hkv, D) entry per layer (a 2-tuple, as the reference's
    ``(caches, cross)``)."""
    self_kv: List[attention.KVCache]
    cross: Tuple[List[torch.Tensor], List[torch.Tensor]]


def cross_kv(params, enc_out: torch.Tensor, cfg: ModelConfig, plan: Plan):
    """Every decoder layer's cross-attention K and V from the encoder's
    output: ``([k_0, ...], [v_0, ...])``, each (B, F, Hkv, D)."""
    ks = [attention.proj(enc_out, p["xattn"]["wk"]) for p in params["dec"]]
    vs = [attention.proj(enc_out, p["xattn"]["wv"]) for p in params["dec"]]
    return ks, vs


def decode_stack(params, x: torch.Tensor, cfg: ModelConfig, plan: Plan, *,
                 enc_out=None, cross=None, caches=None,
                 decode: bool = False):
    """The decoder over (B, S, d) token embeddings (positions added by the
    caller) -> (normed (B, S, d), new caches or None).  ``cross`` is
    ``cross_kv``'s output, or computed here from ``enc_out``."""
    hmask = attention.head_mask(cfg, plan, device=x.device)
    cks, cvs = cross if cross is not None else cross_kv(params, enc_out,
                                                       cfg, plan)
    new_caches = [] if caches is not None else None
    for i, p in enumerate(params["dec"]):
        h = layer_norm(x, p["ln1"], cfg.norm_eps)
        y, nc = attention.gqa_forward(
            p["attn"], h, cfg, plan, cache=None if caches is None
            else caches[i], decode=decode, hmask=hmask)
        x = x + y
        h = layer_norm(x, p["ln_x"], cfg.norm_eps)
        y, _ = attention.gqa_forward(p["xattn"], h, cfg, plan,
                                     cross_kv=(cks[i], cvs[i]), hmask=hmask)
        x = x + y
        h = layer_norm(x, p["ln2"], cfg.norm_eps)
        x = x + gelu_mlp(p["mlp"], h)
        if new_caches is not None:
            new_caches.append(nc)
    return layer_norm(x, params["dec_ln"], cfg.norm_eps), new_caches


def init_caches(cfg: ModelConfig, plan: Plan, batch: int, s_max: int,
                device=None) -> List[attention.KVCache]:
    """One self-attention cache of ``s_max`` slots per decoder layer (int8
    under ``plan.kv_quant``)."""
    hkv = plan.padded_kv_heads(cfg.n_kv_heads)
    return [attention.init_kv_cache(batch, s_max, hkv, cfg.hd,
                                    plan.kv_quant, device=device)
            for _ in range(cfg.n_layers)]
