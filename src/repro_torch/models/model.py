"""Top-level model: embeddings + stack + head, prefill / decode.

The port's counterpart of ``repro.models.model`` for every config of the
repo: decoder-only stacks of GQA or MLA attention, Mamba or RWKV-6 mixers
with dense or MoE FFNs (the LM, MoE, hybrid and ssm families and
Qwen2-VL's backbone) and Whisper's encoder-decoder.
``build_model(cfg, plan, device)`` returns a ``Model``, an ``nn.Module``
whose parameters mirror the JAX package's tree (``tok_embed``,
``stack.layers.<i>.attn.wq``, ``stack.layers.<i>.mamba.in_proj``,
``stack.layers.<i>.rwkv.tm.wr``, ..., ``stack.ln_f``, ``lm_head``; Whisper's
``enc.<i>...``, ``dec.<i>...``, ``enc_ln``, ``dec_ln``, ``pos_embed``):

  init_params(generator)            -> self, weights drawn per leaf
  loss(batch)                       -> (loss, {"ce", "aux"})  [train]
  forward(batch)                    -> logits (B, S, Vp) f32
  init_decode(batch, s_max)         -> caches
  prefill(batch, caches)            -> (caches, last_logits (B, 1, Vp))
  decode_step(caches, tokens, pos)  -> (caches, logits (B, 1, Vp))

``batch`` is ``{"tokens": (B, S) int}``; a VLM's may add
``vision_embeds`` (B, Nv, d), placed before the tokens, and
``positions3`` (3, B, Nv + S), the (t, h, w) streams of M-RoPE (else every
stream is the position); Whisper's needs ``audio_embeds`` (B, F, d), and
its caches are a ``whisper.WhisperCache``.  A decoder-only model's
caches are one per layer: a ``KVCache``, a ``mamba.MambaState`` or an
``rwkv6.RWKVState``.  A config without RoPE (``rope_theta`` 0: Jamba's
attention layers, RWKV) gets no RoPE tables.  The MoE layers' summed
load-balance loss of the last call is ``_last_aux``.

``forward``, ``prefill`` and ``decode_step`` serve: they record no
autograd graph.  ``loss`` trains: it records one, and its batch adds
``targets`` (B, S) (-1 ignored); the parameters take gradients once
``trainable()`` has turned them on.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer, whisper
from repro_torch.models.layers import (chunked_ce, cross_entropy,
                                       embed_lookup, embed_spec, lm_logits,
                                       mrope_angles, rope_angles,
                                       rope_tables)
from repro_torch.models.param import ParamTree, Spec
from repro_torch.models.plan import DEFAULT_PLAN, Plan


def model_spec(cfg: ModelConfig, plan: Plan) -> Dict[str, Any]:
    vp = plan.padded_vocab(cfg.vocab_size)
    if cfg.is_encdec:
        return whisper.whisper_spec(cfg, plan, vp)
    s = {"tok_embed": embed_spec(vp, cfg.d_model, tied=cfg.tie_embeddings),
         "stack": transformer.stack_spec(cfg, plan)}
    if not cfg.tie_embeddings:
        s["lm_head"] = Spec((cfg.d_model, vp), ("embed", "vocab"))
    return s


class Model(ParamTree):
    def __init__(self, cfg: ModelConfig, plan: Plan = DEFAULT_PLAN,
                 device=None):
        dev = resolve_device(device)
        super().__init__(model_spec(cfg, plan), dev)
        self.cfg, self.plan, self.device = cfg, plan, dev
        self._last_aux = None

    def _rope(self, positions: torch.Tensor, batch: Optional[dict] = None):
        cfg = self.cfg
        if cfg.rope_theta == 0:
            return None
        dim = cfg.mla.qk_rope_head_dim if cfg.mla is not None else cfg.hd
        if cfg.m_rope:
            pos3 = batch["positions3"] if batch and "positions3" in batch \
                else positions[None].expand(3, *positions.shape)
            return rope_tables(mrope_angles(pos3, dim, cfg.rope_theta,
                                            cfg.mrope_sections))
        return rope_tables(rope_angles(positions, dim, cfg.rope_theta))

    def _head_weight(self):
        """(LM head weight, whether it is the transposed embedding)."""
        tied = self.cfg.tie_embeddings or self.cfg.is_encdec
        return (self.tok_embed if tied else self.lm_head), tied

    def _head(self, x: torch.Tensor, plan=None) -> torch.Tensor:
        head, tied = self._head_weight()
        return lm_logits(x, head, self.cfg.vocab_size, transpose=tied,
                         plan=plan)

    def _embed_in(self, batch) -> torch.Tensor:
        x = embed_lookup(self.tok_embed, batch["tokens"])
        if self.cfg.family == "vlm" and "vision_embeds" in batch:
            x = torch.cat([batch["vision_embeds"].to(x.dtype), x], dim=1)
        return x

    def _run(self, x: torch.Tensor, positions: torch.Tensor, caches,
             decode: bool, batch: Optional[dict] = None):
        x, caches, self._last_aux = transformer.stack_forward(
            self.stack, x, self.cfg, self.plan,
            rope=self._rope(positions, batch), caches=caches, decode=decode)
        return x, caches

    def _prompt(self, batch):
        """The decoder's input embeddings of a whole prompt and, for a
        decoder-only model, its positions."""
        if self.cfg.is_encdec:
            tokens = batch["tokens"]
            x = embed_lookup(self.tok_embed, tokens)
            return x + self.pos_embed[:tokens.shape[1]], None
        x = self._embed_in(batch)
        b, s, _ = x.shape
        return x, torch.arange(s, device=x.device).expand(b, s)

    def _hidden(self, batch) -> torch.Tensor:
        """The final normed hidden states (B, S, d) of a whole sequence."""
        x, pos = self._prompt(batch)
        if self.cfg.is_encdec:
            enc = whisper.encode(self, batch["audio_embeds"], self.cfg,
                                 self.plan)
            x, _ = whisper.decode_stack(self, x, self.cfg, self.plan,
                                        enc_out=enc)
            return x
        x, _ = self._run(x, pos, None, decode=False, batch=batch)
        return x

    @torch.no_grad()
    def forward(self, batch) -> torch.Tensor:
        return self._head(self._hidden(batch), self.plan)

    def loss(self, batch):
        """-> (ce + 0.01 * aux, {"ce", "aux"}), f32 scalars: the mean
        next-token CE over ``batch["targets"]`` (a VLM's vision prefix
        carries none) and the MoE load-balance loss (0 without MoE).  The
        CE is chunked (``layers.chunked_ce``) under ``plan.opt_chunked_ce``
        for a decoder-only model at S >= 2048, as the reference."""
        cfg, plan = self.cfg, self.plan
        tgt = batch["targets"]
        x = self._hidden(batch)
        if cfg.family == "vlm" and "vision_embeds" in batch:
            x = x[:, batch["vision_embeds"].shape[1]:]
        if plan.opt_chunked_ce and not cfg.is_encdec and \
                batch["tokens"].shape[1] >= 2048:
            head, tied = self._head_weight()
            ce = chunked_ce(x, head, tgt, cfg.vocab_size, transpose=tied,
                            plan=plan)
        else:
            ce = cross_entropy(self._head(x, plan), tgt)
        aux = self._last_aux if self._last_aux is not None else \
            torch.zeros((), dtype=torch.float32, device=x.device)
        return ce + 0.01 * aux, {"ce": ce, "aux": aux}

    def init_decode(self, batch: int, s_max: int):
        if self.cfg.is_encdec:
            return whisper.init_caches(self.cfg, self.plan, batch, s_max,
                                       device=self.device)
        return transformer.init_caches(self.cfg, self.plan, batch, s_max,
                                       device=self.device)

    @torch.no_grad()
    def prefill(self, batch, caches):
        """Fill ``caches`` from a whole prompt; (caches, last logits).
        Whisper's caches come back as a ``WhisperCache`` with the encoder's
        cross-attention K/V."""
        x, pos = self._prompt(batch)
        if self.cfg.is_encdec:
            enc = whisper.encode(self, batch["audio_embeds"], self.cfg,
                                 self.plan)
            cross = whisper.cross_kv(self, enc, self.cfg, self.plan)
            x, caches = whisper.decode_stack(self, x, self.cfg, self.plan,
                                             cross=cross, caches=caches)
            return whisper.WhisperCache(caches, cross), self._head(x[:, -1:])
        x, caches = self._run(x, pos, caches, decode=False, batch=batch)
        return caches, self._head(x[:, -1:])

    @torch.no_grad()
    def decode_step(self, caches, tokens: torch.Tensor, pos: int):
        """tokens (B, 1) at absolute position ``pos`` -> (caches, logits).
        M-RoPE takes ``pos`` on all three streams."""
        x = embed_lookup(self.tok_embed, tokens)
        if self.cfg.is_encdec:
            self_kv, cross = caches
            x, self_kv = whisper.decode_stack(
                self, x + self.pos_embed[pos:pos + 1], self.cfg, self.plan,
                cross=cross, caches=self_kv, decode=True)
            return whisper.WhisperCache(self_kv, cross), self._head(x)
        positions = torch.full((tokens.shape[0], 1), pos, device=tokens.device)
        x, caches = self._run(x, positions, caches, decode=True)
        return caches, self._head(x)


def build_model(cfg: ModelConfig, plan: Plan = DEFAULT_PLAN,
                device=None) -> Model:
    return Model(cfg, plan, device)
