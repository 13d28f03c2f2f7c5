"""Top-level model: embeddings + stack + head, prefill / decode.

The port's counterpart of ``repro.models.model`` for decoder-only stacks
of GQA or MLA attention with dense or MoE FFNs.
``build_model(cfg, plan, device)`` returns a ``Model``, an ``nn.Module``
whose parameters mirror the JAX package's tree (``tok_embed``,
``stack.layers.<i>.attn.wq``, ..., ``stack.ln_f``, ``lm_head``):

  init_params(generator)            -> self, weights drawn per leaf
  forward(batch)                    -> logits (B, S, Vp) f32
  init_decode(batch, s_max)         -> caches
  prefill(batch, caches)            -> (caches, last_logits (B, 1, Vp))
  decode_step(caches, tokens, pos)  -> (caches, logits (B, 1, Vp))

``batch`` is ``{"tokens": (B, S) int}``.  The MoE layers' summed
load-balance loss of the last call is ``_last_aux``.  The families with
modules not ported yet (vlm, audio, ssm, hybrid) raise
``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.models.layers import (embed_lookup, embed_spec, lm_logits,
                                       rope_angles, rope_tables)
from repro_torch.models.param import ParamTree, Spec
from repro_torch.models.plan import DEFAULT_PLAN, Plan


def model_spec(cfg: ModelConfig, plan: Plan) -> Dict[str, Any]:
    vp = plan.padded_vocab(cfg.vocab_size)
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

    def _rope(self, positions: torch.Tensor):
        if self.cfg.rope_theta == 0:
            return None
        cfg = self.cfg
        dim = cfg.mla.qk_rope_head_dim if cfg.mla is not None else cfg.hd
        return rope_tables(rope_angles(positions, dim, cfg.rope_theta))

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        head = self.tok_embed if cfg.tie_embeddings else self.lm_head
        return lm_logits(x, head, cfg.vocab_size,
                         transpose=cfg.tie_embeddings)

    def _run(self, tokens: torch.Tensor, positions: torch.Tensor, caches,
             decode: bool):
        x = embed_lookup(self.tok_embed, tokens)
        x, caches, self._last_aux = transformer.stack_forward(
            self.stack, x, self.cfg, self.plan,
            rope=self._rope(positions), caches=caches, decode=decode)
        return x, caches

    @torch.no_grad()
    def forward(self, batch) -> torch.Tensor:
        tokens = batch["tokens"]
        b, s = tokens.shape
        pos = torch.arange(s, device=tokens.device).expand(b, s)
        x, _ = self._run(tokens, pos, None, decode=False)
        return self._head(x)

    def init_decode(self, batch: int, s_max: int):
        return transformer.init_caches(self.cfg, self.plan, batch, s_max,
                                       device=self.device)

    @torch.no_grad()
    def prefill(self, batch, caches):
        """Fill ``caches`` from a whole prompt; (caches, last logits)."""
        tokens = batch["tokens"]
        b, s = tokens.shape
        pos = torch.arange(s, device=tokens.device).expand(b, s)
        x, caches = self._run(tokens, pos, caches, decode=False)
        return caches, self._head(x[:, -1:])

    @torch.no_grad()
    def decode_step(self, caches, tokens: torch.Tensor, pos: int):
        """tokens (B, 1) at absolute position ``pos`` -> (caches, logits)."""
        b = tokens.shape[0]
        positions = torch.full((b, 1), pos, device=tokens.device)
        x, caches = self._run(tokens, positions, caches, decode=True)
        return caches, self._head(x)


def build_model(cfg: ModelConfig, plan: Plan = DEFAULT_PLAN,
                device=None) -> Model:
    return Model(cfg, plan, device)
