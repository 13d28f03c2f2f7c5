"""Execution plan: how a model is laid out, separate from its architecture.

The port's counterpart of ``repro.models.plan`` with the fields a
one-device server or trainer reads: head and vocab padding (exact
functions: padded q heads are masked to zero, padded vocab slots to
-1e30), the int8 KV cache, the MoE capacity factor, the serving toggles
and the training ones (remat, gradient-accumulation microbatches, chunked
cross-entropy), which serving ignores.  The reference's
``weight_quant`` is read nowhere there and has no field here
(``layers.quantize_int8`` / ``matmul_int8`` are its functions), and its
``opt_int8_attend`` has only its default here: an int8 cache is always
read by ``attend`` itself, dequantized per chunk.  There is no mesh, so no
sharding hints and no data axis: the MoE dispatches one token group.
"""
from __future__ import annotations

import dataclasses


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class Plan:
    tp: int = 1                  # model-axis size (head / ffn padding only)
    vocab_pad: int = 256
    kv_quant: bool = False       # int8 KV cache (serving, big models)
    moe_capacity: float = 1.25   # expert capacity factor; 0 -> drop-free
                                 # up to 8192 assignments (serving)
    opt_gqa_pack: bool = True     # decode: fold GQA groups into the query
                                  # axis instead of materialising repeated KV
    remat: str = "full"          # full | none: recompute each layer in the
                                 # backward (training only)
    microbatches: int = 1        # grad-accumulation steps
    opt_chunked_ce: bool = True  # chunked cross-entropy (no (B,S,V) f32)

    def padded_heads(self, n_heads: int) -> int:
        """Zero-pad q heads to a TP multiple (exact function)."""
        return _ceil_to(n_heads, self.tp)

    def padded_kv_heads(self, n_kv: int) -> int:
        """Replicate kv heads up to the TP degree (GQA-TP)."""
        return max(n_kv, self.tp) if self.tp > 1 else n_kv

    def padded_vocab(self, v: int) -> int:
        return _ceil_to(v, max(self.vocab_pad, self.tp))

    def padded_ffn(self, f: int) -> int:
        return _ceil_to(f, self.tp)


DEFAULT_PLAN = Plan()
