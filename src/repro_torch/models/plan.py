"""Execution plan: how a model is laid out, separate from its architecture.

The port's counterpart of ``repro.models.plan``: head and vocab padding
(exact functions: padded q heads are masked to zero, padded vocab slots to
-1e30), the int8 KV cache, the MoE capacity factor, the serving toggles,
the training ones (remat, gradient-accumulation microbatches, chunked
cross-entropy), which serving ignores, and the mesh fields: the data and
pod axis sizes (``dp``, ``pods``: the MoE dispatches ``dp * pods`` token
groups), sequence-sharded decode, ZeRO-2 gradients, FSDP parameters, the
block-boundary activation layout ``act_pspec`` (a spec tuple, see
``repro_torch.spmd``) and the interior hints ``hint``.  Without a mesh the
tensors are plain and every hint returns its input.  The reference's
``weight_quant`` is read nowhere there and has no field here
(``layers.quantize_int8`` / ``matmul_int8`` are its functions), its
``opt_int8_attend`` has only its default here (an int8 cache is always
read by ``attend`` itself, dequantized per chunk), and its
``scan_layers`` has none: the port's stack is always a Python loop over
per-layer parameters, with no layer scan to turn off.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.spmd import constrain


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class Plan:
    tp: int = 1                  # model-axis size
    dp: int = 1                  # data-axis size
    pods: int = 1
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
    seq_shard_decode: bool = False  # shard the KV sequence over the data axes
    zero_grads: bool = True      # ZeRO-2: gradients reduce-scattered
    fsdp: bool = False           # ZeRO-3: bf16 params sharded over DP too
    act_pspec: Optional[Tuple] = None
    # Megatron-SP: the residual stream (B, S, D) at every block boundary is
    # constrained to this spec (seq over "model"); None disables
    hint_dp = None  # interior-hint DP axes ("data" or ("pod", "data")), set
    # with object.__setattr__ by launch.steps.make_plan (kept out of
    # __init__, as the reference)

    def hint(self, x, *spec):
        """Interior layout hint (Megatron-style): entries are 'dp', 'tp' or
        None.  Active when ``hint_dp`` (or ``act_pspec``) is set, and only
        on a ``DTensor``: a plain tensor comes back as it is."""
        dp = self.hint_dp if self.hint_dp is not None else (
            self.act_pspec[0] if self.act_pspec is not None else None)
        if dp is None:
            return x
        return constrain(x, tuple(dp if s == "dp" else (
            "model" if s == "tp" else None) for s in spec))

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
