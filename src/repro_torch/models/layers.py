"""Shared NN building blocks: RMS norm, RoPE, SwiGLU, embeddings, LM head.

The port's counterpart of ``repro.models.layers`` for the dense LM family,
with the reference's casts step for step: bf16 storage and matmuls, f32
norm statistics, RoPE angles and activations.  Every function takes the
parameters it reads (``ParamTree`` entries or plain tensors).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.param import Spec
from repro_torch.models.sincosf import sincos_f32

NEG = -1e30


def rms_norm_spec(d: int) -> Spec:
    return Spec((d,), ("embed",), init="ones")


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """Normalise in f32, round to x's dtype, then times the weight."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def rope_angles(positions: torch.Tensor, dim: int,
                theta: float) -> torch.Tensor:
    """positions (..., S) -> angles (..., S, dim//2), f32.

    The f32 exponents ``-i / half`` as the reference; the power is taken in
    f64 and rounded, i.e. the correctly rounded f32 power, which is what
    XLA's f32 ``theta ** e`` gives (torch's f32 ``pow`` is one ulp off on a
    few of Qwen2-7B's 64 frequencies).  The angles are f32 products."""
    half = dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    freqs = torch.pow(float(theta), exps.double()).float()
    return positions[..., None].float() * freqs


def rope_tables(angles: torch.Tensor):
    """angles (B, S, D/2) -> (sin, cos), each (B, S, 1, D/2) f32: the C
    library's ``sinf`` / ``cosf``, which the reference's CPU build calls
    (``sincosf``).  Taken once a forward and shared by every layer."""
    sin, cos = sincos_f32(angles)
    return sin[:, :, None, :], cos[:, :, None, :]


def apply_rope(x: torch.Tensor, rope) -> torch.Tensor:
    """x (B, S, H, D), rope ``rope_tables``' (sin, cos) -> rotated x
    (rotate-half convention), computed in f32 and rounded to x's dtype."""
    sin, cos = rope
    x1, x2 = x.chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu_spec(d: int, f: int):
    return {"wi": Spec((d, 2 * f), ("embed", "ffn")),
            "wo": Spec((f, d), ("ffn", "embed"))}


def swiglu(p, x: torch.Tensor) -> torch.Tensor:
    """silu in f32, cast to x's dtype, gate, down projection."""
    g, u = (x @ p["wi"]).chunk(2, dim=-1)
    return (F.silu(g.float()).to(x.dtype) * u) @ p["wo"]


def embed_spec(vocab_padded: int, d: int, tied: bool = True) -> Spec:
    if tied:
        return Spec((vocab_padded, d), ("vocab", "embed"), init="embed")
    return Spec((vocab_padded, d), ("vocab_in", "embed_tp"), init="embed")


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens]


def lm_logits(x: torch.Tensor, table_or_head: torch.Tensor,
              vocab_logical: int, transpose: bool) -> torch.Tensor:
    """Project to the (padded) vocab in x's dtype, then f32; padded slots
    are masked to -1e30."""
    w = table_or_head.t() if transpose else table_or_head   # (d, Vp)
    logits = (x @ w).float()
    vp = logits.shape[-1]
    if vp > vocab_logical:
        pad = torch.arange(vp, device=logits.device) >= vocab_logical
        logits = logits.masked_fill(pad, NEG)
    return logits
