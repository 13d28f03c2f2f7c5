"""A model of the bf16 CUDA kernel (``csrc/flash_attention.cu``) in
PyTorch, on any device: its tiling, the key tiles it visits, its softmax
order and its rounding of P.

Not on any main path: the tests hold it against the plain version for
each way of rounding P, on the CPU and at the Qwen2-7B prefill shape on
the card, which is how the question of P's precision is answered.  It walks the kernel's
128-query blocks and 128-key tiles, visits the same key tiles
(``key_tiles`` in the source), and applies the online softmax in the
kernel's order: the f32 scores times the f32 scale * log2(e), masked
entries -1e30, a running max from -1e30, ``exp2``, the denominators summed
from the f32 probabilities, P rounded as ``p_mode`` says before P V, the
output acc / max(l, 1e-30) rounded to bf16.  It does not reproduce the
kernel's rounding errors: the scores and products are summed in f32 as
the plain version sums them, not as the tensor cores do, ``exp2`` is
exact where the kernel's ``ex2.approx`` is within 2 ulp, and the scale and
subtraction are two roundings where the kernel fuses them on tiles
without masked entries.  On the LM's activations the kernel strays
further from the plain version than this model does; with TF32 matmuls
allowed on the card (bf16 values and P's bf16 parts are exact in TF32)
the model's products are summed on the tensor cores, and then it strays
about as far as the kernel (PERF.md).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.flash_attention import p_mode as \
    kernel_p_mode

NEG = -1e30
BLOCK_Q = 128     # queries per block (kBQ in the source)
BLOCK_K = 128     # keys per tile (kBK)
P_MODES = ("split", "bf16")


def round_p(p: torch.Tensor, p_mode: str) -> tuple:
    """The bf16 parts of the probabilities that P V multiplies: (high,
    remainder) for ``split``, (high,) for one bf16 P."""
    hi = p.to(torch.bfloat16).float()
    if p_mode == "bf16":
        return (hi,)
    if p_mode == "split":
        return hi, (p - hi).to(torch.bfloat16).float()
    raise ValueError(f"p_mode must be one of {P_MODES}, got {p_mode!r}")


def key_tiles(s: int, q0: int, causal: bool, window: int) -> range:
    """Key tiles that queries q0 .. q0 + BLOCK_Q - 1 visit."""
    last = s - 1
    if causal:
        last = min(last, min(q0 + BLOCK_Q, s) - 1)
    first = max(0, q0 - window + 1) if window > 0 else 0
    return range(first // BLOCK_K, last // BLOCK_K + 1)


def flash_attention_emulated(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, causal: bool = True,
                             window: int = 0,
                             p_mode: str | None = None) -> torch.Tensor:
    """q (B, S, H, D), k/v (B, S, Hkv, D), bf16 -> (B, S, H, D) bf16,
    through the kernel's tiles and softmax order with P rounded by
    ``p_mode`` (default: as the kernel rounds it)."""
    p_mode = p_mode or kernel_p_mode()
    b, s, h, d = q.shape
    hkv = k.shape[2]
    pad = -s % BLOCK_K                # the kernel's zero-filled keys
    qf = q.float().reshape(b, s, hkv, h // hkv, d).permute(0, 2, 3, 1, 4)
    kf = torch.nn.functional.pad(k.float().permute(0, 2, 1, 3),
                                 (0, 0, 0, pad))[:, :, None]
    vf = torch.nn.functional.pad(v.float().permute(0, 2, 1, 3),
                                 (0, 0, 0, pad))[:, :, None]
    scale2 = (torch.tensor(d ** -0.5, dtype=torch.float32) *
              torch.tensor(1.4426950408889634, dtype=torch.float32))
    out = torch.empty_like(qf)        # (B, Hkv, rep, S, D)
    for q0 in range(0, s, BLOCK_Q):
        q1 = min(s, q0 + BLOCK_Q)
        rows = torch.arange(q0, q1, device=q.device)[:, None]
        qb = qf[:, :, :, q0:q1]
        m = torch.full(qb.shape[:-1], NEG, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(qb)
        for kt in key_tiles(s, q0, causal, window):
            k0 = kt * BLOCK_K
            keys = torch.arange(k0, k0 + BLOCK_K, device=q.device)[None, :]
            kb = kf[..., k0:k0 + BLOCK_K, :]
            x = (qb @ kb.transpose(-1, -2)) * scale2
            masked = keys >= s
            if causal:
                masked = masked | (keys > rows)
            if window > 0:
                masked = masked | (keys <= rows - window)
            x = torch.where(masked, torch.tensor(NEG, device=q.device), x)
            m_new = torch.maximum(m, x.amax(-1))
            corr = torch.exp2(m - m_new)
            p = torch.exp2(x - m_new[..., None])
            m = m_new
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None]
            for part in round_p(p, p_mode):
                acc = acc + part @ vf[..., k0:k0 + BLOCK_K, :]
        out[:, :, :, q0:q1] = acc / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, d).to(q.dtype)
