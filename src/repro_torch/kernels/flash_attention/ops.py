"""Dispatch of prefill attention over model-layout tensors: CUDA kernel or
plain PyTorch version.

The choice follows the tensors alone: a CPU tensor goes to the plain
version (``ref.py``), which autograd differentiates as it is; a CUDA
tensor launches the kernel (``flash_attention.py``) or raises.  There is
no fallback from the kernel to the plain version.  On CUDA the launch
goes through ``MHA``: the kernel writes its output through raw pointers,
which autograd cannot see, so without it q, k and v would get no
gradient and nothing would fail.  Where no gradient is wanted (serving,
under ``no_grad``) ``MHA.apply`` runs its forward alone and records no
graph.  On a device mesh q, k and v are ``DTensor``s, which have no
storage of their own: ``mha`` runs on their local shards (batch and heads
split, nothing else) and wraps the output back.  A meta tensor (the dry
run's) takes the plain version: it has no data to launch on.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import ref
from repro_torch.kernels.flash_attention.flash_attention import \
    flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.spmd import is_dtensor, local_call


def _launch(q, k, v, *, causal, window, scale):
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=causal, window=window, scale=scale)


class MHA(torch.autograd.Function):
    """Attention whose forward is ``forward`` (the kernel's launch on the
    card; a test on the CPU passes the plain version) and whose backward
    is the reference's: the JAX package has no backward kernel and trains
    through plain autodiff of its attention.  The backward differentiates
    ``ref.block`` one query block of ``block_q`` rows at a time (each
    block's graph freed before the next is built), so it never holds
    more than one block's f32 probabilities, as the reference checkpoints
    its chunk body for the same reason.  The f32 gradients are summed over
    the blocks and rounded to the inputs' dtypes once, as autodiff of
    ``flash_attention_ref`` rounds them at its casts."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, forward, block_q):
        ctx.save_for_backward(q, k, v)
        ctx.args = causal, window, scale, block_q
        return forward(q, k, v, causal=causal, window=window, scale=scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        causal, window, scale, block_q = ctx.args
        b, s, h, d = q.shape
        scale = d ** -0.5 if scale is None else scale
        qf, kf, vf = ref.grouped(q, k, v)
        gg = g.float().reshape(b, s, qf.shape[1], qf.shape[2], d) \
            .permute(0, 2, 3, 1, 4)
        dq, dk, dv = (torch.zeros_like(x) for x in (qf, kf, vf))
        for q0 in range(0, s, block_q):
            q1 = min(s, q0 + block_q)
            lo, hi = ref.key_range(q0, q1, s, causal, window)
            qb, kb, vb = (x.detach().requires_grad_() for x in (
                qf[:, :, :, q0:q1], kf[:, :, lo:hi], vf[:, :, lo:hi]))
            with torch.enable_grad():
                out = ref.block(qb, kb, vb, q0, lo, causal=causal,
                                window=window, scale=scale)
                gq, gk, gv = torch.autograd.grad(
                    out, (qb, kb, vb), gg[:, :, :, q0:q1])
            dq[:, :, :, q0:q1] += gq
            dk[:, :, lo:hi] += gk
            dv[:, :, lo:hi] += gv
        dq = dq.permute(0, 3, 1, 2, 4).reshape(b, s, h, d).to(q.dtype)
        dk = dk.permute(0, 2, 1, 3).to(k.dtype)
        dv = dv.permute(0, 2, 1, 3).to(v.dtype)
        return dq, dk, dv, None, None, None, None, None


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True, window: int = 0,
        scale: float | None = None) -> torch.Tensor:
    """q (B, S, H, D); k/v (B, S, Hkv, D) with ``H % Hkv == 0`` ->
    (B, S, H, D), the f32 scores scaled by ``scale`` (default D^-0.5).

    With Hkv = H this is the JAX package's ``mha``; with Hkv < H, query
    head h reads KV head ``h // (H // Hkv)`` and K/V are never repeated.
    On CUDA the launch goes through ``MHA``."""
    if is_dtensor(q):
        return local_call(lambda q, k, v: mha(q, k, v, causal=causal,
                                              window=window, scale=scale),
                          (q, k, v), (0, 2))
    if q.device.type in ("cpu", "meta"):
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   scale=scale)
    return MHA.apply(q, k, v, causal, window, scale, _launch, 256)
