"""Wrapper of the Hopper ``flash_attention`` kernel
(``csrc/flash_attention.cu``).

Replaces the Pallas TPU kernel
``repro/kernels/flash_attention/flash_attention.py`` (``flash_attention``).
One launch computes a whole prefill attention in the model's layout:
q (B, S, H, D) over k/v (B, S, Hkv, D), query head ``h`` reading KV head
``h // (H // Hkv)``.  bf16 runs on the tensor cores (TMA loads, wgmma),
f32 on the CUDA cores.  The source instantiates the head dims of
``HEAD_DIMS``; any other D up to the largest is zero-padded to the next
one (``padded``) with the true ``D ** -0.5`` passed, which is exact.

The library is built and loaded at the first launch, never at import, so
this module imports on machines without CUDA or ``nvcc``.
"""
from __future__ import annotations

import ctypes
import re

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

KERNEL = "flash_attention"
HEAD_DIMS = (16, 32, 64, 128, 192)   # the D the CUDA source instantiates
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


class _Counter:
    """Launches of the kernel in this process (one per successful launch)."""
    launches = 0


COUNTER = _Counter()


def _lib() -> ctypes.CDLL:
    lib = _build.load(KERNEL)
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + \
            [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def p_mode() -> str:
    """How the bf16 kernel rounds P before P V, read from its source:
    ``issue_pv`` runs one register-form wgmma per bf16 part of P, so two
    (P's bf16 high part and its remainder) are ``"split"`` and one is
    ``"bf16"`` (the modes of ``emulate.round_p``)."""
    src = (_build.CSRC / f"{KERNEL}.cu").read_text()
    body = re.search(r"void issue_pv\(.*?\n}\n", src, re.S).group(0)
    return {1: "bf16", 2: "split"}[body.count("wgmma_rs<")]


def padded_head_dim(d: int) -> int:
    """The instantiated head dim that D pads to; raises ``ValueError``
    past the largest."""
    for dp in HEAD_DIMS:
        if d <= dp:
            return dp
    raise ValueError(f"flash_attention: head_dim {d} not supported; the "
                     f"kernel takes D up to {HEAD_DIMS[-1]}")


def padded(attend, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool = True, window: int = 0,
           scale: float | None = None) -> torch.Tensor:
    """``attend(q, k, v, causal=, window=, scale=)`` at the padded head dim:
    q, k, v zero-padded to ``padded_head_dim(D)`` columns, the true
    ``D ** -0.5`` as the scale (or ``scale`` when given), the output's
    first D columns.  Exact: the zero columns add nothing to the scores,
    and the output's padded columns are P times zeros."""
    d = q.shape[-1]
    dp = padded_head_dim(d)
    scale = d ** -0.5 if scale is None else scale
    if dp == d:
        return attend(q, k, v, causal=causal, window=window, scale=scale)
    q, k, v = (F.pad(x, (0, dp - d)) for x in (q, k, v))
    out = attend(q, k, v, causal=causal, window=window, scale=scale)
    return out[..., :d].contiguous()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: float | None = None) -> torch.Tensor:
    """Launch the CUDA kernel: q (B, S, H, D), k/v (B, S, Hkv, D) with
    ``H % Hkv == 0``, all contiguous and 16-byte aligned on one CUDA device,
    of one dtype (f32 or bf16), D at most ``HEAD_DIMS[-1]`` -> (B, S, H, D)
    in that dtype (contract of ``ref.flash_attention_ref``; scores scaled
    by ``scale``, default D^-0.5).  A D outside ``HEAD_DIMS`` runs
    zero-padded (``padded``).

    Runs on the current stream without synchronising; raises if the launch
    is refused."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: q must be (B, S, H, D) and k/v "
                         f"(B, S, Hkv, D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, d = q.shape
    hkv = k.shape[2]
    if k.shape[0] != b or k.shape[1] != s or k.shape[3] != d or hkv == 0 \
            or h % hkv:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not fit "
                         f"q {tuple(q.shape)}")
    padded_head_dim(d)
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_attention: q, k, v must share one dtype, f32 "
                         f"or bf16; got {q.dtype}, {k.dtype}, {v.dtype}")
    if window < 0:
        raise ValueError(f"flash_attention: window must be >= 0, got {window}")
    if q.device.type != "cuda":
        raise ValueError("flash_attention launches the CUDA kernel and needs "
                         f"CUDA tensors; got {q.device}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device or not x.is_contiguous() or \
                x.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be contiguous and "
                             f"16-byte aligned on {q.device}")
    if q.numel() == 0:
        return torch.empty_like(q)
    return padded(_launch, q, k, v, causal=causal, window=window,
                  scale=scale)


def _launch(q, k, v, *, causal, window, scale):
    """One launch at an instantiated head dim, scores scaled by ``scale``."""
    b, s, h, d = q.shape
    out = torch.empty_like(q)
    err = _lib().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, h,
        k.shape[2], d, int(bool(causal)), int(window), scale,
        _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    COUNTER.launches += 1
    return out
