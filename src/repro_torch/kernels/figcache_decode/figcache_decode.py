"""Wrapper of the Hopper ``figcache_decode`` kernel
(``csrc/figcache_decode.cu``).

Replaces the Pallas TPU kernel
``repro/kernels/figcache_decode/figcache_decode.py`` (``figcache_decode``).
One launch answers every (sequence, query head) of a decode step.  K/V stay
in the (B, L, Hkv, D) layout the FIGCache-KV step gathers; query head ``h``
reads KV head ``h // (H // Hkv)``.

The library is built and loaded at the first launch, never at import, so
this module imports on machines without CUDA or ``nvcc``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

KERNEL = "figcache_decode"
MAX_D = 512            # kMaxD of the CUDA source
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


class _Counter:
    """Launches of the kernel in this process (one per successful launch)."""
    launches = 0


COUNTER = _Counter()


def _lib() -> ctypes.CDLL:
    lib = _build.load(KERNEL)
    fn = lib.figcache_decode_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + \
            [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def figcache_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    valid: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel: q (B, H, D), k/v (B, L, Hkv, D) with
    ``H % Hkv == 0``, valid (B, L) bool, all contiguous on one CUDA device,
    q/k/v of one dtype (f32 or bf16), L >= 1, D <= 512 -> (B, H, D) in
    that dtype (contract of ``ref.figcache_decode_ref``).

    Runs on the current stream without synchronising; raises if the launch
    is refused."""
    if q.device.type != "cuda":
        raise ValueError("figcache_decode launches the CUDA kernel and needs "
                         f"CUDA tensors; got {q.device}")
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"figcache_decode: q must be (B, H, D) and k/v "
                         f"(B, L, Hkv, D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, d = q.shape
    _, length, hkv, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d or hkv == 0 or h % hkv:
        raise ValueError(f"figcache_decode: k/v {tuple(k.shape)} do not fit "
                         f"q {tuple(q.shape)}")
    if valid.dtype != torch.bool or tuple(valid.shape) != (b, length):
        raise ValueError(f"figcache_decode: valid must be ({b}, {length}) "
                         "bool")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("figcache_decode: q, k, v must share one dtype, f32 "
                         f"or bf16; got {q.dtype}, {k.dtype}, {v.dtype}")
    if not 1 <= length or not 1 <= d <= MAX_D:
        raise ValueError(f"figcache_decode: needs L >= 1 and 1 <= D <= "
                         f"{MAX_D}; got L={length}, D={d}")
    for name, x in (("q", q), ("k", k), ("v", v), ("valid", valid)):
        if x.device != q.device or not x.is_contiguous():
            raise ValueError(f"figcache_decode: {name} must be contiguous on "
                             f"{q.device}")
    out = torch.empty_like(q)
    err = _lib().figcache_decode_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
        out.data_ptr(), b, h, hkv, length, d, d ** -0.5, _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"figcache_decode kernel launch failed: CUDA "
                           f"error {err}")
    COUNTER.launches += 1
    return out
