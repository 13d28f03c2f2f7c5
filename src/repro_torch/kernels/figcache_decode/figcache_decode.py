"""Wrapper of the Hopper ``figcache_decode`` kernel
(``csrc/figcache_decode.cu``).

Replaces the Pallas TPU kernel
``repro/kernels/figcache_decode/figcache_decode.py`` (``figcache_decode``).
One launch answers every (sequence, query head) of a decode step.  K/V stay
in the (B, L, Hkv, D) layout the FIGCache-KV step gathers; query head ``h``
reads KV head ``h // (H // Hkv)``.

The launch follows a plan made here (``plan``), which the model of the
kernel (``emulate.py``) shares: one block per (L-split, KV head, head tile
of up to 8 query heads, sequence), the splits of one (sequence, KV head,
tile) forming a thread block cluster that combines them, each split
walked in chunks of keys through a ring of one or two stages in shared
memory.

The library is built and loaded at the first launch, never at import, so
this module imports on machines without CUDA or ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build

KERNEL = "figcache_decode"
MAX_D = 512              # kMaxD of the CUDA source
MAX_GROUP = 8            # kMaxG: query heads per block, one warp each
MAX_SPLITS = 8           # kMaxSplits: the portable thread block cluster
MAX_CHUNK = 256          # kMaxChunk: keys per ring stage
RING_BYTES = 96 * 1024   # shared memory for the K/V ring of one block
SMS = 132                # streaming multiprocessors of an H100 SXM
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


class _Counter:
    """Launches of the kernel in this process (one per successful launch)."""
    launches = 0


COUNTER = _Counter()


class Plan(NamedTuple):
    """How one call is cut: ``splits`` blocks (one cluster) per (sequence,
    KV head, head tile); ``chunk`` keys per ring stage, ``stages`` of them;
    ``blocks`` in the grid."""
    splits: int
    tiles: int
    chunk: int
    stages: int
    blocks: int


def row_stride(d: int, item: int) -> int:
    """Bytes between K/V rows in the ring (``Problem::rs`` of the source):
    D padded to 16 elements (bf16, the mma's depth) or 4 (f32), in 16-byte
    units, plus one unit where their count is even (bank groups)."""
    unit = 16 if item == 2 else 4
    n = -(-d // unit) * unit * item
    return n + 16 if (n // 16) % 2 == 0 else n


def split_count(units: int, length: int) -> int:
    """Splits of L for ``units`` (sequence, KV head, head tile) triples:
    enough blocks for about three quarters of the card's SMs, at most the
    cluster limit and at most L (so no split is empty).  A cluster's
    blocks are placed within one GPC, so a grid that asks for every SM
    doubles blocks up on some; ``chip_smoke.py`` prints the time by split
    count at the FIGCache-KV shape, where this gives 3."""
    return max(1, min(MAX_SPLITS, length, (3 * SMS // 4) // units))


def split_bounds(length: int, splits: int) -> List[Tuple[int, int]]:
    """Keys [lo, hi) of each split, as the kernel computes them: split s
    starts at floor(s L / S)."""
    return [(s * length // splits, (s + 1) * length // splits)
            for s in range(splits)]


@functools.lru_cache(maxsize=1024)
def plan(b: int, h: int, hkv: int, length: int, d: int, item: int,
         splits: Optional[int] = None) -> Plan:
    """The launch's plan for q (b, h, d), k/v (b, length, hkv, d) of
    ``item``-byte elements; ``splits`` overrides the split count (1..8)."""
    tiles = -(-(h // hkv) // MAX_GROUP)
    units = b * hkv * tiles
    if splits is None:
        splits = split_count(units, length)
    if not 1 <= splits <= MAX_SPLITS:
        raise ValueError(f"figcache_decode: splits must be 1..{MAX_SPLITS}, "
                         f"got {splits}")
    keys = -(-length // splits)            # the longest split
    row = 2 * row_stride(d, item)          # a K row and a V row
    step = 16 if item == 2 else 1          # bf16 tiles hold whole mma steps

    def rows(stages):
        return min(MAX_CHUNK, RING_BYTES // (stages * row) // step * step)

    if -(-keys // step) * step <= rows(1):
        chunk, stages = keys, 1
    else:
        chunk, stages = rows(2), 2
    return Plan(splits, tiles, chunk, stages, units * splits)


def _lib() -> ctypes.CDLL:
    lib = _build.load(KERNEL)
    fn = lib.figcache_decode_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + \
            [ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.figcache_decode_smem_bytes.argtypes = [ctypes.c_int] * 8
        lib.figcache_decode_smem_bytes.restype = ctypes.c_int
    return lib


def smem_bytes(h: int, hkv: int, length: int, d: int, dtype: torch.dtype,
               p: Plan) -> int:
    """Dynamic shared memory of one block of plan ``p`` (the kernel's own
    layout, so this builds the library)."""
    return _lib().figcache_decode_smem_bytes(h, hkv, length, d,
                                             _DTYPES[dtype], p.splits,
                                             p.chunk, p.stages)


def figcache_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    valid: torch.Tensor, *,
                    splits: Optional[int] = None) -> torch.Tensor:
    """Launch the CUDA kernel: q (B, H, D), k/v (B, L, Hkv, D) with
    ``H % Hkv == 0``, valid (B, L) bool, all contiguous on one CUDA device,
    q/k/v of one dtype (f32 or bf16), L >= 1, D <= 512 -> (B, H, D) in
    that dtype (contract of ``ref.figcache_decode_ref``).  ``splits``
    overrides ``plan``'s split count (1..8; the tests force L < splits).

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
    p = plan(b, h, hkv, length, d, q.element_size(), splits)
    out = torch.empty_like(q)
    err = _lib().figcache_decode_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
        out.data_ptr(), b, h, hkv, length, d, d ** -0.5, _DTYPES[q.dtype],
        p.splits, p.chunk, p.stages,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"figcache_decode kernel launch failed: CUDA "
                           f"error {err}")
    COUNTER.launches += 1
    return out
