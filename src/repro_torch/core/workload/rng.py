"""Counter-based draws and the f32 prefix sum of the workload generator.

The JAX package draws with ``jax.random`` (threefry-2x32, partitionable
counters) and accumulates arrival clocks with ``jnp.cumsum``.  This module
computes the same numbers as torch ops on any device:

 * ``threefry2x32`` on int64 tensors masked to 32 bits (torch's ``uint32``
   has no general arithmetic): 20 rounds, rotations ``[13, 15, 26, 6]`` /
   ``[17, 29, 16, 24]``, a key injection every 4 rounds with the
   ``0x1BD11BDA`` parity word — bitwise ``jax.random``'s hash;
 * ``prng_key`` / ``fold_in`` / ``uniform``: ``PRNGKey``, ``fold_in`` and
   ``uniform`` with ``jax_threefry_partitionable`` on (each element's
   counter is its flat index as (hi, lo), ``bits = b1 ^ b2``), vectorised
   over a tensor of keys (leading axes, last axis 2) and of fold-in data;
 * ``cumsum_f32``: the order in which XLA on the CPU adds an f32 prefix
   sum — blocks of 16 added one after another from their start, the block
   totals scanned the same way, recursively, and each block's exclusive
   prefix added last.  ``torch.cumsum`` adds in another order (a CUB tree
   scan on CUDA) and rounds differently.
"""
from __future__ import annotations

import math

import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
SCAN_BLOCK = 16


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK32) | (x >> (32 - r))


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor):
    """The threefry-2x32 hash of counters ``(x0, x1)`` under key
    ``(k0, k1)``; int64 tensors holding 32-bit words, broadcast together.
    Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = x0 ^ _rotl(x1, r)
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for an int32 seed: ``(0, seed)`` as
    int64 words, shape ``(2,)``."""
    return torch.tensor([0, int(seed) & MASK32], dtype=torch.int64,
                        device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: the hash of counter ``(0, data)`` under
    ``key``.  ``key`` is ``(..., 2)``; ``data`` an int or an integer tensor
    that broadcasts against ``key[..., 0]`` (taken mod 2**32, as the JAX
    package's uint32 cast wraps it).  Returns keys ``(broadcast, 2)``."""
    if not isinstance(data, torch.Tensor):
        data = torch.tensor(int(data), device=key.device)
    lo = data.to(torch.int64) & MASK32
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(lo), lo)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def uniform(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` (f32 in [0, 1)) for every key of
    ``key`` (``(..., 2)``): returns ``key.shape[:-1] + shape``."""
    shape = tuple(shape)
    cnt = torch.arange(math.prod(shape), dtype=torch.int64,
                       device=key.device)
    lead = key.shape[:-1]
    k0 = key[..., 0].reshape(lead + (1,))
    k1 = key[..., 1].reshape(lead + (1,))
    b0, b1 = threefry2x32(k0, k1, cnt >> 32, cnt & MASK32)
    bits = (((b0 ^ b1) >> 9) | 0x3F800000).to(torch.int32)
    f = bits.view(torch.float32) - 1.0
    return torch.clamp_min(f, 0.0).reshape(lead + shape)


def cumsum_f32(x: torch.Tensor) -> torch.Tensor:
    """Inclusive f32 prefix sum along the last axis, added in the order of
    XLA's CPU scan: blocks of ``SCAN_BLOCK`` added left to right (15
    elementwise adds), the block totals scanned recursively, and each
    block's exclusive prefix added to it."""
    n = x.shape[-1]
    lead = x.shape[:-1]
    if n <= SCAN_BLOCK:
        return _block_scan(x)
    nb = -(-n // SCAN_BLOCK)
    pad = nb * SCAN_BLOCK - n
    if pad:
        x = torch.cat([x, x.new_zeros(lead + (pad,))], dim=-1)
    inner = _block_scan(x.reshape(lead + (nb, SCAN_BLOCK)))
    totals = cumsum_f32(inner[..., -1])
    excl = torch.cat([totals.new_zeros(lead + (1,)), totals[..., :-1]],
                     dim=-1)
    out = inner + excl[..., None]
    return out.reshape(lead + (nb * SCAN_BLOCK,))[..., :n]


def _block_scan(x: torch.Tensor) -> torch.Tensor:
    """Sequential inclusive sum along a last axis of at most 16."""
    cols = [x[..., 0]]
    for k in range(1, x.shape[-1]):
        cols.append(cols[-1] + x[..., k])
    return torch.stack(cols, dim=-1)
