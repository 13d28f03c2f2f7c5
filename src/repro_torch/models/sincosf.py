"""RoPE's f32 sine and cosine as the JAX package's CPU build computes them,
in plain torch ops.

XLA's CPU backend lowers ``jnp.sin`` / ``jnp.cos`` on f32 to calls of the
C library's ``sinf`` / ``cosf``.  With glibc 2.36 that is
``sysdeps/ieee754/flt-32/s_sinf.c`` and ``s_cosf.c`` over ``sincosf.h``:
the argument in double; below 0.75 (the top-12-bit compare against pi/4)
no reduction, below 120 the reduction ``x - n * pi/2`` with ``n`` from a
truncating int32 conversion of ``x * 2^24 * 2/pi``, above it a reduction
by the bits of 2/pi in 64-bit integer arithmetic; then a degree-3 odd
polynomial for the sine or a degree-4 even one for the cosine, chosen and
signed by the quadrant, and one rounding to f32.  ``torch.sin`` on f32
differs from it by one ulp on a few percent of RoPE's angles, and so does
the correctly rounded value (the library's polynomial is good to ~2^-29,
not to the last bit): one such ulp can flip the bf16 rounding of a rotated
query and move a logit by a few hundredths.

``sincos_f32`` is that routine in float64 and int64 torch ops, each a
separate elementwise op, so the CPU and the card give the same bits (held
on the card by ``chip_smoke.py``).  The constants are the library's
``.rodata`` words (``__sincosf_table`` and ``__inv_pio4``).  The library's
FMA build contracts some of the products below into one rounding; that
moves the double result by an ulp at most, and on every RoPE angle of the
repo's configurations and 2^18 finite f32 values drawn over the whole
range this function gives ``jnp.sin`` / ``jnp.cos``'s f32 bits
(``tests/test_torch_models.py``).
"""
from __future__ import annotations

import torch

_H = float.fromhex
HPI_INV = _H("0x1.45f306dc9c883p+23")        # 2/pi * 2^24
HPI = _H("0x1.921fb54442d18p+0")             # pi/2
PI63 = _H("0x1.921fb54442d18p-62")           # 2pi * 2^-64
C0, C1, C2, C3, C4 = (1.0, _H("-0x1.ffffffd0c621cp-2"),
                      _H("0x1.55553e1068f19p-5"), _H("-0x1.6c087e89a359dp-10"),
                      _H("0x1.99343027bf8c3p-16"))
S1, S2, S3 = (_H("-0x1.555545995a603p-3"), _H("0x1.1107605230bc4p-7"),
              _H("-0x1.994eb3774cf24p-13"))
# the bits of 4/pi, 32 at a time, each word shifted 8 bits on
INV_PIO4 = (0xa2, 0xa2f9, 0xa2f983, 0xa2f9836e, 0xf9836e4e, 0x836e4e44,
            0x6e4e4415, 0x4e441529, 0x441529fc, 0x1529fc27, 0x29fc2757,
            0xfc2757d1, 0x2757d1f5, 0x57d1f534, 0xd1f534dd, 0xf534ddc0,
            0x34ddc0db, 0xddc0db62, 0xc0db6295, 0xdb629599, 0x6295993c,
            0x95993c43, 0x993c4390, 0x3c439041)
# top 12 bits of |y|: 0.75 (pi/4 as f32, compared on 12 bits), 120, 2^-12
TOP_PIO4, TOP_120, TOP_TINY, TOP_INF = 0x3f4, 0x42f, 0x398, 0x7f8


def _reduce_fast(x: torch.Tensor):
    """|y| < 120: (x - n pi/2, n), n = ((int32)(x 2^24 2/pi) + 2^23) >> 24."""
    n = ((x * HPI_INV).trunc().long() + 0x800000) >> 24
    return x - n.double() * HPI, n


_TABLES = {}


def _inv_pio4(device) -> torch.Tensor:
    """``INV_PIO4`` on ``device``, copied there once (a copy from the host
    waits for the card)."""
    key = str(device)
    if key not in _TABLES:
        _TABLES[key] = torch.tensor(INV_PIO4, dtype=torch.int64,
                                    device=device)
    return _TABLES[key]


def _reduce_large(bits: torch.Tensor):
    """|y| >= 120, from y's bits (int64, 0 <= bits < 2^32): the reduced
    argument times 2pi 2^-64 and the quadrant, in uint64 arithmetic on
    int64 (products and shifts wrap alike; right shifts are masked)."""
    tab = _inv_pio4(bits.device)
    k = (bits >> 26) & 15
    m = ((bits & 0xffffff) | 0x800000) << ((bits >> 23) & 7)
    res0 = (m * tab[k]) & 0xffffffff
    res1 = m * tab[k + 4]
    res2 = m * tab[k + 8]
    r = (((res2 >> 32) & 0xffffffff) | (res0 << 32)) + res1
    n = ((r + (1 << 61)) >> 62) & 3
    return (r - (n << 62)).double() * PI63, n


def _sin_poly(x, x2):
    x3 = x * x2
    s1 = S2 + x2 * S3
    x7 = x3 * x2
    s = x + x3 * S1
    return s + x7 * s1


def _cos_poly(x2):
    x4 = x2 * x2
    c2 = C3 + x2 * C4
    c1 = C0 + x2 * C1
    x6 = x4 * x2
    c = c1 + x4 * C2
    return c + x6 * c2


def sincos_f32(y: torch.Tensor):
    """y (any shape, f32) -> (sinf(y), cosf(y)) f32, glibc 2.36's bits."""
    y = y.float()
    x = y.double()
    bits = y.view(torch.int32).long() & 0xffffffff
    top = (bits >> 20) & 0x7ff
    small = top < TOP_PIO4
    fast = ~small & (top < TOP_120)
    xf, nf = _reduce_fast(x)
    xl, nl = _reduce_large(bits)
    xr = torch.where(small, x, torch.where(fast, xf, xl))
    n = torch.where(small, 0, torch.where(fast, nf, nl))
    # the large path's quadrant of signs counts y's sign in
    q = torch.where(small | fast, n, n + (bits >> 31)) & 3
    s = torch.where((q == 1) | (q == 2), -1.0, 1.0).double()
    t = torch.where(q >= 2, -1.0, 1.0).double()     # the second table
    x2 = xr * xr
    sp = _sin_poly(xr * s, x2)
    cp = _cos_poly(x2) * t
    odd = (n & 1) == 1
    sin = torch.where(odd, cp, sp).float()
    cos = torch.where(odd, sp, cp).float()
    tiny = top < TOP_TINY                           # sinf(y) = y, cosf = 1
    bad = top >= TOP_INF                            # inf, nan -> nan
    sin = torch.where(tiny, y, torch.where(bad, y - y, sin))
    cos = torch.where(tiny, torch.ones_like(y), torch.where(bad, y - y, cos))
    return sin, cos
