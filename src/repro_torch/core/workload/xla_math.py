"""The workload generator's f32 transcendentals as the JAX package's CPU
build computes them, in plain torch ops.

``jnp.log1p``, ``jnp.log`` and ``jnp.exp`` on f32 are inline polynomials
that XLA's CPU backend emits into each fusion (Cephes-style: the
``sqrt(0.5)`` split and a degree-8 chain for ``log``, a rational form
below ``sqrt(2) - 1`` for ``log1p``, ``log2(e)`` with a two-part ``ln 2``
and ``floor`` for ``exp``).  LLVM then contracts a multiply whose product
has one use into the add or subtract that consumes it (``vfmadd`` in the
object code; where both addends are such products, the first one); a
product with two uses, or one that feeds another multiply, stays rounded.
The functions below follow that object code
operation by operation: every ``fma_f32`` is a contracted pair, every bare
``*`` / ``+`` a rounded one.  The constants are the hex literals of the
optimized LLVM IR (``--xla_dump_to``, ``*.ir-with-opt.ll``); the fused
pairs were read from ``objdump -d`` of the matching ``*.o``.

``x ** y`` is not inlined: XLA calls the C library's ``powf``.  With
glibc 2.36 on an x86-64 CPU with FMA and AVX2 that is the FMA build of
``sysdeps/ieee754/flt-32/e_powf.c``: a ``log2`` in double from a 16-entry
``(1/c, log2 c)`` table and a degree-5 polynomial, ``y * log2 x``, an
``exp2`` from a 32-entry table and a degree-3 polynomial, one rounding to
f32.  ``pow_f32`` is that routine in float64 torch ops; the tables and
coefficients are its ``.rodata`` words, addresses below.  Its six double
``vfmadd...sd`` are evaluated as a rounded product and a rounded sum, which
is the library's generic (non-FMA) build exactly: over every ``u`` of the
generator's ``pow`` expressions at the presets' and the fig-8 apps' knobs
the two builds give the same f32 bits (``tests/test_torch_workload.py``).

An f32 fused multiply-add is emulated, never taken from the device: the
product of two f32 values is exact in float64, the float64 sum is rounded
to odd (TwoSum's error decides the last bit) and then rounded once to f32,
which is exactly ``fmaf``.  Every step is a separate elementwise torch op
(no ``addcmul``, ``lerp`` or ``alpha``), so the CPU and the card give the
same bits.
"""
from __future__ import annotations

import struct

import torch

F32 = torch.float32
F64 = torch.float64
I32 = torch.int32
I64 = torch.int64


def _f32(bits: int) -> float:
    """The f32 value of an LLVM IR float literal (a double's bits)."""
    return struct.unpack("<d", struct.pack("<Q", bits))[0]


# ---------------------------------------------------------------------------
# exact f32 fused multiply-add

def _add_ro(a, b):
    """``a + b`` in float64 rounded to odd: the nearest sum, moved one ulp
    toward the exact sum when it was inexact and landed on an even
    significand."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    bits = s.view(I64)
    step = torch.where((err > 0) == (s > 0), 1, -1)
    fix = (err != 0) & ((bits & 1) == 0) & torch.isfinite(s)
    return torch.where(fix, bits + step, bits).view(F64)


def _as64(x):
    return x.double() if isinstance(x, torch.Tensor) else float(x)


def fma_f32(a, b, c) -> torch.Tensor:
    """``fmaf(a, b, c)``: f32 operands (tensors, or Python floats that are
    f32 values), one rounding.  ``a`` or ``b`` must be a tensor."""
    p = _as64(a) * _as64(b)
    return _add_ro(p, _as64(c)).float()


def _bits_to_f32(bits: torch.Tensor) -> torch.Tensor:
    return bits.to(I32).view(F32)


# ---------------------------------------------------------------------------
# log, log1p (XLA's f32 log and its log1p, which calls it above the cut)

_FLT_MIN = _f32(0x3810000000000000)             # 2**-126
_SQRTHF = _f32(0x3FE6A09E60000000)              # sqrt(0.5) in f32
_LOG_P = tuple(map(_f32, (
    0x3FB2043760000000, 0xBFBD7A3700000000,     # y1 = fma(x, P0, P1)
    0xBFBFCBA9E0000000, 0x3FC23D37E0000000,     # y2 = fma(x, P2, P3)
    0x3FC999D580000000, 0xBFCFFFFF80000000,     # y3 = fma(x, P4, P5)
    0x3FBDE4A340000000,                         # y1 = fma(y1, x, P6)
    0xBFC555CA00000000,                         # y2 = fma(y2, x, P7)
    0x3FD5555540000000)))                       # y3 = fma(y3, x, P8)
_LN2_LO = _f32(0xBF2BD01060000000)              # -2.12194440e-4
_LN2_HI = _f32(0x3FE6300000000000)              # 0.693359375
_NAN_BITS = -1                                  # XLA's NaN: 0xFFFFFFFF


def _log_core(y: torch.Tensor) -> torch.Tensor:
    """The polynomial of XLA's f32 ``log`` for finite positive ``y``."""
    y = torch.where(y > _FLT_MIN, y, torch.full_like(y, _FLT_MIN))
    bits = y.view(I32)
    e = ((bits >> 23) - 127).float() + 1.0
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(F32)
    small = m < _SQRTHF
    x = (m + -1.0) + torch.where(small, m, torch.zeros_like(m))
    e = e - torch.where(small, torch.ones_like(e), torch.zeros_like(e))
    z = x * x
    x3 = z * x
    p0, p1, p2, p3, p4, p5, p6, p7, p8 = _LOG_P
    y1 = fma_f32(fma_f32(x, p0, p1), x, p6)
    y2 = fma_f32(fma_f32(x, p2, p3), x, p7)
    y3 = fma_f32(fma_f32(x, p4, p5), x, p8)
    t = fma_f32(fma_f32(y1, x3, y2), x3, y3)
    t = fma_f32(t, x3, e * _LN2_LO)
    r = (x - z * 0.5) + t
    return fma_f32(e, _LN2_HI, r)


def _log_special(y: torch.Tensor, core: torch.Tensor) -> torch.Tensor:
    """XLA's edge cases around the polynomial: NaN (bits 0xFFFFFFFF) for
    ``y <= 0`` or NaN, ``-inf`` at 0, ``inf`` at ``inf``."""
    bits = core.view(I32)
    bits = torch.where((y <= 0) | torch.isnan(y),
                       torch.full_like(bits, _NAN_BITS), bits)
    out = bits.view(F32)
    out = torch.where(y == 0, torch.full_like(out, float("-inf")), out)
    return torch.where(y == float("inf"), torch.full_like(out, float("inf")),
                       out)


def log_f32(x: torch.Tensor) -> torch.Tensor:
    """``jnp.log`` of an f32 tensor as XLA's CPU build computes it."""
    return _log_special(x, _log_core(x))


_LOG1P_CUT = _f32(0x3FDA8279A0000000)           # sqrt(2) - 1 in f32
_LOG1P_DEN = tuple(map(_f32, (
    0x402E2035A0000000, 0x4054C30B60000000, 0x406BB865A0000000,
    0x4073519460000000, 0x406B0DB140000000, 0x404E0F3040000000)))
_LOG1P_NUM = tuple(map(_f32, (
    0x3F07BC0960000000, 0x3FDFE818A0000000, 0x401A509F40000000,
    0x403DE97380000000, 0x404E798EC0000000, 0x404C8E75A0000000,
    0x40340A2020000000)))


def log1p_f32(x: torch.Tensor) -> torch.Tensor:
    """``jnp.log1p`` of an f32 tensor as XLA's CPU build computes it: a
    rational approximation below ``sqrt(2) - 1`` in magnitude
    (``x - x**2/2 + x**3 * num(x) / den(x)``, Horner chains fused), else
    ``log(1 + x)``."""
    z = x * x
    zero = x * 0.0                    # the IR's x * -0.0 term, kept
    den = zero + 1.0
    for c in _LOG1P_DEN:
        den = fma_f32(x, den, c)
    num = zero + _LOG1P_NUM[0]
    for c in _LOG1P_NUM[1:]:
        num = fma_f32(x, num, c)
    small = fma_f32(z, -0.5, (z * x) * (num / den)) + x
    y = 1.0 + x
    large = _log_special(y, _log_core(y))
    return torch.where(torch.abs(x) < _LOG1P_CUT, small, large)


# ---------------------------------------------------------------------------
# exp

_EXP_LO = _f32(0xC055F33340000000)              # -87.8
_EXP_HI = _f32(0x4056333340000000)              # 88.8
_LOG2E = _f32(0x3FF7154760000000)
_EXP_P = tuple(map(_f32, (
    0x3F2A0D2CE0000000, 0x3F56E879C0000000, 0x3F81112100000000,
    0x3FA5553820000000, 0x3FC5555540000000))) + (0.5,)


def exp_f32(x: torch.Tensor) -> torch.Tensor:
    """``jnp.exp`` of an f32 tensor as XLA's CPU build computes it:
    ``n = floor(x log2 e + 1/2)`` clamped to [-127, 127], ``x - n ln 2`` in
    two parts, a degree-5 polynomial, times ``2**n`` built in the exponent
    field."""
    x = torch.where(x < _EXP_LO, torch.full_like(x, _EXP_LO), x)
    x = torch.where(x > _EXP_HI, torch.full_like(x, _EXP_HI), x)
    n = torch.floor(fma_f32(x, _LOG2E, 0.5))
    n = torch.clamp(n, -127.0, 127.0)
    x = fma_f32(n, -_LN2_HI, x)
    x = fma_f32(n, -_LN2_LO, x)
    p = fma_f32(x, _EXP_P[0], _EXP_P[1])
    for c in _EXP_P[2:]:
        p = fma_f32(p, x, c)
    r = 1.0 + fma_f32(p, x * x, x)
    return r * _bits_to_f32((n.to(I32) + 127) << 23)


# ---------------------------------------------------------------------------
# pow: glibc 2.36 powf, FMA build (libm.so.6 0x72ec0)

def _h(s: str) -> float:
    return float.fromhex(s)


# __powf_log2_data.tab, .rodata 0xae0e0: (invc, logc) for 16 subintervals
_POWF_TAB = (
    ("0x1.661ec79f8f3bep+0", "-0x1.efec65b963019p-2"),
    ("0x1.571ed4aaf883dp+0", "-0x1.b0b6832d4fca4p-2"),
    ("0x1.49539f0f010b0p+0", "-0x1.7418b0a1fb77bp-2"),
    ("0x1.3c995b0b80385p+0", "-0x1.39de91a6dcf7bp-2"),
    ("0x1.30d190c8864a5p+0", "-0x1.01d9bf3f2b631p-2"),
    ("0x1.25e227b0b8ea0p+0", "-0x1.97c1d1b3b7af0p-3"),
    ("0x1.1bb4a4a1a343fp+0", "-0x1.2f9e393af3c9fp-3"),
    ("0x1.12358f08ae5bap+0", "-0x1.960cbbf788d5cp-4"),
    ("0x1.0953f419900a7p+0", "-0x1.a6f9db6475fcep-5"),
    ("0x1.0000000000000p+0", "0x0.0p+0"),
    ("0x1.e608cfd9a47acp-1", "0x1.338ca9f24f53dp-4"),
    ("0x1.ca4b31f026aa0p-1", "0x1.476a9543891bap-3"),
    ("0x1.b2036576afce6p-1", "0x1.e840b4ac4e4d2p-3"),
    ("0x1.9c2d163a1aa2dp-1", "0x1.40645f0c6651cp-2"),
    ("0x1.886e6037841edp-1", "0x1.88e9c2c1b9ff8p-2"),
    ("0x1.767dcf5534862p-1", "0x1.ce0a44eb17bccp-2"))
# __powf_log2_data.poly, .rodata 0xae1e0
_POWF_A = tuple(map(_h, ("0x1.27616c9496e0bp-2", "-0x1.71969a075c67ap-2",
                         "0x1.ec70a6ca7baddp-2", "-0x1.7154748bef6c8p-1",
                         "0x1.71547652ab82bp+0")))
# __exp2f_data.tab, .rodata 0xadd40: 2**(i/32) with i/32 << 47 removed
_EXP2F_TAB = (
    0x3ff0000000000000, 0x3fefd9b0d3158574, 0x3fefb5586cf9890f,
    0x3fef9301d0125b51, 0x3fef72b83c7d517b, 0x3fef54873168b9aa,
    0x3fef387a6e756238, 0x3fef1e9df51fdee1, 0x3fef06fe0a31b715,
    0x3feef1a7373aa9cb, 0x3feedea64c123422, 0x3feece086061892d,
    0x3feebfdad5362a27, 0x3feeb42b569d4f82, 0x3feeab07dd485429,
    0x3feea47eb03a5585, 0x3feea09e667f3bcd, 0x3fee9f75e8ec5f74,
    0x3feea11473eb0187, 0x3feea589994cce13, 0x3feeace5422aa0db,
    0x3feeb737b0cdc5e5, 0x3feec49182a3f090, 0x3feed503b23e255d,
    0x3feee89f995ad3ad, 0x3feeff76f2fb5e47, 0x3fef199bdd85529c,
    0x3fef3720dcef9069, 0x3fef5818dcfba487, 0x3fef7c97337b9b5f,
    0x3fefa4afa2a490da, 0x3fefd0765b6e4540)
# __exp2f_data.shift_scaled and .poly, .rodata 0xade40-0xade58
_EXP2F_SHIFT = _h("0x1.8p+47")
_EXP2F_C = tuple(map(_h, ("0x1.c6af84b912394p-5", "0x1.ebfce50fac4f3p-3",
                          "0x1.62e42ff0c52d6p-1")))
_OFF = 0x3F330000
_TOP = 0xFF800000


def _tables(device):
    invc = torch.tensor([_h(a) for a, _ in _POWF_TAB], dtype=F64,
                        device=device)
    logc = torch.tensor([_h(b) for _, b in _POWF_TAB], dtype=F64,
                        device=device)
    t = torch.tensor(_EXP2F_TAB, dtype=I64, device=device)
    return invc, logc, t


def pow_f32(x: torch.Tensor, y) -> torch.Tensor:
    """``powf(x, y)`` of glibc 2.36's FMA build on f32 tensors (``y`` may be
    a Python float that is an f32 value), broadcast together, for a
    positive normal ``x``, a finite non-zero ``y`` and ``|y log2 x| < 126``
    (every ``pow`` the generator takes).  Elsewhere (zero, negative,
    subnormal or non-finite ``x``, ``y`` zero or non-finite, results that
    overflow or underflow) it is the float64 ``pow`` rounded once to f32:
    IEEE's special values, not glibc's routine."""
    x, y = torch.broadcast_tensors(
        x, y if isinstance(y, torch.Tensor)
        else torch.tensor(y, dtype=F32, device=x.device))
    invc, logc, tab = _tables(x.device)
    ix = x.view(I32).to(I64) & 0xFFFFFFFF

    # log2_inline
    tmp = (ix - _OFF) & 0xFFFFFFFF
    i = (tmp >> 19) & 15
    top = tmp & _TOP
    iz = (ix - top) & 0xFFFFFFFF
    k = ((top ^ 0x80000000) - 0x80000000) >> 23         # arithmetic shift
    z = _bits_to_f32(torch.where(iz >= 2 ** 31, iz - 2 ** 32, iz)).double()
    r = z * invc[i] - 1.0
    y0 = logc[i] + k.double()
    a0, a1, a2, a3, a4 = _POWF_A
    yy = a0 * r + a1
    p = a2 * r + a3
    r2 = r * r
    q = a4 * r + y0
    r4 = r2 * r2
    q = p * r2 + q
    logx = yy * r4 + q
    ylogx = y.double() * logx

    # exp2_inline
    kd = ylogx + _EXP2F_SHIFT
    ki = kd.view(I64)
    kd = kd - _EXP2F_SHIFT
    r = ylogx - kd
    t = (tab[ki & 31] + (ki << 47)).view(F64)
    c0, c1, c2 = _EXP2F_C
    zz = c0 * r + c1
    r2 = r * r
    s = c2 * r + 1.0
    s = zz * r2 + s
    out = (s * t).float()

    outside = (ix < 0x00800000) | (ix >= 0x7F800000) | (y == 0) \
        | ~torch.isfinite(y) | (torch.abs(ylogx) >= 126.0)
    return torch.where(outside, torch.pow(x.double(), y.double()).float(),
                       out)


# ---------------------------------------------------------------------------
# tanh (XLA's f32 tanh, with the FMA clamp)

_TANH_CLAMP = _f32(0x401FFEC880000000)          # 7.99881172: tanh is 1.0
_TANH_SMALL = _f32(0x3F3A36E2E0000000)          # 0.0004: tanh(x) = x
_TANH_NUM = tuple(map(_f32, (
    0xBCB3E4B800000000, 0x3D4C266FC0000000, 0xBDD7A6FFE0000000,
    0x3E6B800820000000, 0x3EEF286940000000, 0x3F44E1BDA0000000,
    0x3F740B3B80000000)))
_TANH_DEN = tuple(map(_f32, (
    0x3EB41A7B00000000, 0x3F1F12BAC0000000, 0x3F629540A0000000,
    0x3F740B3BA0000000)))


def tanh_f32(x: torch.Tensor) -> torch.Tensor:
    """``jnp.tanh`` of an f32 tensor as XLA's CPU build computes it (its
    elemental emitter's ``EmitFastTanh``, FMA variant): ``x`` clamped to
    +-7.99881172, ``x * num(x^2) / den(x^2)`` with both Horner chains fused
    (degree 6 and 3 in ``x^2``), ``x`` itself below 0.0004 in magnitude and
    ``copysign(1, x)`` from 20 on."""
    xc = torch.where(x < -_TANH_CLAMP, torch.full_like(x, -_TANH_CLAMP), x)
    xc = torch.where(xc > _TANH_CLAMP, torch.full_like(x, _TANH_CLAMP), xc)
    z = xc * xc
    num = fma_f32(z, _TANH_NUM[0], _TANH_NUM[1])
    for c in _TANH_NUM[2:]:
        num = fma_f32(z, num, c)
    den = fma_f32(z, _TANH_DEN[0], _TANH_DEN[1])
    for c in _TANH_DEN[2:]:
        den = fma_f32(z, den, c)
    out = (xc * num) / den
    ax = torch.abs(x)
    out = torch.where(ax < _TANH_SMALL, x, out)
    return torch.where(ax >= 20.0, torch.copysign(torch.ones_like(x), x), out)
