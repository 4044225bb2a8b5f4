"""Frozen copy of the port's plain version, kept by the benchmark so that
later changes to `madrona_bots_tpu_torch` cannot move the reference.
Imports nothing of the port; its original docstring follows.

Single-precision sin/cos with the bits of glibc's `sinf`/`cosf`.

Why: XLA:CPU lowers `jnp.sin`/`jnp.cos` to calls into glibc's libm, so the
JAX package's headings, positions and sensor rays carry glibc's rounding.
`torch.sin`/`torch.cos` differ from it by one ulp on a few percent of
inputs, and one ulp in a heading breaks multi-step bit parity. The port
therefore carries ONE trig routine, glibc's flt-32 algorithm (sysdeps
ieee754/flt-32 s_sinf.c, s_cosf.c, sincosf.h), in two copies that follow
the same operation order:

* here, as float64 torch ops (the plain version, any device);
* `csrc/trig.cuh`, as a `__device__` double function the raycast kernel
  includes.

The algorithm: promote to double; |x| < 0.75 evaluates the polynomial
directly; |x| < 120 reduces by one fused multiply-subtract of n * pi/2;
larger |x| reduces with a 4/pi table and 64-bit integer arithmetic. The
polynomials and the reduction are evaluated with fused multiply-adds at
exactly the places where glibc's x86-64 FMA build (the ifunc chosen on any
CPU with FMA) fuses them. torch has no fused multiply-add, so `_fma`
emulates a correctly rounded one from error-free transformations (Dekker's
product, Knuth's two-sum and Boldo-Melquiond round-to-odd); the device copy
calls `__fma_rn`. The constants are those in libm's `.rodata`.
"""

from __future__ import annotations

import torch

from portbench.reference.device import const

f64 = torch.float64
MASK32 = 0xFFFFFFFF

_HPI_INV = float.fromhex("0x1.45f306dc9c883p+23")   # 2/pi * 2^24
_HPI = float.fromhex("0x1.921fb54442d18p+0")        # pi/2
_PI63 = float.fromhex("0x1.921fb54442d18p-62")      # pi/4 * 2^-61
# Cosine polynomial of table 0 (table 1 negates it); sine polynomial (shared).
_C = [1.0,
      float.fromhex("-0x1.ffffffd0c621cp-2"),
      float.fromhex("0x1.55553e1068f19p-5"),
      float.fromhex("-0x1.6c087e89a359dp-10"),
      float.fromhex("0x1.99343027bf8c3p-16")]
_S1 = float.fromhex("-0x1.555545995a603p-3")
_S2 = float.fromhex("0x1.1107605230bc4p-7")
_S3 = float.fromhex("-0x1.994eb3774cf24p-13")
# 4/pi in 192 bits, as glibc's __inv_pio4.
_INV_PIO4 = [
    0xa2, 0xa2f9, 0xa2f983, 0xa2f9836e, 0xf9836e4e, 0x836e4e44,
    0x6e4e4415, 0x4e441529, 0x441529fc, 0x1529fc27, 0x29fc2757, 0xfc2757d1,
    0x2757d1f5, 0x57d1f534, 0xd1f534dd, 0xf534ddc0, 0x34ddc0db, 0xddc0db62,
    0xc0db6295, 0xdb629599, 0x6295993c, 0x95993c43, 0x993c4390, 0x3c439041,
]


# ---------------------------------------------------------------------------
# Correctly rounded fused multiply-add in float64 torch ops
# ---------------------------------------------------------------------------

def _split(a):
    c = a * 134217729.0                     # 2^27 + 1 (Veltkamp)
    hi = c - (c - a)
    return hi, a - hi


def _two_prod(a, b):
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _round_to_odd(s, e):
    """The odd neighbour of s toward s + e when the sum was inexact."""
    bits = s.view(torch.int64)
    step = torch.where((e > 0) == (s > 0), 1, -1)
    fix = (e != 0) & ((bits & 1) == 0)
    return torch.where(fix, bits + step, bits).view(f64)


def _fma(a, b, c):
    """RN(a * b + c) in float64 (Boldo & Melquiond's emulation)."""
    ph, pl = _two_prod(a, b)
    sh, sl = _two_sum(c, ph)
    v = _round_to_odd(*_two_sum(sl, pl))
    return sh + v


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """RN_f32(a * b + c) for float32 tensors: the product is exact in
    float64, and a round-to-odd float64 sum rounds correctly to float32."""
    p = a.to(f64) * b.to(f64)
    return _round_to_odd(*_two_sum(p, c.to(f64))).to(torch.float32)


# ---------------------------------------------------------------------------
# glibc sinf / cosf
# ---------------------------------------------------------------------------

def _reduce_large(bits):
    """glibc reduce_large on the uint32 pattern: returns (x, n), |x| <=
    pi/4. The 64-bit words are kept as (hi, lo) 32-bit halves in int64."""
    table = const(_INV_PIO4, torch.int64, bits.device)
    idx = (bits >> 26) & 15
    m = ((bits & 0xFFFFFF) | 0x800000) << ((bits >> 23) & 7)    # < 2^31
    a0, a4, a8 = table[idx], table[idx + 4], table[idx + 8]
    hi = (m * a0) & MASK32
    lo = (m * a8) >> 32
    res1 = m * a4
    lo = lo + (res1 & MASK32)
    hi = (hi + (res1 >> 32) + (lo >> 32)) & MASK32
    lo = lo & MASK32
    n = ((hi + (1 << 29)) & MASK32) >> 30
    hi = (hi - (n << 30)) & MASK32
    signed = torch.where(hi >= (1 << 31), hi - (1 << 32), hi) * (1 << 32) + lo
    return signed.to(f64) * _PI63, n


def sincos(y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(glibc `cosf`, glibc `sinf`), elementwise, float32, from one range
    reduction: the cosine takes the polynomial of quadrant n ^ 1, the sine
    that of quadrant n (`csrc/trig.cuh::sincosf_glibc`)."""
    y = y.to(torch.float32).contiguous()
    bits = y.view(torch.int32).to(torch.int64) & MASK32
    top = (bits >> 20) & 0x7FF
    small = top < 0x3F4
    fast = top < 0x42F
    x = y.to(f64)

    xf = torch.where(fast, x, 0.0)
    nf = ((xf * _HPI_INV).to(torch.int64) + 0x800000) >> 24
    xr = _fma(-nf.to(f64), torch.full_like(xf, _HPI), xf)
    xl, nl = _reduce_large(bits)

    zero = torch.zeros_like(nf)
    xred = torch.where(small, x, torch.where(fast, xr, xl))
    n = torch.where(small, zero, torch.where(fast, nf, nl))
    q = torch.where(small, zero, torch.where(fast, nf, nl + (bits >> 31)))

    x2 = xred * xred
    xs = xred * torch.where(((q & 3) == 1) | ((q & 3) == 2), -1.0, 1.0)
    # Quadrants 2 and 3 read glibc's second table, the negated cosine
    # polynomial. (torch.where of two Python floats would give float32.)
    neg = (q & 2) != 0
    c = [torch.where(neg, torch.full_like(x2, -ci), torch.full_like(x2, ci))
         for ci in _C]

    # Sine polynomial: (x + x^3 s1) + x^5 (s2 + x^2 s3).
    s1p = _fma(x2, torch.full_like(x2, _S3), torch.full_like(x2, _S2))
    x3 = x2 * xs
    x5 = x2 * x3
    sin_p = _fma(s1p, x5, _fma(x3, torch.full_like(x2, _S1), xs))
    # Cosine polynomial: (c0 + x^2 c1 + x^4 c2) + x^6 (c3 + x^2 c4).
    c2p = _fma(x2, c[4], c[3])
    c1p = _fma(x2, c[1], c[0])
    x4 = x2 * x2
    x6 = x4 * x2
    cos_p = _fma(x6, c2p, _fma(x4, c[2], c1p))

    odd = (n & 1) == 1
    tiny = top < 0x398
    nan = torch.full_like(y, float("nan"))
    cos_y = torch.where(odd, sin_p, cos_p).to(torch.float32)
    sin_y = torch.where(odd, cos_p, sin_p).to(torch.float32)
    cos_y = torch.where(top >= 0x7F8, nan, torch.where(tiny, torch.ones_like(y), cos_y))
    sin_y = torch.where(top >= 0x7F8, nan, torch.where(tiny, y, sin_y))
    return cos_y, sin_y


def sin(x: torch.Tensor) -> torch.Tensor:
    """glibc `sinf`, elementwise, float32."""
    return sincos(x)[1]


def cos(x: torch.Tensor) -> torch.Tensor:
    """glibc `cosf`, elementwise, float32."""
    return sincos(x)[0]
