// Single-precision sin/cos with the bits of glibc's sinf/cosf.
//
// The JAX reference runs trig through XLA:CPU, which calls glibc, and one
// ulp in a heading breaks multi-step bit parity. This is glibc's flt-32
// algorithm (s_sinf.c, s_cosf.c, sincosf.h) in double precision, with fused
// multiply-adds (__fma_rn) exactly where glibc's x86-64 FMA build fuses
// them. `trig.py` is the same routine in float64 torch ops; keep the two in
// step. The constants are those in libm's .rodata (__sincosf_table,
// __inv_pio4). `sincosf_glibc` returns both from one reduction.
#pragma once

#include <stdint.h>

namespace mbots {

struct SinCosPoly {
  double c0, c1, c2, c3, c4;  // cosine polynomial
};

__device__ __forceinline__ SinCosPoly cos_poly(bool negate) {
  const double s = negate ? -1.0 : 1.0;
  return {s * 0x1p0, s * -0x1.ffffffd0c621cp-2, s * 0x1.55553e1068f19p-5,
          s * -0x1.6c087e89a359dp-10, s * 0x1.99343027bf8c3p-16};
}

// 4/pi to 192 bits (glibc __inv_pio4).
__constant__ uint32_t kInvPio4[24] = {
    0xa2,       0xa2f9,     0xa2f983,   0xa2f9836e, 0xf9836e4e, 0x836e4e44,
    0x6e4e4415, 0x4e441529, 0x441529fc, 0x1529fc27, 0x29fc2757, 0xfc2757d1,
    0x2757d1f5, 0x57d1f534, 0xd1f534dd, 0xf534ddc0, 0x34ddc0db, 0xddc0db62,
    0xc0db6295, 0xdb629599, 0x6295993c, 0x95993c43, 0x993c4390, 0x3c439041};

// glibc reduce_large: |y| >= 120; returns x with |x| <= pi/4 and the quadrant.
__device__ __forceinline__ double reduce_large(uint32_t xi, int* np) {
  const uint32_t* arr = &kInvPio4[(xi >> 26) & 15];
  const int shift = (xi >> 23) & 7;
  xi = ((xi & 0xffffff) | 0x800000) << shift;
  uint64_t res0 = (uint32_t)(xi * arr[0]);
  const uint64_t res1 = (uint64_t)xi * arr[4];
  const uint64_t res2 = (uint64_t)xi * arr[8];
  res0 = (res2 >> 32) | (res0 << 32);
  res0 += res1;
  const uint64_t n = (res0 + (1ULL << 61)) >> 62;
  res0 -= n << 62;
  *np = (int)n;
  return __dmul_rn(__ll2double_rn((long long)res0), 0x1.921fb54442d18p-62);
}

// glibc cosf(y) and sinf(y) from one range reduction, as glibc's sincosf:
// both take the same n and reduced x; the sine and the cosine polynomial
// (glibc sincosf_poly) are each evaluated once, and an odd quadrant swaps
// them. cosf's own call evaluates the polynomial of quadrant n ^ 1 and
// sinf's that of n with the same operations, so each result has the bits
// of its own call.
__device__ __forceinline__ void sincosf_glibc(float y, float* c, float* s) {
  const uint32_t bits = __float_as_uint(y);
  const uint32_t top = (bits >> 20) & 0x7ff;
  const double x = (double)y;
  int n = 0, q = 0;
  double xr = x;      // |y| < 0.75 (approximately pi/4): no reduction
  if (top >= 0x3f4) {
    if (top < 0x42f) {  // |y| < 120: one multiply-subtract of n * pi/2
      const double r = __dmul_rn(x, 0x1.45f306dc9c883p+23);
      n = (__double2int_rz(r) + 0x800000) >> 24;
      xr = __fma_rn(-(double)n, 0x1.921fb54442d18p+0, x);
      q = n;
    } else {
      xr = reduce_large(bits, &n);
      q = n + (int)(bits >> 31);
    }
  }
  const double sg = ((q & 3) == 1 || (q & 3) == 2) ? -1.0 : 1.0;
  const double xs = __dmul_rn(xr, sg), x2 = __dmul_rn(xr, xr);
  const SinCosPoly p = cos_poly((q & 2) != 0);
  // Sine polynomial: (x + x^3 s1) + x^5 (s2 + x^2 s3).
  const double x3 = __dmul_rn(xs, x2);
  const double s1 = __fma_rn(x2, -0x1.994eb3774cf24p-13, 0x1.1107605230bc4p-7);
  const double x5 = __dmul_rn(x3, x2);
  const double sp = __fma_rn(x3, -0x1.555545995a603p-3, xs);
  const float sin_p = __double2float_rn(__fma_rn(x5, s1, sp));
  // Cosine polynomial: (c0 + x^2 c1 + x^4 c2) + x^6 (c3 + x^2 c4).
  const double x4 = __dmul_rn(x2, x2);
  const double c2 = __fma_rn(x2, p.c4, p.c3);
  const double c1 = __fma_rn(x2, p.c1, p.c0);
  const double x6 = __dmul_rn(x4, x2);
  const double cp = __fma_rn(x4, p.c2, c1);
  const float cos_p = __double2float_rn(__fma_rn(x6, c2, cp));
  const bool odd = (n & 1) != 0;
  *c = odd ? sin_p : cos_p;
  *s = odd ? cos_p : sin_p;
  if (top < 0x398) {  // |y| < 2^-12
    *c = 1.0f;
    *s = y;
  } else if (top >= 0x7f8) {  // inf, nan
    *c = *s = __int_as_float(0x7fc00000);
  }
}

}  // namespace mbots
