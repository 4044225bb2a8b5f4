// The raycast sensor kernel: depth, semantic and the crosshair finder.
//
// Replaces madrona_bots_tpu/ops/raycast_pallas.py::_kernel_ladder (and, for
// any W and A <= 1024, the packed and blocked kernels of the same file).
// Plain version: env/raycast.py::raycast.
//
// Bound (chip_smoke.py::raycast_bound counts it from the inputs). A world
// with n alive agents has n (n - 1) source-target pairs; each takes its
// offset and q = r^2 - |oc|^2 once (6 ops), and each of its 33 ray tests
// (32 sensor rays and the finder) tc and disc (5 ops); only a test that
// passes the exact cull below takes the sqrt and th (2 ops). On the stepped
// 8192 x 128 state of chip_smoke.py (~33 alive a world, 1% of 293 M tests
// pass the cull) that is 1.52 GFLOP, 23 us at the H100's published 67
// TFLOP/s, under the bytes (inputs read once, outputs of 68 B a slot
// written once: 89 MB, 27 us at 3.35 TB/s). With every slot alive it is
// 22.9 GFLOP, 341 us. That published rate counts an FFMA as two operations;
// this file is built with -fmad=false and every product and sum is its own
// __f*_rn instruction (bit parity with XLA:CPU), so each operation issues
// at the FFMA instruction rate and the operations' reachable floor is twice
// their published-peak time: 45 us stepped, 682 us saturated.
//
// Design, per world (one block of kWarps warps):
//  * The block compacts the alive slots, ascending, into shared memory
//    (warp ballots, block_rank): position, heading, (slot << 8 | species
//    byte), and the finder's direction from the heading. Dead slots' rows
//    (depth 0, semantic -1) are written by the whole block in 16-byte words
//    (4-byte words when S % 16 != 0), their finder -1.
//  * One warp per alive source j. Its lanes fill the warp's pair table in
//    shared memory with one 16-byte entry per compacted target k: (ocx, ocy,
//    q = r^2 - |oc|^2, tag), with q = -3e38 at k == j as in the plain
//    version, so the self test leaves the inner loop. The pair's 6 ops run
//    once per pair instead of once per ray.
//  * Lane r takes ray r (striding over S when S > 32), its direction from
//    one glibc reduction that returns cos and sin (trig.cuh). The inner
//    loop over k ascending is one broadcast shared load, tc = d . oc and
//    disc = tc^2 + q; the sqrt and th = tc - sqrt(disc) run only when disc
//    >= 0 and tc > near. That cull is exact: sqrt(disc) >= 0 and rounding is
//    monotone, so th <= tc, and th > near implies tc > near. A strict `<`
//    running minimum over ascending k keeps ties on the lower slot.
//    Some lane of a warp passes the cull for most targets, so a branch per
//    target would run the sqrt path nearly always: instead, per 32 targets,
//    a branch-free pass (unrolled by 8) sets a bit for each target with
//    disc >= 0, and the cull, the sqrt and the update then run for the set
//    bits only, in ascending order, which is the same fold.
//  * The finder ray: lane l folds the targets k = l (mod 32) with the same
//    test, then two warp min-reductions take the smallest (t, tag) pair
//    (tags ascend with the slot), which is the plain version's sequential
//    fold (ties to the lower slot).
//  * A source's S depth bytes and S semantic bytes are one warp store each.
// Arithmetic is plain IEEE f32, op for op as in the plain version:
// __fmul_rn / __fadd_rn / __fdiv_rn / __fsqrt_rn under -fmad=false, and sin
// and cos with glibc's bits.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "scan.cuh"
#include "trig.cuh"

namespace {

constexpr float kInf = 3.0e38f;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 8;       // targets per step of the branch-free pass; divides 32
constexpr int kNoHit = INT_MAX;  // tag of "no target hit"; above every real tag

struct Params {
  int A, S;
  float lim_x, lim_y, r2, near, scale;
};

// Distance along d from p to the wall at 0 or lim (kInf when d == 0).
__device__ __forceinline__ float wall_axis(float p, float d, float lim) {
  if (d == 0.f) return kInf;
  return fminf(__fdiv_rn(d > 0.f ? __fsub_rn(lim, p) : -p, d), kInf);
}

// The ray-circle test against table entry e = (ocx, ocy, q, tag): tc and
// disc, and whether the target passes the cull (disc >= 0 and tc > near).
__device__ __forceinline__ bool cull(const float4& e, float dx, float dy, float near,
                                     float& tc, float& disc) {
  tc = __fadd_rn(__fmul_rn(dx, e.x), __fmul_rn(dy, e.y));
  disc = __fadd_rn(__fmul_rn(tc, tc), e.z);
  return disc >= 0.f && tc > near;
}

// One target of the running minimum (strict `<`, so ties keep the earlier target).
__device__ __forceinline__ void hit_test(const float4& e, float dx, float dy, float near,
                                         float& tmin, int& tag) {
  float tc, disc;
  if (cull(e, dx, dy, near, tc, disc)) {
    const float th = __fsub_rn(tc, __fsqrt_rn(disc));
    if (th > near && th < tmin) {
      tmin = th;
      tag = __float_as_int(e.w);
    }
  }
}

// The running minimum over table entries [0, n8) for direction (dx, dy).
// Per 32 targets, a branch-free pass (unrolled by kUnroll) sets a bit for
// each target with disc >= 0, a superset of those that pass the cull; then
// only those take the full test and, if they pass, the sqrt, in ascending
// order, so the fold is the sequential one. Entries [n, n8) are padding
// with disc < 0.
__device__ __forceinline__ void nearest(const float4* tab, int n8, float dx, float dy,
                                        float near, float& tmin, int& tag) {
  for (int k0 = 0; k0 < n8; k0 += 32) {
    const int kend = min(n8, k0 + 32);
    uint32_t mask = 0;
    for (int k = k0; k < kend; k += kUnroll) {
      const uint32_t bit = 1u << (k - k0);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float tc, disc;
        cull(tab[k + u], dx, dy, near, tc, disc);
        if (disc >= 0.f) mask |= bit << u;
      }
    }
    while (mask) {
      const int k = k0 + __ffs(mask) - 1;
      mask &= mask - 1;
      hit_test(tab[k], dx, dy, near, tmin, tag);
    }
  }
}

// A float's bits as an unsigned key that orders like the float (-0 as +0).
__device__ __forceinline__ uint32_t order_key(float t) {
  const uint32_t b = __float_as_uint(__fadd_rn(t, 0.f));
  return b ^ ((uint32_t)((int32_t)b >> 31) | 0x80000000u);
}

__global__ void __launch_bounds__(kThreads)
raycast_kernel(const float* __restrict__ pos, const float* __restrict__ heading,
               const uint8_t* __restrict__ alive, const int* __restrict__ species,
               const float* __restrict__ offsets, uint8_t* __restrict__ depth,
               int8_t* __restrict__ semantic, int* __restrict__ finder, Params p) {
  const int A = p.A, S = p.S, A8 = (A + kUnroll - 1) / kUnroll * kUnroll;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t base = (size_t)blockIdx.x * A;

  extern __shared__ float4 smem[];
  float4* src = smem;                                   // [A] x, y, heading, tag
  float4* table = src + A;                              // [kWarps][A8] pair tables
  float2* fdir = (float2*)(table + kWarps * A8);        // [A] finder cos, sin
  float* offs = (float*)(fdir + A);                     // [S]
  uint8_t* dead = (uint8_t*)(offs + S);                 // [A]
  __shared__ int wcount[kWarps];

  int n = 0;
  for (int a0 = 0; a0 < A; a0 += kThreads) {
    const int a = a0 + tid;
    const bool al = a < A && alive[base + a] != 0;
    int total;
    const int rank = mbots::block_rank(al, wcount, &total);
    if (a < A) {
      dead[a] = !al;
      if (!al) finder[base + a] = -1;
    }
    if (al) {
      const float2 xy = reinterpret_cast<const float2*>(pos)[base + a];
      const float hd = heading[base + a];
      src[n + rank] = make_float4(xy.x, xy.y, hd,
                                  __int_as_float((a << 8) | (species[base + a] & 0xff)));
      float c, s;
      mbots::sincosf_glibc(hd, &c, &s);
      fdir[n + rank] = make_float2(c, s);
    }
    n += total;
  }
  for (int i = tid; i < S; i += kThreads) offs[i] = offsets[i];
  __syncthreads();

  if (S % 16 == 0) {
    const int per_row = S / 16;
    uint4* d4 = reinterpret_cast<uint4*>(depth + base * S);
    uint4* s4 = reinterpret_cast<uint4*>(semantic + base * S);
    for (int i = tid; i < A * per_row; i += kThreads) {
      if (dead[i / per_row]) {
        d4[i] = make_uint4(0u, 0u, 0u, 0u);
        s4[i] = make_uint4(~0u, ~0u, ~0u, ~0u);
      }
    }
  } else {
    const int per_row = S / 4;
    uint32_t* d1 = reinterpret_cast<uint32_t*>(depth + base * S);
    uint32_t* s1 = reinterpret_cast<uint32_t*>(semantic + base * S);
    for (int i = tid; i < A * per_row; i += kThreads) {
      if (dead[i / per_row]) {
        d1[i] = 0u;
        s1[i] = ~0u;
      }
    }
  }

  float4* tab = table + warp * A8;
  const int n8 = (n + kUnroll - 1) / kUnroll * kUnroll;
  for (int j = warp; j < n; j += kWarps) {
    const float4 me = src[j];
    for (int k = lane; k < n8; k += 32) {
      if (k < n) {
        const float4 t = src[k];
        const float ocx = __fsub_rn(t.x, me.x), ocy = __fsub_rn(t.y, me.y);
        const float oc2 = __fadd_rn(__fmul_rn(ocx, ocx), __fmul_rn(ocy, ocy));
        tab[k] = make_float4(ocx, ocy, k == j ? -kInf : __fsub_rn(p.r2, oc2), t.w);
      } else {
        tab[k] = make_float4(0.f, 0.f, -kInf, __int_as_float(kNoHit));  // disc < 0
      }
    }
    __syncwarp();

    const size_t row = (base + (__float_as_int(me.w) >> 8)) * S;
    for (int r = lane; r < S; r += 32) {
      float dx, dy;
      mbots::sincosf_glibc(__fadd_rn(me.z, offs[r]), &dx, &dy);
      float tmin = kInf;
      int tag = kNoHit;
      nearest(tab, n8, dx, dy, p.near, tmin, tag);

      float tw = fminf(wall_axis(me.x, dx, p.lim_x), wall_axis(me.y, dy, p.lim_y));
      tw = tw > p.near ? tw : kInf;
      const float t = fminf(tmin, tw);
      const bool any_hit = t < kInf;
      const int db = 255 - (int)fminf(floorf(__fmul_rn(t, p.scale)), 255.f);
      depth[row + r] = any_hit ? (uint8_t)db : 0;
      semantic[row + r] = any_hit ? (int8_t)(tmin < tw ? (tag & 0xff) : 0) : -1;
    }

    const float2 fd = fdir[j];
    float tmin = kInf;
    int tag = kNoHit;
    for (int k = lane; k < n; k += 32) hit_test(tab[k], fd.x, fd.y, p.near, tmin, tag);
    // The smallest (t, tag) over the lanes: tags ascend with the slot.
    const uint32_t key = order_key(tmin);
    const uint32_t best = __reduce_min_sync(0xffffffffu, key);
    const uint32_t best_tag = __reduce_min_sync(0xffffffffu, key == best ? (uint32_t)tag : ~0u);
    if (lane == 0) {
      finder[base + (__float_as_int(me.w) >> 8)] =
          best_tag == (uint32_t)kNoHit ? -1 : (int)(best_tag >> 8);
    }
    __syncwarp();  // the table is refilled for the next source
  }
}

}  // namespace

extern "C" int mbots_raycast(const void* pos, const void* heading, const void* alive,
                             const void* species, const void* offsets, void* depth,
                             void* semantic, void* finder, int W, int A, int S,
                             float lim_x, float lim_y, float r2, float near,
                             float scale, void* stream) {
  const Params p{A, S, lim_x, lim_y, r2, near, scale};
  const size_t A8 = (size_t)(A + kUnroll - 1) / kUnroll * kUnroll;
  const size_t smem = sizeof(float4) * (A + kWarps * A8) + (sizeof(float2) + 1) * (size_t)A +
                      sizeof(float) * (size_t)S;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        raycast_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  raycast_kernel<<<W, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)pos, (const float*)heading, (const uint8_t*)alive,
      (const int*)species, (const float*)offsets, (uint8_t*)depth,
      (int8_t*)semantic, (int*)finder, p);
  return (int)cudaGetLastError();
}
