// The raycast sensor kernel: depth, semantic and the crosshair finder.
//
// Replaces madrona_bots_tpu/ops/raycast_pallas.py::_kernel_ladder (and, for
// any W and A <= 1024, the packed and blocked kernels of the same file).
// Plain version: env/raycast.py::raycast.
//
// Design: one thread block per world. A block scan compacts the alive
// slots, in ascending order, into shared memory (x, y, species, slot); they
// are both the sources and the targets. Threads stride over the
// (alive source, ray) pairs, 32 sensor rays plus the finder ray, and each
// runs a strict `<` running minimum over the compacted targets, so ties go
// to the lower slot. Dead sources get empty outputs. Outputs are written
// in the public [W, A, S] layout. The TPU kernel's rank compaction to A/2
// lanes, pair/triple/quad world tiles, bf16 payload split and expansion
// epilogue are TPU layout devices and are gone.
//
// Arithmetic is plain IEEE f32, op for op as in the plain version: built
// with -fmad=false and written with __fmul_rn / __fadd_rn / __fdiv_rn /
// __fsqrt_rn; sin and cos come from trig.cuh (glibc's bits).
//
// Bound: FP32 operations. A world with n alive agents runs n * (n - 1)
// source-target pairs of 6 FP32 ops (the offset and its squared length)
// and 33 ray-circle tests of 8 ops on each pair (about 2.4 GFLOP at W =
// 8192 and n ~ 33, ~36 us at the H100's 67 TFLOP/s). The outputs are 68 B
// per slot (~71 MB, ~21 us at 3.35 TB/s). This kernel recomputes the
// pair's 6 ops for every ray.

#include <cuda_runtime.h>
#include <stdint.h>

#include "scan.cuh"
#include "trig.cuh"

namespace {

constexpr float kInf = 3.0e38f;

struct Params {
  int A, S;
  float lim_x, lim_y, r2, near, scale;
};

__device__ __forceinline__ float wall_axis(float p, float d, float lim) {
  const float hi = d > 0.f ? __fdiv_rn(__fsub_rn(lim, p), d) : kInf;
  const float lo = d < 0.f ? __fdiv_rn(-p, d) : kInf;
  return fminf(hi, lo);
}

__global__ void raycast_kernel(const float* __restrict__ pos,
                               const float* __restrict__ heading,
                               const uint8_t* __restrict__ alive,
                               const int* __restrict__ species,
                               const float* __restrict__ offsets,
                               uint8_t* __restrict__ depth,
                               int8_t* __restrict__ semantic,
                               int* __restrict__ finder, Params p) {
  const int A = p.A, S = p.S, R = S + 1;
  const int w = blockIdx.x, a = threadIdx.x, nt = blockDim.x;
  const bool valid = a < A;
  const size_t base = (size_t)w * A;

  extern __shared__ int smem[];
  float* tx = (float*)smem;       // [A] compacted alive x, ascending slot
  float* ty = tx + A;             // [A]
  int* tsp = (int*)(ty + A);      // [A] species
  int* tslot = tsp + A;           // [A] slot
  int* scan = tslot + A;          // [A]
  float* offs = (float*)(scan + A);  // [S]

  const bool al = valid && alive[base + a] != 0;
  const int incl = mbots::strided_scan(al, scan, a, valid, A, 1);
  if (al) {
    tx[incl - 1] = pos[(base + a) * 2];
    ty[incl - 1] = pos[(base + a) * 2 + 1];
    tsp[incl - 1] = species[base + a];
    tslot[incl - 1] = a;
  }
  for (int i = a; i < S; i += nt) offs[i] = offsets[i];
  __syncthreads();
  const int n = scan[A - 1];

  for (int i = a; i < A * S; i += nt) {
    if (alive[base + i / S] == 0) {
      depth[base * S + i] = 0;
      semantic[base * S + i] = -1;
    }
  }
  if (valid && !al) finder[base + a] = -1;

  for (int i = a; i < n * R; i += nt) {
    const int j = i / R, ray = i % R;
    const float sx = tx[j], sy = ty[j];
    const float hd = heading[base + tslot[j]];
    const float ang = ray < S ? __fadd_rn(hd, offs[ray]) : hd;
    const float dx = mbots::cosf_glibc(ang), dy = mbots::sinf_glibc(ang);

    float tmin = kInf;
    int arg = -1;
    for (int k = 0; k < n; ++k) {
      if (k == j) continue;
      const float ocx = __fsub_rn(tx[k], sx), ocy = __fsub_rn(ty[k], sy);
      const float oc2 = __fadd_rn(__fmul_rn(ocx, ocx), __fmul_rn(ocy, ocy));
      const float q = __fsub_rn(p.r2, oc2);
      const float tc = __fadd_rn(__fmul_rn(dx, ocx), __fmul_rn(dy, ocy));
      const float disc = __fadd_rn(__fmul_rn(tc, tc), q);
      const float th = __fsub_rn(tc, __fsqrt_rn(fmaxf(disc, 0.f)));
      if (disc >= 0.f && th > p.near && th < tmin) {
        tmin = th;
        arg = k;
      }
    }

    const size_t src = base + tslot[j];
    if (ray == S) {
      finder[src] = tmin < kInf ? tslot[arg] : -1;
      continue;
    }
    float tw = fminf(wall_axis(sx, dx, p.lim_x), wall_axis(sy, dy, p.lim_y));
    tw = tw > p.near ? tw : kInf;
    const float t = fminf(tmin, tw);
    const bool any_hit = t < kInf;
    const int db = 255 - (int)fminf(floorf(__fmul_rn(t, p.scale)), 255.f);
    depth[src * S + ray] = any_hit ? (uint8_t)db : 0;
    semantic[src * S + ray] = any_hit ? (int8_t)(tmin < tw ? tsp[arg] : 0) : -1;
  }
}

}  // namespace

extern "C" int mbots_raycast(const void* pos, const void* heading, const void* alive,
                             const void* species, const void* offsets, void* depth,
                             void* semantic, void* finder, int W, int A, int S,
                             float lim_x, float lim_y, float r2, float near,
                             float scale, void* stream) {
  const Params p{A, S, lim_x, lim_y, r2, near, scale};
  const int threads = A > 128 ? (A + 31) / 32 * 32 : 128;
  const size_t smem = sizeof(int) * (5 * A + S);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        raycast_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  raycast_kernel<<<W, threads, smem, (cudaStream_t)stream>>>(
      (const float*)pos, (const float*)heading, (const uint8_t*)alive,
      (const int*)species, (const float*)offsets, (uint8_t*)depth,
      (int8_t*)semantic, (int*)finder, p);
  return (int)cudaGetLastError();
}
