// The learner-row gather: every field of the A2C tick's compaction in one
// launch.
//
// Replaces madrona_bots_tpu/ops/row_gather.py::_kernel (compact_fields).
// Plain version: ops/row_gather_cuda.py::compact_fields_reference.
//
// out_f[w, k, c] = bf16(field_f[w, kslot[w, k], c]), or 0 where kslot is -1,
// for up to kMaxFields fields of [W, A, d_f] in u8, i8, i32 or bf16. The
// TPU kernel builds a per-world one-hot and runs one MXU product per field
// (and pads K to 8 rows); on this card it is a direct gather. Integer
// sources convert to f32 and round to nearest even into bf16 (exact for |v|
// <= 256); bf16 sources copy their bits.
//
// Bound: bytes. Each valid output row reads one source row (222 B over the
// seven A2C fields) and every output element is written once: at 8192 x
// 128 with 10 rows per class (K = 40) that is 8192 * 40 * 175 * 2 B = 115 MB
// written and at most 8192 * 40 * 222 B = 73 MB read, ~56 us at 3.35 TB/s.
//
// Design, for wide memory operations:
//  * A block covers `wpb` consecutive worlds (the wrapper picks enough to
//    write ~8 KB) and first turns their K slots into source row numbers in
//    shared memory (w * A + slot, -1 for a zero row).
//  * One thread per (field, output row, 8-column chunk), field-major, so
//    consecutive threads write consecutive chunks of a field's output. A
//    chunk index splits into row and chunk by a shift (the chunks of a row
//    are padded to a power of two), never by a divide.
//  * Each field has a vector width chosen on the host from its width and
//    its pointers' alignment (row_gather_cuda.vector_width): 8 elements (a
//    32-byte u8 / i8 row is four 8-byte loads, each widened in registers to
//    8 bf16 and written as one 16-byte store; a 16-wide bf16 row is two
//    16-byte copies) where the width is a multiple of 8 and the pointers
//    are aligned, else 1 (2-byte stores; the 15-wide scalar field, whose
//    rows are 30 bytes).
// ptxas gives the kernel 32 registers (8 blocks of 256 threads an SM), an
// 8-byte stack frame, 12 bytes of spill stores and 8 of spill loads
// (chip_smoke.py's [build] lines print its report).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxFields = 8;
constexpr int kThreads = 256;
constexpr int kChunk = 8;  // columns per thread item
enum Dtype { kU8 = 0, kI8 = 1, kI32 = 2, kBF16 = 3 };

struct Fields {
  const void* src[kMaxFields];
  uint16_t* dst[kMaxFields];
  int dtype[kMaxFields];
  int width[kMaxFields];
  int vec[kMaxFields];    // elements per memory access: 8 or 1
  int shift[kMaxFields];  // log2 of the row's chunks, rounded up to a power of two
  int n;
};

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Element e of a field's source as bf16 bits.
__device__ __forceinline__ uint16_t load_bf16(const void* src, int dtype, size_t e) {
  switch (dtype) {
    case kU8: return __bfloat16_as_ushort(__float2bfloat16_rn((float)((const uint8_t*)src)[e]));
    case kI8: return __bfloat16_as_ushort(__float2bfloat16_rn((float)((const int8_t*)src)[e]));
    case kI32: return __bfloat16_as_ushort(__float2bfloat16_rn(__int2float_rn(((const int*)src)[e])));
    default: return ((const uint16_t*)src)[e];
  }
}

// Eight consecutive source elements from element e (aligned) as eight bf16.
__device__ __forceinline__ uint4 load8_bf16(const void* src, int dtype, size_t e) {
  if (dtype == kBF16) return *reinterpret_cast<const uint4*>((const uint16_t*)src + e);
  float v[8];
  if (dtype == kI32) {
    const int4 a = reinterpret_cast<const int4*>((const int*)src + e)[0];
    const int4 b = reinterpret_cast<const int4*>((const int*)src + e)[1];
    const int x[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = __int2float_rn(x[i]);
  } else {
    const uint2 raw = *reinterpret_cast<const uint2*>((const uint8_t*)src + e);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uint32_t b = ((i < 4 ? raw.x : raw.y) >> (8 * (i & 3))) & 0xffu;
      v[i] = dtype == kU8 ? (float)b : (float)(int)(int8_t)b;
    }
  }
  return make_uint4(bf16x2(v[0], v[1]), bf16x2(v[2], v[3]), bf16x2(v[4], v[5]),
                    bf16x2(v[6], v[7]));
}

__global__ void __launch_bounds__(kThreads)
row_gather_kernel(const int* __restrict__ kslot, Fields f, int W, int A, int K, int wpb) {
  extern __shared__ int srow[];  // [wpb * K] source row, -1 for a zero row
  const int w0 = blockIdx.x * wpb;
  const int rows = min(wpb, W - w0) * K;
  const size_t r0 = (size_t)w0 * K;  // the block's first output row
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    const int s = kslot[r0 + r];
    srow[r] = s < 0 ? -1 : (w0 + r / K) * A + s;
  }
  __syncthreads();

  // The thread's items are threadIdx.x + m * kThreads over all fields' items.
  int it = threadIdx.x;
  for (int i = 0; i < f.n; ++i) {
    const int d = f.width[i], dt = f.dtype[i], vec = f.vec[i], sh = f.shift[i];
    const int items = rows << sh;
    const void* src = f.src[i];
    for (; it < items; it += kThreads) {
      const int r = it >> sh, col = (it & ((1 << sh) - 1)) * kChunk;
      if (col >= d) continue;
      const int s = srow[r];
      uint16_t* dst = f.dst[i] + (r0 + r) * d + col;
      const size_t e = (size_t)s * d + col;
      if (vec == 8) {
        *reinterpret_cast<uint4*>(dst) = s < 0 ? make_uint4(0u, 0u, 0u, 0u)
                                               : load8_bf16(src, dt, e);
      } else {
        const int ncol = min(kChunk, d - col);
        for (int c = 0; c < ncol; ++c) dst[c] = s < 0 ? (uint16_t)0 : load_bf16(src, dt, e + c);
      }
    }
    it -= items;
  }
}

}  // namespace

extern "C" int mbots_row_gather(const void* kslot, int W, int A, int K, int n,
                                const void* const* src, void* const* dst,
                                const int* dtype, const int* width, const int* vec,
                                int wpb, void* stream) {
  if (n < 1 || n > kMaxFields || wpb < 1) return (int)cudaErrorInvalidValue;
  Fields f{};
  for (int i = 0; i < n; ++i) {
    if ((vec[i] != 8 && vec[i] != 1) || width[i] % vec[i] != 0)
      return (int)cudaErrorInvalidValue;
    f.src[i] = src[i];
    f.dst[i] = (uint16_t*)dst[i];
    f.dtype[i] = dtype[i];
    f.width[i] = width[i];
    f.vec[i] = vec[i];
    int sh = 0;
    while ((1 << sh) * kChunk < width[i]) ++sh;
    f.shift[i] = sh;
  }
  f.n = n;
  row_gather_kernel<<<(W + wpb - 1) / wpb, kThreads, sizeof(int) * wpb * K,
                      (cudaStream_t)stream>>>((const int*)kslot, f, W, A, K, wpb);
  return (int)cudaGetLastError();
}
