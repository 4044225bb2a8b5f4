// The learner-row gather: every field of the A2C tick's compaction in one
// launch.
//
// Replaces madrona_bots_tpu/ops/row_gather.py::_kernel (compact_fields).
// Plain version: ops/row_gather_cuda.py::compact_fields_reference.
//
// out_f[w, k, c] = bf16(field_f[w, kslot[w, k], c]), or 0 where kslot is -1,
// for up to kMaxFields fields of [W, A, d_f] in u8, i8, i32 or bf16. The
// TPU kernel builds a per-world one-hot and runs one MXU product per field
// (and pads K to 8 rows); on this card it is a direct gather.
//
// Design: one block per world. The block loads the world's K slots into
// shared memory, then its threads walk the (row, column) pairs of each
// field in turn, so consecutive threads write consecutive output elements.
// Field descriptors (source, destination, dtype, width) travel in the
// kernel's parameters. Integer sources convert to f32 and round to nearest
// even into bf16 (exact for |v| <= 256); bf16 sources copy their bits.
//
// Bound: bytes. Each valid output row reads one source row (222 B over the
// seven A2C fields) and every output element is written once: at 8192 x
// 128 with 10 rows per class (K = 40) that is 8192 * 40 * 175 * 2 B = 115 MB
// written and at most 8192 * 40 * 222 B = 73 MB read, ~56 us at 3.35 TB/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxFields = 8;
enum Dtype { kU8 = 0, kI8 = 1, kI32 = 2, kBF16 = 3 };

struct Fields {
  const void* src[kMaxFields];
  uint16_t* dst[kMaxFields];
  int dtype[kMaxFields];
  int width[kMaxFields];
  int n;
};

__device__ __forceinline__ uint16_t to_bf16(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

__global__ void row_gather_kernel(const int* __restrict__ kslot, Fields f,
                                  int A, int K) {
  extern __shared__ int ks[];  // [K]
  const int w = blockIdx.x;
  for (int k = threadIdx.x; k < K; k += blockDim.x) ks[k] = kslot[(size_t)w * K + k];
  __syncthreads();

  for (int i = 0; i < f.n; ++i) {
    const int d = f.width[i], dt = f.dtype[i];
    const size_t src_world = (size_t)w * A * d;
    uint16_t* dst = f.dst[i] + (size_t)w * K * d;
    for (int e = threadIdx.x; e < K * d; e += blockDim.x) {
      const int k = e / d, c = e - k * d;
      const int s = ks[k];
      uint16_t v = 0;
      if (s >= 0) {
        const size_t at = src_world + (size_t)s * d + c;
        switch (dt) {
          case kU8: v = to_bf16((float)((const uint8_t*)f.src[i])[at]); break;
          case kI8: v = to_bf16((float)((const int8_t*)f.src[i])[at]); break;
          case kI32: v = to_bf16(__int2float_rn(((const int*)f.src[i])[at])); break;
          default: v = ((const uint16_t*)f.src[i])[at]; break;
        }
      }
      dst[e] = v;
    }
  }
}

}  // namespace

extern "C" int mbots_row_gather(const void* kslot, int W, int A, int K, int n,
                                const void* const* src, void* const* dst,
                                const int* dtype, const int* width, void* stream) {
  if (n < 1 || n > kMaxFields) return (int)cudaErrorInvalidValue;
  Fields f{};
  for (int i = 0; i < n; ++i) {
    f.src[i] = src[i];
    f.dst[i] = (uint16_t*)dst[i];
    f.dtype[i] = dtype[i];
    f.width[i] = width[i];
  }
  f.n = n;
  row_gather_kernel<<<W, 256, sizeof(int) * K, (cudaStream_t)stream>>>(
      (const int*)kslot, f, A, K);
  return (int)cudaGetLastError();
}
