// The SimManager's export rows: all the export fills of a step, or the
// write-back of its buffers, in one launch.
//
// Replaces no TPU kernel: the JAX package moves these rows on the host, in
// its C++ library (native/mbots_host.cpp through
// madrona_bots_tpu/utils/native.py). On the card they were one torch
// index_select per export and a zero fill plus an index_put per write-back.
// Plain versions: ops/export_rows_cuda.py::gather_reference and
// scatter_reference.
//
// Two directions over one flat int64 order of row numbers:
//  * gather:  dst_f[r] = src_f[order[r]] for r < rows (the export
//    permutation, n rows);
//  * scatter: dst_f[order[i]] = src_f[i] for i < valid and a zero row for
//    valid <= i < rows. The order is then the whole stable sort of
//    utils/native.compaction_order, alive rows first and the dead slots
//    last, a permutation of dst's rows: every row is written exactly once.
// Up to kMaxFields fields, each in its own dtype: a byte copy, or int32 ->
// float32 rounded to nearest (__int2float_rn, the bits of torch's
// .to(torch.float32)).
//
// Bound: bytes. Each field row is read once and written once, and each
// order entry read once a launch. At 2048 x 128 with every slot alive (n =
// 262,144) a call of the SimManager loop makes five launches: two refreshes
// of action and hidden (88 B a row), the seven current-tick exports (104 B a
// row, health read as i32, written as f32) and two write-backs (88 B a row
// over all W * A slots): 2 * 2 * 88 + 2 * 104 + 2 * 2 * 88 = 912 B a row
// plus 5 * 8 B of order, ~250 MB, 75 us at 3.35 TB/s.
//
// Design, for wide memory operations and a full card:
//  * Each field has an access width (16, 8, 4, 2 or 1 bytes) chosen on the
//    host from its row bytes and both pointers (export_rows_cuda.
//    access_bytes): 16-byte loads and stores wherever the rows allow.
//  * Items are (field, row, chunk), field-major and chunk fastest, so
//    neighbouring threads write neighbouring bytes of a gathered field and
//    read neighbouring bytes of a scattered one.
//  * A block takes kItems * kThreads items of one field, found from the
//    block index (uniform across the block). The blocks cover every field's
//    items, so the grid follows n and the fields (thousands of blocks at the
//    bench shape), one thread a chunk, never one block a row.
//  * Each thread reads the order entries of its kItems items itself, then
//    issues all their loads, then all their stores, so a thread's loads are
//    in flight together. The fields of a call fit in the 50 MB L2, so the
//    gather's reads, ascending within a species, cost little more than
//    their bytes.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kMaxFields = 16;
constexpr int kThreads = 256;
constexpr int kItems = 4;                        // items a thread
constexpr int kBlockItems = kThreads * kItems;   // items a block
// A field's record from the host: src, dst, row bytes, access bytes, convert.
constexpr int kRecord = 5;

struct Field {
  const char* src;
  char* dst;
  int row_bytes;  // bytes of a row, the same in src and dst
  int vec;        // bytes a memory access: 16, 8, 4, 2 or 1
  int chunks;     // row_bytes / vec
  int convert;    // 1: int32 -> float32, rounded to nearest
  int block0;     // the field's first block
};

struct Fields {
  Field f[kMaxFields];
  int n;
};

__device__ __forceinline__ uint4 load_bytes(const char* p, int vec) {
  switch (vec) {
    case 16: return __ldg(reinterpret_cast<const uint4*>(p));
    case 8: {
      const uint2 a = __ldg(reinterpret_cast<const uint2*>(p));
      return make_uint4(a.x, a.y, 0u, 0u);
    }
    case 4: return make_uint4(__ldg(reinterpret_cast<const unsigned int*>(p)), 0u, 0u, 0u);
    case 2: return make_uint4(__ldg(reinterpret_cast<const unsigned short*>(p)), 0u, 0u, 0u);
    default: return make_uint4(__ldg(reinterpret_cast<const unsigned char*>(p)), 0u, 0u, 0u);
  }
}

__device__ __forceinline__ void store_bytes(char* p, uint4 v, int vec) {
  switch (vec) {
    case 16: *reinterpret_cast<uint4*>(p) = v; break;
    case 8: *reinterpret_cast<uint2*>(p) = make_uint2(v.x, v.y); break;
    case 4: *reinterpret_cast<unsigned int*>(p) = v.x; break;
    case 2: *reinterpret_cast<unsigned short*>(p) = (unsigned short)v.x; break;
    default: *reinterpret_cast<unsigned char*>(p) = (unsigned char)v.x;
  }
}

__device__ __forceinline__ unsigned int int_to_float_bits(unsigned int x) {
  return __float_as_uint(__int2float_rn((int)x));
}

template <bool kScatter>
__global__ void __launch_bounds__(kThreads)
export_rows_kernel(const long long* __restrict__ order, int rows, int valid, Fields fs) {
  int i = 0;
  while (i + 1 < fs.n && fs.f[i + 1].block0 <= (int)blockIdx.x) ++i;
  const char* src = fs.f[i].src;
  char* dst = fs.f[i].dst;
  const long long rb = fs.f[i].row_bytes;
  const int vec = fs.f[i].vec, chunks = fs.f[i].chunks;
  const int items = rows * chunks;
  const int it0 = ((int)blockIdx.x - fs.f[i].block0) * kBlockItems + (int)threadIdx.x;

  int r[kItems], col[kItems];
  long long s[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int it = it0 + k * kThreads;
    r[k] = it < items ? it / chunks : -1;
    col[k] = (it - r[k] * chunks) * vec;
    s[k] = r[k] >= 0 ? order[r[k]] : 0;
  }
  uint4 v[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    v[k] = make_uint4(0u, 0u, 0u, 0u);
    if (r[k] < 0) continue;
    if (!kScatter) {
      v[k] = load_bytes(src + s[k] * rb + col[k], vec);
    } else if (r[k] < valid) {
      v[k] = load_bytes(src + r[k] * rb + col[k], vec);
    }
  }
  const bool convert = fs.f[i].convert != 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (r[k] < 0) continue;
    uint4 w = v[k];
    if (convert) {
      w = make_uint4(int_to_float_bits(w.x), int_to_float_bits(w.y), int_to_float_bits(w.z),
                     int_to_float_bits(w.w));
    }
    store_bytes(dst + (kScatter ? s[k] : (long long)r[k]) * rb + col[k], w, vec);
  }
}

}  // namespace

// fields: n records of kRecord int64 each (source pointer, destination
// pointer, row bytes, access bytes, convert). rows: entries of the order;
// valid: the scatter's source rows (the gather takes rows).
extern "C" int mbots_export_rows(const void* order, int rows, int valid, int scatter, int n,
                                 const long long* fields, void* stream) {
  if (n < 1 || n > kMaxFields || rows < 0 || valid < 0 || valid > rows)
    return (int)cudaErrorInvalidValue;
  Fields fs{};
  long long blocks = 0;
  for (int i = 0; i < n; ++i) {
    const long long* a = fields + kRecord * i;
    const long long rb = a[2], vec = a[3];
    if (rb < 1 || rb > INT_MAX || (vec != 1 && vec != 2 && vec != 4 && vec != 8 && vec != 16) ||
        rb % vec != 0 || (a[4] != 0 && (vec < 4 || a[4] != 1)))
      return (int)cudaErrorInvalidValue;
    const long long items = (long long)rows * (rb / vec);
    if (items > INT_MAX - kBlockItems) return (int)cudaErrorInvalidValue;
    fs.f[i] = Field{(const char*)a[0], (char*)a[1], (int)rb, (int)vec, (int)(rb / vec),
                    (int)a[4], (int)blocks};
    blocks += (items + kBlockItems - 1) / kBlockItems;
    if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  }
  fs.n = n;
  if (blocks == 0) return (int)cudaSuccess;
  if (scatter) {
    export_rows_kernel<true><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const long long*)order, rows, valid, fs);
  } else {
    export_rows_kernel<false><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const long long*)order, rows, valid, fs);
  }
  return (int)cudaGetLastError();
}
