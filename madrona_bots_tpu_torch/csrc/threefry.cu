// jax's threefry2x32 counter RNG in uint32 registers, one launch a call of
// rng.py: its key derivations (threefry2x32, fold_in, split), its random
// words (random_bits, and so uniform, gumbel and randint) and its
// categorical draw with the Gumbel transform and the argmax fused in.
//
// Replaces no TPU kernel: the JAX package draws these bits with
// jax.random, which XLA compiles into its own loops; no Pallas kernel
// computes them. The plain versions (rng.py's *_reference functions) run
// the same 20 rounds as int64 torch ops masked to 32 bits, ~175-186
// launches a call on the card.
//
// The bits are jax 0.9.0's with jax_threefry_partitionable=True:
//  * hash:  (y0, y1) = threefry2x32(k, (x0, x1)); fold_in(k, d) =
//    hash(k, 0, d); split(k, n)[i] = fold_in(k, i);
//  * words: word i of key k is y0 ^ y1 of hash(k, 0, offset + i);
//  * gumbel: u = bitcast((word >> 9) | 0x3F800000) - 1, then
//    -logf(-logf(max(u + tiny, tiny))), each f32 operation rounded on its
//    own (the build's -fmad=false), the operations torch runs in
//    rng.gumbel;
//  * categorical: the first index of the largest noise + logit of a row,
//    where a NaN is the largest and the first NaN wins, as torch.argmax.
//
// Bound: integer throughput. A hash is 72 32-bit integer operations (20
// rounds of an add, a funnel-shift rotate and a xor; 5 key injections of
// two adds; the two first adds), and a draw adds 3 (xor, shift, or) and two
// logf. At the A2C cell's shape, four draws a tick of 65,536 rows x 6
// actions, that is 118 M integer operations, 7.1 us at 64 a clock on each
// of 132 SMs at 1.98 GHz, against 8.4 MB of logits read and actions
// written, 2.5 us at 3.35 TB/s. A key derivation is a few hashes: the
// launch is its cost.
//
// Design:
//  * hash: one thread an output key. Each operand (k0, k1, x0, x1) is a
//    scalar or an int32 / int64 tensor read through its own broadcast
//    strides, so fold_in and split read the caller's keys and data where
//    they lie, with no expand, stack or cast launched around the kernel,
//    and a CUDA graph's replay reads the values its buffers hold then.
//  * words: one thread a word.
//  * categorical: one thread a (key, row): the row's n draws, each hashed,
//    transformed and added to its logit in registers, and the running
//    argmax. The learners' rows are short (6 actions), so a thread a row
//    needs no shuffle, no shared memory and no second pass, and the noise
//    never leaves registers; a species' 65,536 rows still give the card
//    2,048 warps, 15 an SM.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 1 << 16;  // the grids stride past this
constexpr int kMaxDims = 8;
constexpr int kOperands = 4;             // k0, k1, x0, x1
// A hash operand's record from the host: pointer (0: a scalar), the
// scalar, bytes an element (4 or 8), kMaxDims strides in elements.
constexpr int kOperandRecord = 3 + kMaxDims;

// ---- counter RNG: jax's threefry2x32, 20 rounds, in uint32 ----

struct Key {
  uint32_t k0, k1;
};

__device__ __forceinline__ void mix(uint32_t& x0, uint32_t& x1, int r) {
  x0 += x1;
  x1 = __funnelshift_l(x1, x1, r) ^ x0;
}

__device__ __forceinline__ Key threefry(Key k, uint32_t x0, uint32_t x1) {
  const uint32_t ks[3] = {k.k0, k.k1, k.k0 ^ k.k1 ^ 0x1BD11BDAu};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    if (i & 1) {
      mix(x0, x1, 17); mix(x0, x1, 29); mix(x0, x1, 16); mix(x0, x1, 24);
    } else {
      mix(x0, x1, 13); mix(x0, x1, 15); mix(x0, x1, 26); mix(x0, x1, 6);
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  return {x0, x1};
}

// Keys are int64 words holding uint32 values, [k0, k1] a key.
__device__ __forceinline__ Key load_key(const int64_t* keys, int64_t k) {
  return {(uint32_t)keys[2 * k], (uint32_t)keys[2 * k + 1]};
}

__device__ __forceinline__ uint32_t random_word(Key k, uint32_t ctr) {
  const Key y = threefry(k, 0u, ctr);
  return y.k0 ^ y.k1;
}

// jax.random.gumbel's "low" mode from one word: uniform in [0, 1) from the
// 23 mantissa bits, then -log(-log(max(u + tiny, tiny))).
__device__ __forceinline__ float gumbel(uint32_t word) {
  const float tiny = 1.17549435e-38f;  // FLT_MIN, torch.finfo(float32).tiny
  const float u = __uint_as_float((word >> 9) | 0x3F800000u) - 1.0f;
  return -logf(-logf(fmaxf(u + tiny, tiny)));
}

struct Operand {
  const char* ptr;            // null: the scalar `value`
  int64_t stride[kMaxDims];   // elements; 0 along a broadcast dim
  uint32_t value;
  int bytes;                  // 4 (int32) or 8 (int64): the low word is first
};

struct HashArgs {
  Operand op[kOperands];
  int64_t size[kMaxDims];
  int nd;
};

__global__ void threefry_hash_kernel(HashArgs a, int64_t n, int64_t* __restrict__ out) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    int64_t off[kOperands] = {0, 0, 0, 0};
    int64_t rest = i;
    for (int d = a.nd - 1; d >= 0; --d) {
      const int64_t c = rest % a.size[d];
      rest /= a.size[d];
#pragma unroll
      for (int o = 0; o < kOperands; ++o) off[o] += c * a.op[o].stride[d];
    }
    uint32_t v[kOperands];
#pragma unroll
    for (int o = 0; o < kOperands; ++o) {
      const Operand& p = a.op[o];
      // The low 32 bits of a little-endian int32 or int64 lie at its address.
      v[o] = p.ptr ? *reinterpret_cast<const uint32_t*>(p.ptr + off[o] * p.bytes) : p.value;
    }
    const Key y = threefry({v[0], v[1]}, v[2], v[3]);
    out[2 * i] = y.k0;
    out[2 * i + 1] = y.k1;
  }
}

__global__ void threefry_words_kernel(const int64_t* __restrict__ keys, int64_t words,
                                      uint32_t offset, int64_t n, int64_t* __restrict__ out) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t k = i / words;
    out[i] = random_word(load_key(keys, k), offset + (uint32_t)(i - k * words));
  }
}

__global__ void threefry_categorical_kernel(const int64_t* __restrict__ keys,
                                            const float* __restrict__ logits, int64_t rows,
                                            int width, uint32_t offset, int64_t n,
                                            int64_t* __restrict__ out) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t k = i / rows;
    const Key key = load_key(keys, k);
    const float* row = logits + i * width;
    // The row's first counter in the key's draw; uint32 wraps as jax's do.
    uint32_t ctr = offset + (uint32_t)((i - k * rows) * width);
    float best = gumbel(random_word(key, ctr)) + row[0];
    int arg = 0;
    for (int j = 1; j < width; ++j) {
      const float v = gumbel(random_word(key, ++ctr)) + row[j];
      if (!isnan(best) && (isnan(v) || v > best)) {
        best = v;
        arg = j;
      }
    }
    out[i] = arg;
  }
}

__global__ void threefry_gumbel_kernel(const int64_t* __restrict__ words, int64_t n,
                                       float* __restrict__ out) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x)
    out[i] = gumbel((uint32_t)words[i]);
}

int blocks(int64_t n) {
  const int64_t b = (n + kThreads - 1) / kThreads;
  return (int)(b < kMaxBlocks ? b : kMaxBlocks);
}

}  // namespace

// out [n, 2] int64: hash(k0, k1, x0, x1) over the broadcast shape `desc`
// describes: nd, kMaxDims sizes, then kOperands operand records.
extern "C" int mbots_threefry_hash(const int64_t* desc, int64_t n, int64_t* out,
                                   cudaStream_t stream) {
  HashArgs a;
  a.nd = (int)desc[0];
  for (int d = 0; d < kMaxDims; ++d) a.size[d] = desc[1 + d];
  for (int o = 0; o < kOperands; ++o) {
    const int64_t* r = desc + 1 + kMaxDims + o * kOperandRecord;
    a.op[o].ptr = reinterpret_cast<const char*>(r[0]);
    a.op[o].value = (uint32_t)r[1];
    a.op[o].bytes = (int)r[2];
    for (int d = 0; d < kMaxDims; ++d) a.op[o].stride[d] = r[3 + d];
  }
  threefry_hash_kernel<<<blocks(n), kThreads, 0, stream>>>(a, n, out);
  return (int)cudaGetLastError();
}

// out [num_keys, words] int64: words offset .. offset + words - 1 of each key.
extern "C" int mbots_threefry_words(const int64_t* keys, int64_t num_keys, int64_t words,
                                    int64_t offset, int64_t* out, cudaStream_t stream) {
  const int64_t n = num_keys * words;
  threefry_words_kernel<<<blocks(n), kThreads, 0, stream>>>(keys, words, (uint32_t)offset, n,
                                                            out);
  return (int)cudaGetLastError();
}

// out [num_keys, rows] int64: the categorical draw of contiguous f32 logits
// [num_keys, rows, width], element (r, j) of key k at counter offset + r *
// width + j of k's draw.
extern "C" int mbots_threefry_categorical(const int64_t* keys, int64_t num_keys,
                                          const float* logits, int64_t rows, int width,
                                          int64_t offset, int64_t* out, cudaStream_t stream) {
  const int64_t n = num_keys * rows;
  threefry_categorical_kernel<<<blocks(n), kThreads, 0, stream>>>(
      keys, logits, rows, width, (uint32_t)offset, n, out);
  return (int)cudaGetLastError();
}

// out [n] f32: the Gumbel noise of each given word (the draw's transform,
// for tests that hold it to torch's on every input).
extern "C" int mbots_threefry_gumbel(const int64_t* words, int64_t n, float* out,
                                     cudaStream_t stream) {
  threefry_gumbel_kernel<<<blocks(n), kThreads, 0, stream>>>(words, n, out);
  return (int)cudaGetLastError();
}
