// Block-wide prefix sums over one world's slots.
#pragma once

namespace mbots {

// Inclusive prefix sum of v over the slots a' <= a with a' = a (mod stride):
// stride 1 is a plain scan, stride NS the per-class scan of the slot classes
// (slot a belongs to class a % NS). Hillis-Steele over `buf` (one int per
// slot, shared); every thread of the block calls it, `valid` marks the
// threads that hold a slot (a < A).
__device__ __forceinline__ int strided_scan(int v, int* buf, int a, bool valid,
                                            int A, int stride) {
  if (valid) buf[a] = v;
  __syncthreads();
  for (int d = stride; d < A; d <<= 1) {
    const int t = (valid && a >= d) ? buf[a - d] : 0;
    __syncthreads();
    if (valid) buf[a] += t;
    __syncthreads();
  }
  return valid ? buf[a] : 0;
}

// Exclusive prefix count of `v` over the block's threads in ascending order
// (warp ballots, then the warps' counts), and in *total the block's count.
// Every thread of the block calls it; blockDim.x is a multiple of 32 and
// `wcount` holds one int per warp (shared).
__device__ __forceinline__ int block_rank(bool v, int* wcount, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned m = __ballot_sync(0xffffffffu, v);
  if (lane == 0) wcount[warp] = __popc(m);
  __syncthreads();
  int before = 0, all = 0;
  for (int i = 0; i < (int)(blockDim.x >> 5); ++i) {
    const int c = wcount[i];
    before += i < warp ? c : 0;
    all += c;
  }
  __syncthreads();  // wcount is free for the next call
  *total = all;
  return before + __popc(m & ((1u << lane) - 1u));
}

}  // namespace mbots
