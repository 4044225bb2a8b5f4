// Block-wide inclusive prefix sums over one world's slots.
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

}  // namespace mbots
