// Asynchronous global -> shared copies (cp.async, sm_80+), shared by K1
// (msdeform_fwd.cu), K2 (msdeform_bwd.cu) and K3 (render.cu) to stage the
// next tile's inputs while the current one computes.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace async_copy {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes, both addresses 16-byte aligned; bypasses L1 (.cg)
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void copy4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// n floats from src to dst, spread over the block's threads: 16-byte copies
// for the body, 4-byte copies for a tail of n % 4; dst and src 16-byte
// aligned.  Does not commit.
__device__ __forceinline__ void copy_floats(float* dst, const float* src, int n,
                                            int tid, int nthreads) {
  const int n4 = n >> 2;
  for (int i = tid; i < n4; i += nthreads) copy16(dst + 4 * i, src + 4 * i);
  for (int i = 4 * n4 + tid; i < n; i += nthreads) copy4(dst + i, src + i);
}

// `rows` rows of `row_floats` floats, `src_stride` floats apart in global
// memory, to dst packed back to back: 16-byte copies when both counts are
// multiples of 4 (dst and src 16-byte aligned), else 4-byte copies.  Does
// not commit.
__device__ __forceinline__ void copy_rows(float* dst, const float* src, int rows,
                                          int row_floats, int src_stride, int tid,
                                          int nthreads) {
  if ((row_floats & 3) == 0 && (src_stride & 3) == 0) {
    const int per = row_floats >> 2;
    for (int i = tid; i < rows * per; i += nthreads) {
      const int r = i / per, k = i - r * per;
      copy16(dst + r * row_floats + 4 * k, src + (int64_t)r * src_stride + 4 * k);
    }
  } else {
    for (int i = tid; i < rows * row_floats; i += nthreads) {
      const int r = i / row_floats, k = i - r * row_floats;
      copy4(dst + i, src + (int64_t)r * src_stride + k);
    }
  }
}

}  // namespace async_copy
