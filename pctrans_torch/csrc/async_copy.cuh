// Asynchronous global -> shared copies (cp.async, sm_80+), shared by K1
// (msdeform_fwd.cu) and K3 (render.cu) to stage the next tile's inputs
// while the current one computes.
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

}  // namespace async_copy
