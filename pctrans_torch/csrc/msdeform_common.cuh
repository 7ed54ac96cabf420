// Shared by the ms-deform kernels (msdeform_fwd.cu K1, msdeform_bwd.cu K2,
// msdeform_separable.cu K5): the level table, the resident-block count for
// a launch and the value-dtype loads.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace msdeform {

constexpr int kMaxLevels = 8;

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];  // first flattened position of each level
};

// The level table of `shapes` (host int[2L]: H, W per level); false when L
// is out of range or the levels do not add up to S.
inline bool make_levels(const int* shapes, int L, int S, Levels* lv) {
  if (L < 1 || L > kMaxLevels) return false;
  int start = 0;
  for (int l = 0; l < L; ++l) {
    lv->h[l] = shapes[2 * l];
    lv->w[l] = shapes[2 * l + 1];
    lv->start[l] = start;
    start += lv->h[l] * lv->w[l];
  }
  return start == S;
}

// Blocks of `kernel` resident on the whole device at `threads` threads and
// `smem` bytes of dynamic shared memory (raising the kernel's dynamic
// shared-memory limit above 48 KB where needed).  Kept per host thread and
// kernel signature for the last (device, kernel, threads, smem), so a run of
// launches makes one occupancy query.
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, int threads, size_t smem, int* blocks) {
  struct Wave {
    int dev = -1;
    const void* fn = nullptr;
    int threads = 0;
    size_t smem = 0;
    int blocks = 0;
  };
  static thread_local Wave wave;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const void* fn = reinterpret_cast<const void*>(kernel);
  if (dev != wave.dev || fn != wave.fn || threads != wave.threads || smem != wave.smem) {
    if (smem > 48 * 1024) {
      e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return e;
    }
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, smem);
    if (e != cudaSuccess) return e;
    wave = Wave{dev, fn, threads, smem, sms * (per_sm > 1 ? per_sm : 1)};
  }
  *blocks = wave.blocks;
  return cudaSuccess;
}

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

}  // namespace msdeform
