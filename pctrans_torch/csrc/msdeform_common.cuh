// Shared by the ms-deform kernels (msdeform_fwd.cu K1, msdeform_bwd.cu K2,
// msdeform_separable.cu K5): the level table and the value-dtype loads.
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

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

}  // namespace msdeform
