// K4: fused bilinear upsample + threshold binarize.
//
// Replaces the TPU kernel pctrans_tpu/ops/resize_pallas.py:_kernel (two bf16
// MXU dots against jax.image.resize-of-identity matrices per query).  Here
// one thread owns one output column of a 16-row strip; per pixel it applies
// the 2x2 stencil in f32 -- W axis first, then H, the twin's separable order
// -- compares with the threshold logit and writes one byte.  The
// full-resolution f32 logits are never stored.
//
// Bound: at the CVPPP eval shape ([4, 50, 133, 125] f32 -> [4, 50, 530, 500]
// u8) the kernel writes 53 MB and reads 13 MB, ~0.02 ms of device-memory
// time; the unfused twin writes and re-reads 212 MB of f32 logits before its
// compare.  With one pixel per thread the 212k small blocks were
// latency-bound (0.223 ms on an H100 80GB HBM3, 700 W limit); a 16-row strip
// per thread keeps 16 independent loads in flight and reuses the column taps
// (0.110 ms there, against 0.418 ms for the twin).
//
// The per-row and per-column tables (two source indices, two weights) come
// from the wrapper: jax.image.resize's half-pixel rule with the off-edge taps
// dropped and renormalised, which for upsampling equals clamping the source
// coordinate.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 16;  // output rows per thread: amortises the column taps
                           // and keeps 16 independent loads in flight

__global__ void __launch_bounds__(kThreads)
resize_binarize_kernel(const float* __restrict__ x, const int* __restrict__ row_idx,
                       const float* __restrict__ row_w,
                       const int* __restrict__ col_idx,
                       const float* __restrict__ col_w,
                       unsigned char* __restrict__ out, int h, int w, int H,
                       int W, float logit_t) {
  // grid: (column tiles, row tiles of kRows, image n) -- no index division
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= W) return;
  const int64_t n = blockIdx.z;
  const int c0 = __ldg(col_idx + 2 * j), c1 = __ldg(col_idx + 2 * j + 1);
  const float wc0 = __ldg(col_w + 2 * j), wc1 = __ldg(col_w + 2 * j + 1);
  const float* xp = x + n * h * w;
  unsigned char* op = out + n * H * W + j;
  const int i_begin = blockIdx.y * kRows;
  const int i_end = min(i_begin + kRows, H);
#pragma unroll 4
  for (int i = i_begin; i < i_end; ++i) {
    const int r0 = __ldg(row_idx + 2 * i), r1 = __ldg(row_idx + 2 * i + 1);
    const float wr0 = __ldg(row_w + 2 * i), wr1 = __ldg(row_w + 2 * i + 1);
    const float t0 = wc0 * __ldg(xp + r0 * w + c0) + wc1 * __ldg(xp + r0 * w + c1);
    const float t1 = wc0 * __ldg(xp + r1 * w + c0) + wc1 * __ldg(xp + r1 * w + c1);
    const float v = wr0 * t0 + wr1 * t1;
    op[(int64_t)i * W] = v > logit_t ? 1 : 0;
  }
}

}  // namespace

extern "C" int pctrans_resize_binarize(const void* x, const void* row_idx,
                                       const void* row_w, const void* col_idx,
                                       const void* col_w, void* out, int N,
                                       int h, int w, int H, int W,
                                       float logit_t, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0) return (int)cudaSuccess;
  if (N > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((W + kThreads - 1) / kThreads, (H + kRows - 1) / kRows, N);
  resize_binarize_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(row_idx),
      static_cast<const float*>(row_w), static_cast<const int*>(col_idx),
      static_cast<const float*>(col_w), static_cast<unsigned char*>(out), h, w,
      H, W, logit_t);
  return (int)cudaGetLastError();
}
