// K1: multi-scale deformable attention, forward (direct bilinear gather).
//
// Replaces the TPU kernel pctrans_tpu/ops/msdeform_pallas2.py:_fused_kernel
// (hat-matmul over lane-major sample chunks, a workaround for the TPU's lack
// of a gather).  On Hopper the natural form is the original CUDA im2col
// design: one thread per output element (b, q, m, d) loops over L levels x
// P points x 4 bilinear corners, accumulates in f32 and stores once in the
// value dtype.  A block holds whole queries (threadIdx.x = head * D + d,
// threadIdx.y = query), which keeps 64-bit divisions out of the index decode.
//
// Bound: memory latency of the corner gathers.  At the CVPPP eval shape
// (B=4, Lq=S=5581, M=8, D=16, L=3, P=4) the kernel issues 137M corner loads
// of 2 bytes (bf16) against a 1.4 MB value map that stays in the 50 MB L2;
// the 16 consecutive d of one head read 32 contiguous bytes per corner, so a
// warp (two heads) touches two 32-byte sectors per corner.  Arithmetic is
// ~0.5 GFLOP, far below the card's rate.  Measured 0.191 ms at this shape on
// an H100 80GB HBM3 (700 W limit), against 0.691 ms for the grid_sample twin.
//
// Contract (pctrans_tpu/ops/msdeform.py:1-18): value [B, S, M, D];
// loc [B, Lq, M, L, P, 2] f32 normalised (x, y); w [B, Lq, M, L, P] f32;
// out [B, Lq, M*D] in the value dtype.  Pixel position = loc * size - 0.5,
// corners outside the map contribute zero (grid_sample, zero padding).

#include "msdeform_common.cuh"

using namespace msdeform;

namespace {

constexpr int kThreads = 256;

// block: threadIdx.x = m * D + d over one query's heads and channels,
// threadIdx.y = query within the block
template <typename T>
__global__ void __launch_bounds__(kThreads)
msdeform_fwd_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                    const float* __restrict__ attw, T* __restrict__ out,
                    int64_t n_bq, int S, int M, int D, int Lq, int L, int P,
                    Levels lv) {
  const int64_t bq = blockIdx.x * (int64_t)blockDim.y + threadIdx.y;  // b*Lq+q
  if (bq >= n_bq) return;
  const int m = threadIdx.x / D, d = threadIdx.x - (threadIdx.x / D) * D;
  const int64_t idx = bq * M * D + threadIdx.x;
  const int64_t b = bq / Lq;
  const int64_t bqm = bq * M + m;
  const float* locp = loc + bqm * L * P * 2;
  const float* wp = attw + bqm * L * P;
  const int64_t sstride = (int64_t)M * D;
  const T* vb = value + b * S * sstride + (int64_t)m * D + d;

  float acc = 0.f;
  for (int l = 0; l < L; ++l) {
    const int H = lv.h[l], W = lv.w[l];
    const T* vl = vb + (int64_t)lv.start[l] * sstride;
    for (int p = 0; p < P; ++p) {
      const int lp = l * P + p;
      // __fmul_rn: no FMA contraction, so x rounds as the twin's loc * W - 0.5
      // does and an integral coordinate stays integral
      const float x = __fmul_rn(__ldg(locp + 2 * lp), (float)W) - 0.5f;
      const float y = __fmul_rn(__ldg(locp + 2 * lp + 1), (float)H) - 0.5f;
      // every corner is outside (also rejects NaN)
      if (!(x > -1.f && x < (float)W && y > -1.f && y < (float)H)) continue;
      const float a = __ldg(wp + lp);
      const float x0f = floorf(x), y0f = floorf(y);
      const float tx = x - x0f, ty = y - y0f;
      const int x0 = (int)x0f, y0 = (int)y0f;
      const bool xin0 = x0 >= 0, xin1 = x0 + 1 < W;
      float s = 0.f;
      if (y0 >= 0) {
        const T* row = vl + (int64_t)y0 * W * sstride;
        if (xin0) s += (1.f - tx) * (1.f - ty) * load_f32(row + (int64_t)x0 * sstride);
        if (xin1) s += tx * (1.f - ty) * load_f32(row + (int64_t)(x0 + 1) * sstride);
      }
      if (y0 + 1 < H) {
        const T* row = vl + (int64_t)(y0 + 1) * W * sstride;
        if (xin0) s += (1.f - tx) * ty * load_f32(row + (int64_t)x0 * sstride);
        if (xin1) s += tx * ty * load_f32(row + (int64_t)(x0 + 1) * sstride);
      }
      acc += a * s;
    }
  }
  store_f32(out + idx, acc);
}

}  // namespace

extern "C" int pctrans_msdeform_fwd(const void* value, const void* loc,
                                    const void* attw, void* out, int B, int S,
                                    int M, int D, int Lq, int L, int P,
                                    const int* shapes, int is_bf16,
                                    void* stream) {
  Levels lv;
  if (!make_levels(shapes, L, S, &lv)) return (int)cudaErrorInvalidValue;
  if (M * D > kThreads) return (int)cudaErrorInvalidValue;
  const int64_t n_bq = (int64_t)B * Lq;
  if (n_bq == 0) return (int)cudaSuccess;
  dim3 block(M * D, kThreads / (M * D));
  const int64_t blocks = (n_bq + block.y - 1) / block.y;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    msdeform_fwd_kernel<__nv_bfloat16><<<(unsigned)blocks, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(value), static_cast<const float*>(loc),
        static_cast<const float*>(attw), static_cast<__nv_bfloat16*>(out), n_bq,
        S, M, D, Lq, L, P, lv);
  } else {
    msdeform_fwd_kernel<float><<<(unsigned)blocks, block, 0, s>>>(
        static_cast<const float*>(value), static_cast<const float*>(loc),
        static_cast<const float*>(attw), static_cast<float*>(out), n_bq, S, M,
        D, Lq, L, P, lv);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* pctrans_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
