// K2: multi-scale deformable attention, backward (direct scatter).
//
// Replaces the TPU kernel pctrans_tpu/ops/msdeform_pallas2.py:_level_bwd_kernel
// (per (batch*head) slab, hat matrices on the MXU, d_value accumulated in
// VMEM).  On Hopper one thread per (b, q, head, channel), the first K1's
// thread map: a block holds whole queries, threadIdx.x = head * D + d,
// threadIdx.y = query.  For
// every (level, point) a thread reads its channel at the four corners and
//   - forms g_d * sample_d (-> d_weights) and the x / y location terms,
//     reduced over the head's D channels with __shfl_xor_sync inside the
//     warp (D is a power of two <= 32, so a head's lanes are one aligned
//     group of a warp); lane d == 0 writes the three results;
//   - adds w * corner_weight * g_d into an f32 d_value buffer with atomicAdd
//     for every in-range corner.  The 16 lanes of a head hit 16 consecutive
//     floats, so the atomics coalesce into 64-byte segments.
// Every lane takes part in every shuffle: samples outside the map and lanes
// past the last query contribute zeros instead of branching away.
//
// Derivative convention (msdeform_pallas2.py:138-144): the bilinear weights
// are hats relu(1 - |s - p|) and their location derivative is sign(s - p) on
// the open support.  For tx = x - floor(x) > 0 that is the usual
// v(x0+1) - v(x0); at an exactly integral x (tx == 0) it is zero, where
// grid_sample's backward would still take the floor difference.  The same
// holds for y.  The chain rule through x = loc * W - 0.5 multiplies by W.
//
// Not deterministic: the atomics add in a different order on every run, so
// d_value differs from run to run by f32 rounding (the TPU kernel is
// deterministic).  d_locations and d_weights have one writer each.
//
// Bound: atomics and corner gathers.  At the CVPPP train shape (B=2,
// Lq=S=4116, M=8, D=16, L=3, P=4) a launch issues 50.6M one-channel corner
// loads and up to as many f32 atomics onto a 4.2 MB d_value buffer that
// stays in the 50 MB L2.  The encoder's 14x14 level takes 16,464 samples
// per (batch, head) on 196 positions, ~84 per position, so contention on
// its corners is real.  Arithmetic is negligible.
//
// Contract: value [B, S, M, D] (f32 or bf16); loc [B, Lq, M, L, P, 2] f32;
// w [B, Lq, M, L, P] f32; grad [B, Lq, M*D] in the value dtype.  Outputs:
// d_value [B, S, M, D] f32 (zeroed by the caller), d_loc like loc, d_w
// like w (f32, every element written).

#include "msdeform_common.cuh"

using namespace msdeform;

namespace {

constexpr int kThreads = 256;

// sum over the aligned group of `width` lanes (a power of two <= 32);
// `mask` names the lanes that exist in this warp
__device__ __forceinline__ float group_sum(float v, int width, unsigned mask) {
  for (int off = width >> 1; off > 0; off >>= 1)
    v += __shfl_xor_sync(mask, v, off);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
msdeform_bwd_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                    const float* __restrict__ attw, const T* __restrict__ grad,
                    float* __restrict__ d_value, float* __restrict__ d_loc,
                    float* __restrict__ d_w, int64_t n_bq, int S, int M, int D,
                    int Lq, int L, int P, Levels lv) {
  const int64_t bq_raw = blockIdx.x * (int64_t)blockDim.y + threadIdx.y;
  const bool live = bq_raw < n_bq;
  const int64_t bq = live ? bq_raw : n_bq - 1;   // clamp; contributes zeros
  const int m = threadIdx.x / D, d = threadIdx.x - (threadIdx.x / D) * D;
  // the last warp of a block whose size is not a multiple of 32 is partial;
  // it still holds whole heads (blockDim.x is a multiple of D, D divides 32)
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int lanes = min(32, (int)(blockDim.x * blockDim.y) - (tid & ~31));
  const unsigned mask = lanes == 32 ? 0xffffffffu : (1u << lanes) - 1u;
  const int64_t b = bq / Lq;
  const int64_t bqm = bq * M + m;
  const float* locp = loc + bqm * L * P * 2;
  const float* wp = attw + bqm * L * P;
  const int64_t sstride = (int64_t)M * D;
  const int64_t voff = b * S * sstride + (int64_t)m * D + d;
  const T* vb = value + voff;
  float* dvb = d_value + voff;
  const float g = live ? load_f32(grad + bq * M * D + threadIdx.x) : 0.f;

  for (int l = 0; l < L; ++l) {
    const int H = lv.h[l], W = lv.w[l];
    const int64_t lstart = (int64_t)lv.start[l] * sstride;
    for (int p = 0; p < P; ++p) {
      const int lp = l * P + p;
      // __fmul_rn: no FMA contraction, so x rounds as the twin's loc * W - 0.5
      // does and an integral coordinate stays integral
      const float x = __fmul_rn(__ldg(locp + 2 * lp), (float)W) - 0.5f;
      const float y = __fmul_rn(__ldg(locp + 2 * lp + 1), (float)H) - 0.5f;
      const float a = __ldg(wp + lp);
      float dot = 0.f, gx = 0.f, gy = 0.f;
      // a corner is inside the map (also rejects NaN), as in K1
      if (live && x > -1.f && x < (float)W && y > -1.f && y < (float)H) {
        const float x0f = floorf(x), y0f = floorf(y);
        const float tx = x - x0f, ty = y - y0f;
        const int x0 = (int)x0f, y0 = (int)y0f;
        const bool xin0 = x0 >= 0, xin1 = x0 + 1 < W;
        const bool yin0 = y0 >= 0, yin1 = y0 + 1 < H;
        const int64_t o00 = lstart + ((int64_t)y0 * W + x0) * sstride;
        const int64_t o01 = o00 + sstride;
        const int64_t o10 = o00 + (int64_t)W * sstride;
        const int64_t o11 = o10 + sstride;
        const float v00 = (yin0 && xin0) ? load_f32(vb + o00) : 0.f;
        const float v01 = (yin0 && xin1) ? load_f32(vb + o01) : 0.f;
        const float v10 = (yin1 && xin0) ? load_f32(vb + o10) : 0.f;
        const float v11 = (yin1 && xin1) ? load_f32(vb + o11) : 0.f;
        const float wx0 = 1.f - tx, wx1 = tx, wy0 = 1.f - ty, wy1 = ty;
        const float sample = wy0 * (wx0 * v00 + wx1 * v01) + wy1 * (wx0 * v10 + wx1 * v11);
        dot = g * sample;
        // hat derivative: zero at an integral coordinate
        if (tx > 0.f) gx = g * a * (wy0 * (v01 - v00) + wy1 * (v11 - v10));
        if (ty > 0.f) gy = g * a * (wx0 * (v10 - v00) + wx1 * (v11 - v01));
        const float ga = g * a;
        if (yin0 && xin0) atomicAdd(dvb + o00, ga * wy0 * wx0);
        if (yin0 && xin1) atomicAdd(dvb + o01, ga * wy0 * wx1);
        if (yin1 && xin0) atomicAdd(dvb + o10, ga * wy1 * wx0);
        if (yin1 && xin1) atomicAdd(dvb + o11, ga * wy1 * wx1);
      }
      dot = group_sum(dot, D, mask);
      gx = group_sum(gx, D, mask);
      gy = group_sum(gy, D, mask);
      if (live && d == 0) {
        const int64_t o = bqm * L * P + lp;
        d_w[o] = dot;
        d_loc[2 * o] = gx * W;
        d_loc[2 * o + 1] = gy * H;
      }
    }
  }
}

}  // namespace

extern "C" int pctrans_msdeform_bwd(const void* value, const void* loc,
                                    const void* attw, const void* grad,
                                    void* d_value, void* d_loc, void* d_w,
                                    int B, int S, int M, int D, int Lq, int L,
                                    int P, const int* shapes, int is_bf16,
                                    void* stream) {
  Levels lv;
  if (!make_levels(shapes, L, S, &lv)) return (int)cudaErrorInvalidValue;
  // D a power of two <= 32: a head's lanes form one aligned group of a warp
  if (D < 1 || D > 32 || (D & (D - 1)) || M * D > kThreads)
    return (int)cudaErrorInvalidValue;
  const int64_t n_bq = (int64_t)B * Lq;
  if (n_bq == 0) return (int)cudaSuccess;
  dim3 block(M * D, kThreads / (M * D));
  const int64_t blocks = (n_bq + block.y - 1) / block.y;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    msdeform_bwd_kernel<__nv_bfloat16><<<(unsigned)blocks, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(value), static_cast<const float*>(loc),
        static_cast<const float*>(attw), static_cast<const __nv_bfloat16*>(grad),
        static_cast<float*>(d_value), static_cast<float*>(d_loc),
        static_cast<float*>(d_w), n_bq, S, M, D, Lq, L, P, lv);
  } else {
    msdeform_bwd_kernel<float><<<(unsigned)blocks, block, 0, s>>>(
        static_cast<const float*>(value), static_cast<const float*>(loc),
        static_cast<const float*>(attw), static_cast<const float*>(grad),
        static_cast<float*>(d_value), static_cast<float*>(d_loc),
        static_cast<float*>(d_w), n_bq, S, M, D, Lq, L, P, lv);
  }
  return (int)cudaGetLastError();
}
