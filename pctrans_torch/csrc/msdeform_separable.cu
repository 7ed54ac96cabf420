// K5: multi-scale deformable attention, forward, separable form.
//
// Replaces the TPU kernel pctrans_tpu/ops/msdeform_pallas.py:_level_kernel,
// which splits bilinear sampling into its separable factors per (batch*head,
// 128-query chunk, level): stage 1 contracts the level's value map over the
// W axis against hat_x (t = hat_x[CH, W] @ V^T[W, D*H] on the MXU), stage 2
// reduces t over H against hat_y * w.  The hats relu(1 - |s - p|) are dense
// rows: every pixel of the level enters both stages, with weight 0 away from
// the sample.  K5 keeps that dense two-stage contraction (a 4-corner gather
// is K1, msdeform_fwd.cu).
//
// Design: one block per (b*m, 128-query chunk), one thread per query; the
// block loops over the levels, so the three level sums add in f32 in one
// place, in order, with no second pass.  The (b, m) value slab of a level is
// staged through shared memory as f32 rows [h][x][d] in passes of as many
// rows as 32 KB hold (the eval res3 slab, 67x63x16 bf16, is 135 KB in f32,
// too large to stage whole).  For each staged row h and each of its P
// samples a thread forms t[d] = sum_x hat_x(x) * V[h, x, d] (stage 1, D
// accumulators in registers, the value read as float4 broadcasts from shared
// memory) and adds hat_y(h) * w * t[d] into its D output accumulators
// (stage 2).  Hats are f32 against the f32-staged value: the TPU kernel
// rounds hat_x to the value dtype before its stage-1 dot
// (msdeform_pallas.py:101), this kernel does not.  A sample whose every
// corner lies outside the map (or whose coordinate is NaN) is skipped, as in
// K1: its hats are all zero.
//
// Bound: at these shapes, f32 FMAs on the CUDA cores.  Stage 1 does
// sum_l H_l * W_l * D FMAs per (b, m, q, p) sample inside the map: at the
// CVPPP eval shape (B=4, Lq=S=5581, M=8, P=4, levels 17x16, 34x32, 67x63,
// D=16) 89,296 per sample, 1.28e11 FLOP per call when every sample is
// inside, at least 1.9 ms at the card's 67 TFLOP/s f32 rate.  The value slab
// is read from L2 once per block.  Measured 5.15 ms at this shape (74% of
// the samples inside their map) on an H100 80GB HBM3 (700 W limit), ~27% of
// the f32 peak, against K1's 0.19 ms.  The work that the inputs need is K1's
// (four corners per sample), so against K1's bound this kernel's roofline
// share is small: a tensor-core stage 1 (mma.sync / wgmma in bf16) is the
// later redesign.
//
// Contract (pctrans_tpu/ops/msdeform.py:1-18): value [B, S, M, D] f32 or
// bf16 with D in {4, 8, 16, 32}; loc [B, Lq, M, L, P, 2] f32 normalised
// (x, y); w [B, Lq, M, L, P] f32; out [B, Lq, M*D] in the value dtype.
// Pixel position = loc * size - 0.5; pixels outside the map contribute zero.

#include "msdeform_common.cuh"

using namespace msdeform;

namespace {

constexpr int kQueries = 128;      // threads per block, one query each
constexpr int kSlabFloats = 8192;  // f32 value elements staged per pass

template <typename T, int D>
__global__ void __launch_bounds__(kQueries)
msdeform_sep_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                    const float* __restrict__ attw, T* __restrict__ out, int S,
                    int M, int Lq, int L, int P, Levels lv) {
  __shared__ __align__(16) float slab[kSlabFloats];
  const int bm = blockIdx.y;
  const int b = bm / M, m = bm - (bm / M) * M;
  const int q = blockIdx.x * kQueries + threadIdx.x;
  const bool live = q < Lq;
  const int64_t sstride = (int64_t)M * D;
  const T* vbm = value + (int64_t)b * S * sstride + (int64_t)m * D;
  const int64_t bqm = ((int64_t)b * Lq + (live ? q : 0)) * M + m;
  const float* locp = loc + bqm * L * P * 2;
  const float* wp = attw + bqm * L * P;

  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;

  for (int l = 0; l < L; ++l) {
    const int H = lv.h[l], W = lv.w[l];
    const int row = W * D;               // f32 elements of one staged row
    const int rows = kSlabFloats / row;  // the host checks row <= kSlabFloats
    const T* vl = vbm + (int64_t)lv.start[l] * sstride;
    for (int h0 = 0; h0 < H; h0 += rows) {
      const int hc = min(rows, H - h0);
      __syncthreads();  // every thread is done with the previous pass
      for (int i = threadIdx.x; i < hc * row; i += kQueries) {
        const int r = i / row, x = (i - r * row) / D, d = i % D;
        slab[i] = load_f32(vl + ((int64_t)(h0 + r) * W + x) * sstride + d);
      }
      __syncthreads();
      if (!live) continue;
      for (int p = 0; p < P; ++p) {
        const int lp = l * P + p;
        // __fmul_rn: no FMA contraction, so x rounds as the twins' loc * W -
        // 0.5 does and an integral coordinate stays integral
        const float x = __fmul_rn(__ldg(locp + 2 * lp), (float)W) - 0.5f;
        const float y = __fmul_rn(__ldg(locp + 2 * lp + 1), (float)H) - 0.5f;
        if (!(x > -1.f && x < (float)W && y > -1.f && y < (float)H)) continue;
        const float a = __ldg(wp + lp);
        for (int r = 0; r < hc; ++r) {
          // stage 2 weight of row h0 + r: zero away from the sample's rows,
          // the contraction stays dense
          const float hy = fmaxf(0.f, 1.f - fabsf(y - (float)(h0 + r))) * a;
          const float4* vr = reinterpret_cast<const float4*>(slab + r * row);
          float t[D];
#pragma unroll
          for (int d = 0; d < D; ++d) t[d] = 0.f;
          for (int xs = 0; xs < W; ++xs) {  // stage 1 over the W axis
            const float hx = fmaxf(0.f, 1.f - fabsf(x - (float)xs));
#pragma unroll
            for (int k = 0; k < D / 4; ++k) {
              const float4 v = vr[xs * (D / 4) + k];
              t[4 * k] += hx * v.x;
              t[4 * k + 1] += hx * v.y;
              t[4 * k + 2] += hx * v.z;
              t[4 * k + 3] += hx * v.w;
            }
          }
#pragma unroll
          for (int d = 0; d < D; ++d) acc[d] += hy * t[d];
        }
      }
    }
  }
  if (!live) return;
  T* o = out + bqm * D;
#pragma unroll
  for (int d = 0; d < D; ++d) store_f32(o + d, acc[d]);
}

template <typename T>
int launch(const void* value, const void* loc, const void* attw, void* out,
           int S, int M, int D, int Lq, int L, int P, const Levels& lv,
           dim3 grid, cudaStream_t s) {
  const T* v = static_cast<const T*>(value);
  const float* lp = static_cast<const float*>(loc);
  const float* wp = static_cast<const float*>(attw);
  T* o = static_cast<T*>(out);
  switch (D) {
    case 4:
      msdeform_sep_kernel<T, 4><<<grid, kQueries, 0, s>>>(v, lp, wp, o, S, M, Lq, L, P, lv);
      break;
    case 8:
      msdeform_sep_kernel<T, 8><<<grid, kQueries, 0, s>>>(v, lp, wp, o, S, M, Lq, L, P, lv);
      break;
    case 16:
      msdeform_sep_kernel<T, 16><<<grid, kQueries, 0, s>>>(v, lp, wp, o, S, M, Lq, L, P, lv);
      break;
    case 32:
      msdeform_sep_kernel<T, 32><<<grid, kQueries, 0, s>>>(v, lp, wp, o, S, M, Lq, L, P, lv);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pctrans_msdeform_sep_fwd(const void* value, const void* loc,
                                        const void* attw, void* out, int B,
                                        int S, int M, int D, int Lq, int L,
                                        int P, const int* shapes, int is_bf16,
                                        void* stream) {
  Levels lv;
  if (!make_levels(shapes, L, S, &lv)) return (int)cudaErrorInvalidValue;
  for (int l = 0; l < L; ++l)
    if (lv.w[l] * D > kSlabFloats) return (int)cudaErrorInvalidValue;
  if ((int64_t)B * M > 65535) return (int)cudaErrorInvalidValue;
  if (B == 0 || M == 0 || Lq == 0) return (int)cudaSuccess;
  const dim3 grid((Lq + kQueries - 1) / kQueries, B * M);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(value, loc, attw, out, S, M, D, Lq, L,
                                         P, lv, grid, s)
                 : launch<float>(value, loc, attw, out, S, M, D, Lq, L, P, lv,
                                 grid, s);
}
