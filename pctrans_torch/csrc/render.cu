// K3: CondInst dynamic mask render, forward.
//
// Replaces the TPU kernel pctrans_tpu/ops/render_pallas.py:_render_kernel
// (block-diagonal MXU packing of 16 queries' 8x8 convolutions).  Per query q
// a 3-layer 1x1 MLP (ch = 8) with controller-generated weights runs at every
// pixel of the stride-s mask-feature map:
//
//   x1 = relu(W1[q] @ [inst_xy(q) - loc(pixel) ; feats(pixel)] + b1[q])
//   x2 = relu(W2[q] @ x1 + b2[q])
//   out = W3[q] @ x2 + b3[q]                       -> [B, Q, HW] f32
//
// What bounds it: operations.  At the CVPPP eval shape (B=4, Q=100,
// HW=133*125, Cm=16) the function moves 31.2 MB (9.32 us at 3.35 TB/s) and
// does 2.873 GFLOP; f32-accurate on the tensor cores that is 3 TF32 products
// each, 17.4 us at 495 TFLOP/s (42.9 us on the CUDA cores at 67 TFLOP/s).
//
// Design (the first K3 ran one thread per (b, q, pixel) on the CUDA cores and
// re-read the feature map from L2 once per query, 426 MB at that shape):
//   - render_records_kernel rewrites each query's weights once into
//     per-lane mma fragment records (TF32 hi/lo splits of W1 and W2, the
//     constant b1 + W1_xy . inst_xy, b2, w3, b3), B*Q*(32*(4KS+4)+48)
//     floats in a scratch buffer the wrapper allocates;
//   - render_kernel: a block of 4 warps takes (b, 256 pixels) and loops
//     over all Q queries; each warp owns 64 pixels as four m16 row tiles
//     whose feature rows are loaded once into mma A fragments (split into
//     TF32 hi + lo) and reused by every query.  Four tiles per warp halve
//     the shared-memory reads of each query's records per pixel against
//     two; the kernel then holds ~250 registers, 8 warps per SM.  Records
//     arrive in chunks of 8 queries by cp.async into three rotating shared
//     buffers (the next chunk lands while this one computes; one barrier
//     per chunk) and are read as float4;
//   - stage 1 on the tensor cores: mma.sync m16n8k8 TF32 over K = Cm (zero
//     padded to 8 or 16) with 3xTF32 (a_lo b_hi + a_hi b_lo + a_hi b_hi), so
//     the result keeps f32 accuracy.  The accumulator starts from the
//     per-query constant plus the pixel term -W1_x px - W1_y py in f32
//     (render_pallas.py:153-178 folds the same split into its "extended
//     features");
//   - stage 2 from registers: W1's output channels are staged in the order
//     (0, 4, 1, 5, 2, 6, 3, 7), so the m16n8 accumulator (a thread holds
//     columns 2t, 2t+1) is already the m16n8k8 A fragment (columns t, t+4):
//     ReLU, split (hi rounded to nearest in integer ops; lo = x - hi passed
//     whole, the tensor core reads its top 19 bits), one 3xTF32 k-step,
//     accumulator started at b2;
//   - stage 3: ReLU, a partial dot with w3 over a thread's 2 channels, then
//     a transposing reduction over the quad (6 shuffles for a thread's 8
//     rows) leaves lane (g, t) with pixels 32 j + 8 t + g of the warp's 64:
//     two coalesced 128-byte stores per warp and query.
//
// Contract: feats [B, HW, Cm] f32, Cm <= 16; inst_xy [B, Q, 2] f32 pixel
// coordinates; w1 [B, Q, 8, cin] (cin = 2 + Cm with rel coords, rel rows
// first); w2 [B, Q, 8, 8]; w3 [B, Q, 1, 8]; b1, b2 [B, Q, 8]; b3 [B, Q, 1];
// all f32 and contiguous; records: scratch of pctrans_render_records_floats
// floats, 16-byte aligned.  Rel coords follow render_pallas.py:73-79: pixel
// (i, j) sits at (j*s + s/2, i*s + s/2).  The entry point refuses what the
// kernel does not take with cudaErrorInvalidValue; nothing falls back.

#include <limits.h>

#include "async_copy.cuh"

namespace {

constexpr int kCh = 8;             // dynamic_mask_channels
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTiles = 4;          // m16 row tiles per warp (even)
constexpr int kPixels = 16 * kTiles * kWarps;
constexpr int kQC = 8;             // queries per staged chunk
constexpr int kBufs = 3;           // rotating chunk buffers
constexpr int kMaxCm = 16;
constexpr int kTRec = 12;          // per (query, t) record, see render_records_kernel

template <int KS>
struct Rec {
  static constexpr int kLane = 4 * KS + 4;                // floats per lane record
  static constexpr int kQuery = 32 * kLane + 4 * kTRec;   // floats per query
};

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x ~ hi + lo, both TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// the per-query split of the hot loop: hi as cvt.rna would round it (finite
// x), lo = x - hi exactly, left to the tensor core to truncate
__device__ __forceinline__ void split_fast(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += A B to f32 accuracy (3xTF32), small terms first; b = (hi0, hi1,
// lo0, lo1) as render_records_kernel stages it
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ahi)[4],
                                     const uint32_t (&alo)[4], float4 b) {
  const uint32_t h0 = __float_as_uint(b.x), h1 = __float_as_uint(b.y);
  mma(d, alo, h0, h1);
  mma(d, ahi, __float_as_uint(b.z), __float_as_uint(b.w));
  mma(d, ahi, h0, h1);
}

// One query's fragment records, per (b, q):
//   32 lane records of 4*KS + 4 floats, lane = 4g + t:
//     stage-1 B for k-step s: W1f[perm[g]][8s + t], W1f[perm[g]][8s + t + 4]
//       as (hi0, hi1, lo0, lo1), perm = (0, 4, 1, 5, 2, 6, 3, 7);
//     stage-2 B: W2[g][t], W2[g][t + 4] as (hi0, hi1, lo0, lo1);
//   4 records of kTRec floats, one per t: for channels t and t + 4 the
//     constant b1 + W1_x inst_x + W1_y inst_y, -W1_x, -W1_y; then b2 and w3
//     at output channels 2t, 2t + 1; b3; a pad.
// One thread per record (36 per query).
template <int KS>
__global__ void __launch_bounds__(256)
render_records_kernel(const float* __restrict__ inst_xy, const float* __restrict__ w1,
                      const float* __restrict__ w2, const float* __restrict__ w3,
                      const float* __restrict__ b1, const float* __restrict__ b2,
                      const float* __restrict__ b3, float* __restrict__ rec, int n_bq,
                      int Cm, int rel) {
  const int it = blockIdx.x * blockDim.x + threadIdx.x;
  if (it >= n_bq * 36) return;
  const int bq = it / 36, r = it - bq * 36;
  const int cin = Cm + (rel ? 2 : 0), off = rel ? 2 : 0;
  const float* w1q = w1 + (int64_t)bq * kCh * cin;
  float* q = rec + (int64_t)bq * Rec<KS>::kQuery;
  if (r < 32) {
    const int g = r >> 2, t = r & 3;
    const int ch = (g >> 1) + 4 * (g & 1);
    float* o = q + r * Rec<KS>::kLane;
    uint32_t hi, lo;
#pragma unroll
    for (int s = 0; s < KS; ++s) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int k = 8 * s + t + 4 * c;
        split(k < Cm ? __ldg(w1q + ch * cin + off + k) : 0.f, hi, lo);
        o[4 * s + c] = __uint_as_float(hi);
        o[4 * s + 2 + c] = __uint_as_float(lo);
      }
    }
    const float* w2q = w2 + (int64_t)bq * kCh * kCh;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      split(__ldg(w2q + g * kCh + t + 4 * c), hi, lo);
      o[4 * KS + c] = __uint_as_float(hi);
      o[4 * KS + 2 + c] = __uint_as_float(lo);
    }
  } else {
    const int t = r - 32;
    float* o = q + 32 * Rec<KS>::kLane + t * kTRec;
    const float ix = __ldg(inst_xy + 2 * bq), iy = __ldg(inst_xy + 2 * bq + 1);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int ch = t + 4 * c;
      const float wx = rel ? __ldg(w1q + ch * cin) : 0.f;
      const float wy = rel ? __ldg(w1q + ch * cin + 1) : 0.f;
      o[c] = wx * ix + wy * iy + __ldg(b1 + bq * kCh + ch);
      o[2 + c] = -wx;
      o[4 + c] = -wy;
      o[6 + c] = __ldg(b2 + bq * kCh + 2 * t + c);
      o[8 + c] = __ldg(w3 + bq * kCh + 2 * t + c);
    }
    o[10] = __ldg(b3 + bq);
    o[11] = 0.f;
  }
}

// One query for the warp's 16 * kTiles pixels: lr, tr its lane and t
// records.  v[j] is the logit of the warp's pixel 32 j + 8 t + g.
template <int KS>
__device__ __forceinline__ void render_query(
    const float* lr_, const float* tr_, int t, const uint32_t (&ahi)[kTiles][KS][4],
    const uint32_t (&alo)[kTiles][KS][4], const float (&px)[kTiles][2],
    const float (&py)[kTiles][2], float (&v)[kTiles / 2]) {
  const float4* lr = reinterpret_cast<const float4*>(lr_);
  const float4* tr = reinterpret_cast<const float4*>(tr_);
  const float4 T0 = tr[0], T1 = tr[1], T2 = tr[2];
  float4 bw[KS];
#pragma unroll
  for (int s = 0; s < KS; ++s) bw[s] = lr[s];
  const float4 bw2 = lr[KS];
  float res[2 * kTiles];  // row r = 2 tt + h: tile tt's row g + 8 h, pixel 8 r + g
#pragma unroll
  for (int tt = 0; tt < kTiles; ++tt) {
    // accumulator (rows g, g + 8; columns 2t, 2t + 1 = channels t, t + 4)
    float d[4];
    d[0] = fmaf(T1.x, py[tt][0], fmaf(T0.z, px[tt][0], T0.x));
    d[1] = fmaf(T1.y, py[tt][0], fmaf(T0.w, px[tt][0], T0.y));
    d[2] = fmaf(T1.x, py[tt][1], fmaf(T0.z, px[tt][1], T0.x));
    d[3] = fmaf(T1.y, py[tt][1], fmaf(T0.w, px[tt][1], T0.y));
#pragma unroll
    for (int s = 0; s < KS; ++s) mma3(d, ahi[tt][s], alo[tt][s], bw[s]);
    // the accumulator as stage 2's A fragment: (g, t), (g+8, t), (g, t+4),
    // (g+8, t+4)
    uint32_t hi[4], lo[4];
    split_fast(fmaxf(d[0], 0.f), hi[0], lo[0]);
    split_fast(fmaxf(d[2], 0.f), hi[1], lo[1]);
    split_fast(fmaxf(d[1], 0.f), hi[2], lo[2]);
    split_fast(fmaxf(d[3], 0.f), hi[3], lo[3]);
    float e[4] = {T1.z, T1.w, T1.z, T1.w};  // b2 of channels 2t, 2t + 1
    mma3(e, hi, lo, bw2);
    res[2 * tt] = fmaf(T2.y, fmaxf(e[1], 0.f), T2.x * fmaxf(e[0], 0.f));
    res[2 * tt + 1] = fmaf(T2.y, fmaxf(e[3], 0.f), T2.x * fmaxf(e[2], 0.f));
  }
  // sum each row over the quad, transposing: each step keeps half the
  // rows and sends the other half, so lane t ends with the rows r = 4 j + t
  const bool o1 = t & 1, o2 = t & 2;
  float a[kTiles];  // a[i]: row 2 i + o1
#pragma unroll
  for (int i = 0; i < kTiles; ++i)
    a[i] = (o1 ? res[2 * i + 1] : res[2 * i]) +
           __shfl_xor_sync(0xffffffffu, o1 ? res[2 * i] : res[2 * i + 1], 1);
#pragma unroll
  for (int j = 0; j < kTiles / 2; ++j)
    v[j] = (o2 ? a[2 * j + 1] : a[2 * j]) +
           __shfl_xor_sync(0xffffffffu, o2 ? a[2 * j] : a[2 * j + 1], 2) + T2.z;
}

template <int KS>
__global__ void __launch_bounds__(kThreads, 2)
render_kernel(const float* __restrict__ feats, const float* __restrict__ rec_g,
              float* __restrict__ out, int Q, int Hm, int Wm, int Cm, int stride) {
  constexpr int kQRec = Rec<KS>::kQuery;
  __shared__ __align__(16) float rec[kBufs][kQC * kQRec];

  const int b = blockIdx.y, HW = Hm * Wm;
  const int tid = threadIdx.x, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int p0 = blockIdx.x * kPixels + (tid >> 5) * 16 * kTiles;  // the warp's pixels

  auto stage = [&](int c) {
    const int nq = min(kQC, Q - c * kQC);
    async_copy::copy_floats(rec[c % kBufs], rec_g + ((int64_t)b * Q + c * kQC) * kQRec,
                            nq * kQRec, tid, kThreads);
  };
  const int n_chunks = (Q + kQC - 1) / kQC;
  stage(0);
  async_copy::commit();

  // A fragments of the warp's feature rows, reused by every query: register
  // i of tile tt holds row 16 tt + g + 8 (i & 1), column t + 4 (i >> 1) of
  // each k-step; px, py the pixel centres of rows g and g + 8
  uint32_t ahi[kTiles][KS][4], alo[kTiles][KS][4];
  float px[kTiles][2], py[kTiles][2];
  const float* fb = feats + (int64_t)b * HW * Cm;
#pragma unroll
  for (int tt = 0; tt < kTiles; ++tt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = p0 + 16 * tt + 8 * h + g;
      const int i = n / Wm, j = n - (n / Wm) * Wm;
      px[tt][h] = (float)(j * stride + stride / 2);
      py[tt][h] = (float)(i * stride + stride / 2);
#pragma unroll
      for (int s = 0; s < KS; ++s) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int k = 8 * s + t + 4 * c;
          const float v = (n < HW && k < Cm) ? __ldg(fb + n * Cm + k) : 0.f;
          split(v, ahi[tt][s][h + 2 * c], alo[tt][s][h + 2 * c]);
        }
      }
    }
  }

  const int lofs = lane * Rec<KS>::kLane, tofs = 32 * Rec<KS>::kLane + t * kTRec;
  const int left = HW - (p0 + 8 * t + g);  // store v[j] where 32 j < left
  float* orow = out + (int64_t)b * Q * HW + p0 + 8 * t + g;
  for (int c = 0; c < n_chunks; ++c, orow += (int64_t)kQC * HW) {
    // the chunk after next goes into the buffer read two chunks ago, which
    // every warp left before the barrier of the previous iteration
    if (c + 1 < n_chunks) stage(c + 1);
    async_copy::commit();
    async_copy::wait<1>();
    __syncthreads();
    const float* rc = rec[c % kBufs];
    const int nq = min(kQC, Q - c * kQC);
    if (nq == kQC) {
#pragma unroll
      for (int q = 0; q < kQC; ++q) {  // unrolled: record offsets are immediates
        const float* r0 = rc + q * kQRec;
        float v[kTiles / 2];
        render_query<KS>(r0 + lofs, r0 + tofs, t, ahi, alo, px, py, v);
#pragma unroll
        for (int j = 0; j < kTiles / 2; ++j)
          if (32 * j < left) orow[(int64_t)q * HW + 32 * j] = v[j];
      }
    } else {
      for (int q = 0; q < nq; ++q) {
        const float* r0 = rc + q * kQRec;
        float v[kTiles / 2];
        render_query<KS>(r0 + lofs, r0 + tofs, t, ahi, alo, px, py, v);
#pragma unroll
        for (int j = 0; j < kTiles / 2; ++j)
          if (32 * j < left) orow[(int64_t)q * HW + 32 * j] = v[j];
      }
    }
  }
}

template <int KS>
int launch(const void* feats, const void* inst_xy, const void* w1, const void* w2,
           const void* w3, const void* b1, const void* b2, const void* b3,
           void* records, void* out, int B, int Q, int Hm, int Wm, int Cm, int rel,
           int stride, cudaStream_t s) {
  const int n_bq = B * Q;
  render_records_kernel<KS><<<(n_bq * 36 + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(inst_xy), static_cast<const float*>(w1),
      static_cast<const float*>(w2), static_cast<const float*>(w3),
      static_cast<const float*>(b1), static_cast<const float*>(b2),
      static_cast<const float*>(b3), static_cast<float*>(records), n_bq, Cm, rel);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Hm * Wm + kPixels - 1) / kPixels, B);
  render_kernel<KS><<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(feats), static_cast<const float*>(records),
      static_cast<float*>(out), Q, Hm, Wm, Cm, stride);
  return (int)cudaGetLastError();
}

}  // namespace

// floats of the records scratch buffer for (B, Q, Cm); 0 when Cm is refused
extern "C" long long pctrans_render_records_floats(int B, int Q, int Cm) {
  if (Cm < 1 || Cm > kMaxCm) return 0;
  return (long long)B * Q * (Cm <= 8 ? Rec<1>::kQuery : Rec<2>::kQuery);
}

extern "C" int pctrans_render_fwd(const void* feats, const void* inst_xy,
                                  const void* w1, const void* w2,
                                  const void* w3, const void* b1,
                                  const void* b2, const void* b3, void* records,
                                  void* out, int B, int Q, int Hm, int Wm, int Cm,
                                  int rel_coord, int stride, void* stream) {
  if (B <= 0 || Q <= 0 || Hm <= 0 || Wm <= 0) return (int)cudaSuccess;
  if (B > 65535 || Cm < 1 || Cm > kMaxCm || (int64_t)Hm * Wm * Cm >= INT_MAX ||
      (int64_t)B * Q * 36 >= INT_MAX || reinterpret_cast<uintptr_t>(records) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Cm <= 8)
    return launch<1>(feats, inst_xy, w1, w2, w3, b1, b2, b3, records, out, B, Q, Hm,
                     Wm, Cm, rel_coord, stride, s);
  return launch<2>(feats, inst_xy, w1, w2, w3, b1, b2, b3, records, out, B, Q, Hm, Wm,
                   Cm, rel_coord, stride, s);
}
