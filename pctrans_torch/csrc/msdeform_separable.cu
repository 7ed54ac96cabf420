// K5: multi-scale deformable attention, forward, separable form.
//
// Replaces the TPU kernel pctrans_tpu/ops/msdeform_pallas.py:_level_kernel,
// which splits bilinear sampling into its separable factors per (batch*head,
// 128-query chunk, level): stage 1 contracts the level's value map over the
// W axis against hat_x (t = hat_x[CH, W] @ V^T[W, D*H] on the MXU, hat_x
// rounded to the value dtype first), stage 2 reduces t over H against
// hat_y * w in f32.  The hats relu(1 - |s - p|) are dense rows: every pixel
// of the level enters both stages, with weight 0 away from the sample.
//
// Bound: bytes.  The work the inputs need is K1's (four corners per
// sample): at the CVPPP eval shape (B=4, Lq=S=5581, M=8, P=4, levels 17x16,
// 34x32, 67x63, D=16, bf16 value) 37.1 MB, 11.09 us at 3.35 TB/s.  The dense
// contraction the TPU kernel runs is 2 * sum_l H_l W_l D = 178,592 FLOP per
// (b, m, q, p) row, 1.276e11 FLOP per call: 0.129 ms at the 989 TFLOP/s bf16
// tensor-core rate, 1.9 ms as f32 FMAs on the CUDA cores.
//
// Design:
//   - stage 1 on the tensor cores: mma.sync m16n8k16 bf16 with f32
//     accumulation for bf16 values (A = hat_x rounded to bf16, exactly the
//     TPU kernel's hx.astype(v.dtype)); m16n8k8 3xTF32 for f32 values
//     (a_lo b_hi + a_hi b_lo + a_hi b_hi, f32 accuracy).  The m16 rows of a
//     tile are 16 consecutive queries at one point p: neighbouring queries
//     at one offset direction sample neighbouring pixels, so the tile's
//     hats cover few rows and columns of the map;
//   - A fragments are built in registers from the queries' x, for up to KC
//     16-column K tiles at once (4 bf16, 2 for D = 32; 1 in f32), and
//     reused for every row h of the map;
//   - the value map sits in shared memory in the value dtype, transposed to
//     [h][d][x] (x contiguous, so a B fragment register is one 32-bit word;
//     rows padded to whole 16-column tiles with zeros, plus 4 words so that
//     the 8 x 4 fragment reads of a warp hit 32 banks).  The host plans
//     passes (msdeform.separable_plan): bands of rows that fit the block's
//     dynamic shared memory; the bf16 CVPPP maps (eval 210,944 B, train
//     175,616 B padded) take one pass, staged once per block with eight
//     16-byte loads in flight per thread.  f32 maps or wider ones take
//     several passes with an f32 partial in global memory between them
//     (the f32 output itself, or a scratch for bf16);
//   - blocks are persistent over the 16-query tiles of one (b, m), a wave
//     of blocks side by side; a warp takes its next tile from a shared
//     counter.  Each lane loads 2 of the 64 (query, point) samples of a
//     tile's level, one step ahead of their use, and converts them to
//     pixel coordinates; shuffles hand each lane its rows g and g + 8;
//   - stage 2 fused on the accumulator fragments: each row's t[h, d] times
//     its hat_y(h) * w in f32, summed over h, p and the levels in
//     registers, stored once in the value dtype;
//   - exact-zero tiles are skipped: a row h where hat_y is zero for all 16
//     rows of the tile (vote), and a K tile where hat_x is zero for all of
//     them.  For finite values this leaves out exactly zeros, so the sum is
//     the dense contraction's; a NaN or Inf in the value map poisons fewer
//     outputs than the TPU kernel's dense product does (only those whose
//     hats reach it).  A sample outside its map (or at a NaN location) has
//     zero hats, as in K1.
// Measured on an H100 80GB HBM3 (700 W; chip_smoke.py, PERF.md): 0.47 ms
// at the eval shape on uniformly random locations, where a tile's hats
// reach nearly every row and K tile (the dense CUDA-core form took 5.18 ms);
// 0.109 ms per launch on the locations the seeded model's eval forward
// gives it.  Both are bound by latency, not by the tensor cores: 16 warps
// per SM (the slab takes the SM's shared memory, the registers the rest)
// run chains of loads, votes, shared reads and products, and on the
// model's inputs a (tile, point, level) needs ~2 products.
//
// Contract (pctrans_tpu/ops/msdeform.py:1-18): value [B, S, M, D] f32 or
// bf16 with D in {8, 16, 32}, 16-byte aligned; loc [B, Lq, M, L, P, 2] f32
// normalised (x, y); w [B, Lq, M, L, P] f32; out [B, Lq, M*D] in the value
// dtype.  Pixel position = loc * size - 0.5; pixels outside the map
// contribute zero.

#include <limits.h>

#include "msdeform_common.cuh"

using namespace msdeform;

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxPasses = 16;
constexpr int kMaxSegments = 32;
constexpr unsigned kAll = 0xffffffffu;

// The host's pass plan: segment i stages rows [h0, h1) of level `level` at
// element offset `off` of the shared slab; pass j holds segments
// [first[j], first[j + 1]).
struct Plan {
  int n_pass;
  int first[kMaxPasses + 1];
  int level[kMaxSegments], h0[kMaxSegments], h1[kMaxSegments], off[kMaxSegments];
};

template <typename T>
struct Layout;
template <>
struct Layout<__nv_bfloat16> {
  static constexpr int kPad = 8;  // elements past the 16-column tiles
  static constexpr int kVec = 8;  // elements per 16-byte load
  static constexpr int kKC = 4;   // K tiles whose A fragments are held at once (D <= 16)
};
template <>
struct Layout<float> {
  static constexpr int kPad = 4;
  static constexpr int kVec = 4;
  static constexpr int kKC = 1;
};

__host__ __device__ __forceinline__ int tiles16(int w) { return (w + 15) >> 4; }

template <typename T>
__device__ __forceinline__ int row_stride(int W) {
  return 16 * tiles16(W) + Layout<T>::kPad;
}

__device__ __forceinline__ float hat(float x, int s, int W) {
  return s < W ? fmaxf(0.f, 1.f - fabsf(x - (float)s)) : 0.f;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragments of one 16-column K tile (columns c0 .. c0 + 15) for the rows
// g (x = xa) and g + 8 (x = xb) of lane (g, t).  bf16: one m16n8k16
// fragment; f32: two m16n8k8 steps, TF32 hi and lo.
template <typename T>
struct AFrag;

template <>
struct AFrag<__nv_bfloat16> {
  uint32_t a[4];
  __device__ __forceinline__ void build(float xa, float xb, int c0, int t, int W) {
    const int c = c0 + 2 * t;
    a[0] = pack_bf16(hat(xa, c, W), hat(xa, c + 1, W));
    a[1] = pack_bf16(hat(xb, c, W), hat(xb, c + 1, W));
    a[2] = pack_bf16(hat(xa, c + 8, W), hat(xa, c + 9, W));
    a[3] = pack_bf16(hat(xb, c + 8, W), hat(xb, c + 9, W));
  }
  __device__ __forceinline__ bool nonzero() const { return (a[0] | a[1] | a[2] | a[3]) != 0u; }
  // c += hat_x tile @ V tile; vrow: the slab row [d = 8 nt + g][x] as words
  __device__ __forceinline__ void mma(float (&c)[4], const __nv_bfloat16* vrow, int c0,
                                      int t) const {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(vrow + c0) + t;
    mma_bf16(c, a, w[0], w[4]);
  }
};

template <>
struct AFrag<float> {
  uint32_t hi[2][4], lo[2][4];
  __device__ __forceinline__ void build(float xa, float xb, int c0, int t, int W) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int c = c0 + 8 * s + t;
      split(hat(xa, c, W), hi[s][0], lo[s][0]);
      split(hat(xb, c, W), hi[s][1], lo[s][1]);
      split(hat(xa, c + 4, W), hi[s][2], lo[s][2]);
      split(hat(xb, c + 4, W), hi[s][3], lo[s][3]);
    }
  }
  __device__ __forceinline__ bool nonzero() const {
    uint32_t r = 0;
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int i = 0; i < 4; ++i) r |= hi[s][i] | lo[s][i];
    return r != 0u;
  }
  __device__ __forceinline__ void mma(float (&c)[4], const float* vrow, int c0, int t) const {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const float* v = vrow + c0 + 8 * s + t;
      uint32_t bh0, bl0, bh1, bl1;
      split(v[0], bh0, bl0);
      split(v[4], bh1, bl1);
      mma_tf32(c, lo[s], bh0, bh1);  // small terms first
      mma_tf32(c, hi[s], bl0, bl1);
      mma_tf32(c, hi[s], bh0, bh1);
    }
  }
};

// Rows [h0, h1) of a level of width W into the slab at `dst`: `value`
// points at the head's channels, `base` is the level's first position in
// the batch's map.  Staged as [h - h0][d][x] with row_stride<T>(W)
// elements per (h, d) and zeros in the columns W .. 16 * tiles16(W) - 1.
// Each thread has eight 16-byte loads in flight before it stores.
template <typename T, int D>
__device__ void stage_rows(T* dst, const T* __restrict__ value, int64_t base, int M,
                           int W, int h0, int h1) {
  constexpr int V = Layout<T>::kVec, U = 8;
  const int stride = row_stride<T>(W);
  const int n = (h1 - h0) * W * (D / V);
  for (int i0 = threadIdx.x; i0 < n; i0 += U * kThreads) {
    uint4 raw[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * kThreads, pos = i / (D / V);
      if (i < n)
        raw[u] = __ldg(reinterpret_cast<const uint4*>(
            value + (base + (int64_t)h0 * W + pos) * M * D + (i % (D / V)) * V));
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * kThreads;
      if (i >= n) break;
      const int pos = i / (D / V), hh = pos / W, x = pos - hh * W;
      const T* e = reinterpret_cast<const T*>(&raw[u]);
      T* o = dst + (hh * D + (i % (D / V)) * V) * stride + x;
#pragma unroll
      for (int j = 0; j < V; ++j) o[j * stride] = e[j];
    }
  }
  const int pad = 16 * tiles16(W) - W;
  for (int i = threadIdx.x; i < (h1 - h0) * D * pad; i += kThreads) {
    const int r = i / pad;
    store_f32(dst + r * stride + W + (i - r * pad), 0.f);
  }
}

// One step of a warp's walk over its work: a 16-query tile, a segment of
// the pass and a group of up to 4 points.
struct Step {
  int tile, sg, p0;
};

// The raw samples of a step for lane (r, pp) = (lane & 15, lane >> 4):
// query 16 tile + r at points p0 + pp and p0 + pp + 2, NaN where the query
// or the point does not exist.  The loads of the next step are issued
// before the current one computes.
struct Raw {
  float2 c[2];
  float w[2];
};

__device__ __forceinline__ Raw load_step(const float* __restrict__ loc,
                                         const float* __restrict__ attw, const Step& st,
                                         const Plan& plan, int b, int m, int M, int Lq,
                                         int L, int P, int lane) {
  Raw raw;
  const int q = 16 * st.tile + (lane & 15);
  const int64_t row = (((int64_t)b * Lq + q) * M + m) * L + plan.level[st.sg];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int p = st.p0 + (lane >> 4) + 2 * k;
    raw.c[k] = make_float2(__int_as_float(0x7fc00000), 0.f);
    raw.w[k] = 0.f;
    if (q < Lq && p < P) {
      raw.c[k] = __ldg(reinterpret_cast<const float2*>(loc) + row * P + p);
      raw.w[k] = __ldg(attw + row * P + p);
    }
  }
  return raw;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
msdeform_sep_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                    const float* __restrict__ attw, T* out,
                    float* part, int S, int M, int Lq, int L, int P,
                    Levels lv, Plan plan) {
  constexpr int NT = D / 8;  // n8 tiles of a head's channels
  // K tiles per chunk: fewer for D = 32, whose accumulators take the registers
  constexpr int KC = D > 16 && Layout<T>::kKC > 1 ? Layout<T>::kKC / 2 : Layout<T>::kKC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* slab = reinterpret_cast<T*>(smem_raw);

  const int bm = blockIdx.y;
  const int b = bm / M, m = bm - (bm / M) * M;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n_tiles = (Lq + 15) >> 4;
  // the block's tiles are blockIdx.x + gridDim.x * k; warps take the next
  // k from a shared counter as they finish one
  __shared__ int next_k;

  for (int pass = 0; pass < plan.n_pass; ++pass) {
    const int s0 = plan.first[pass], s1 = plan.first[pass + 1];
    __syncthreads();  // the previous pass's reads are done
    for (int sg = s0; sg < s1; ++sg) {
      const int l = plan.level[sg];
      stage_rows<T, D>(slab + plan.off[sg], value + m * D, (int64_t)b * S + lv.start[l], M,
                       lv.w[l], plan.h0[sg], plan.h1[sg]);
    }
    if (threadIdx.x == 0) next_k = kWarps;
    __syncthreads();
    const bool first = pass == 0, last = pass + 1 == plan.n_pass;

    // the warp walks (tile, segment, point group) steps in order
    auto next = [&](Step st) {
      if (st.p0 + 4 < P) return Step{st.tile, st.sg, st.p0 + 4};
      if (st.sg + 1 < s1) return Step{st.tile, st.sg + 1, 0};
      int k = 0;
      if (lane == 0) k = atomicAdd(&next_k, 1);
      return Step{(int)blockIdx.x + (int)gridDim.x * __shfl_sync(kAll, k, 0), s0, 0};
    };
    Step st{(int)blockIdx.x + (int)gridDim.x * warp, s0, 0};
    Raw nraw;
    if (st.tile < n_tiles) nraw = load_step(loc, attw, st, plan, b, m, M, Lq, L, P, lane);
    float acc[NT][4];
    while (st.tile < n_tiles) {
      const int qa = 16 * st.tile + g, qb = qa + 8;
      const int64_t ra = ((int64_t)b * Lq + qa) * M + m;  // (b, q, m) rows
      const int64_t rb = ra + 8 * (int64_t)M;
      if (st.sg == s0 && st.p0 == 0) {  // a new tile
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
          if (!first) {
            const int d = 8 * nt + 2 * t;
            if (qa < Lq) {
              const float2 v = *reinterpret_cast<const float2*>(part + ra * D + d);
              acc[nt][0] = v.x, acc[nt][1] = v.y;
            }
            if (qb < Lq) {
              const float2 v = *reinterpret_cast<const float2*>(part + rb * D + d);
              acc[nt][2] = v.x, acc[nt][3] = v.y;
            }
          }
        }
      }
      const Raw raw = nraw;
      const Step nst = next(st);
      if (nst.tile < n_tiles) nraw = load_step(loc, attw, nst, plan, b, m, M, Lq, L, P, lane);

      const int l = plan.level[st.sg], h0 = plan.h0[st.sg], h1 = plan.h1[st.sg];
      const int H = lv.h[l], W = lv.w[l];
      const int stride = row_stride<T>(W);
      const T* seg = slab + plan.off[st.sg];
      // this lane's two samples as pixel coordinates; a sample outside its
      // map (or NaN) moves to -4, where every hat is zero.  __fmul_rn: no
      // FMA contraction, so x rounds as the twins' loc * W - 0.5 does
      float sx[2], sy[2], sw[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const float x = __fmul_rn(raw.c[k].x, (float)W) - 0.5f;
        const float y = __fmul_rn(raw.c[k].y, (float)H) - 0.5f;
        const bool in = x > -1.f && x < (float)W && y > -1.f && y < (float)H;
        sx[k] = in ? x : -4.f, sy[k] = in ? y : -4.f, sw[k] = in ? raw.w[k] : 0.f;
      }
      for (int pc = 0; pc < min(4, P - st.p0); ++pc) {
        // rows g and g + 8 of point p0 + pc from the lanes that loaded them
        const int k = pc >> 1, src = g + 16 * (pc & 1);
        const float vx = k ? sx[1] : sx[0], vy = k ? sy[1] : sy[0], vw = k ? sw[1] : sw[0];
        const float xa = __shfl_sync(kAll, vx, src), xb = __shfl_sync(kAll, vx, src + 8);
        const float ya = __shfl_sync(kAll, vy, src), yb = __shfl_sync(kAll, vy, src + 8);
        const float wa = __shfl_sync(kAll, vw, src), wb = __shfl_sync(kAll, vw, src + 8);
        // the tile's rows of the segment and columns of the map: the
        // union of the rows' hat supports {floor, floor + 1}
        int hlo = INT_MAX, hhi = -1, clo = INT_MAX, chi = -1;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float x = r ? xb : xa, y = r ? yb : ya;
          if (x == -4.f) continue;
          const int fy = (int)floorf(y), fx = (int)floorf(x);
          const int lo = max(fy, h0), hi = min(fy + 1, h1 - 1);
          if (lo > hi) continue;
          hlo = min(hlo, lo), hhi = max(hhi, hi);
          clo = min(clo, max(fx, 0)), chi = max(chi, min(fx + 1, W - 1));
        }
        hlo = __reduce_min_sync(kAll, hlo);
        hhi = __reduce_max_sync(kAll, hhi);
        clo = __reduce_min_sync(kAll, clo);
        chi = __reduce_max_sync(kAll, chi);
        if (hlo > hhi) continue;  // no row of the tile reaches the segment
        for (int k0 = clo >> 4; k0 <= (chi >> 4); k0 += KC) {
          AFrag<T> a[KC];
          unsigned kmask = 0;
#pragma unroll
          for (int j = 0; j < KC; ++j) {
            if (k0 + j > (chi >> 4)) break;  // past the tile's columns: zeros
            a[j].build(xa, xb, 16 * (k0 + j), t, W);
            if (__any_sync(kAll, a[j].nonzero())) kmask |= 1u << j;
          }
          for (int h = hlo; h <= hhi; ++h) {
            const float hya = fmaxf(0.f, 1.f - fabsf(ya - (float)h));
            const float hyb = fmaxf(0.f, 1.f - fabsf(yb - (float)h));
            if (!__any_sync(kAll, hya != 0.f || hyb != 0.f)) continue;
            const float fa = hya * wa, fb = hyb * wb;
            const T* vh = seg + (h - h0) * D * stride;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              const T* vrow = vh + (8 * nt + g) * stride;
              float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
              for (int j = 0; j < KC; ++j)
                if (kmask >> j & 1u) a[j].mma(c, vrow, 16 * (k0 + j), t);
              acc[nt][0] = fmaf(fa, c[0], acc[nt][0]);
              acc[nt][1] = fmaf(fa, c[1], acc[nt][1]);
              acc[nt][2] = fmaf(fb, c[2], acc[nt][2]);
              acc[nt][3] = fmaf(fb, c[3], acc[nt][3]);
            }
          }
        }
      }

      if (nst.tile != st.tile) {  // the tile is done
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int d = 8 * nt + 2 * t;
          if (last) {
            if (qa < Lq) {
              store_f32(out + ra * D + d, acc[nt][0]);
              store_f32(out + ra * D + d + 1, acc[nt][1]);
            }
            if (qb < Lq) {
              store_f32(out + rb * D + d, acc[nt][2]);
              store_f32(out + rb * D + d + 1, acc[nt][3]);
            }
          } else {
            if (qa < Lq)
              *reinterpret_cast<float2*>(part + ra * D + d) = make_float2(acc[nt][0], acc[nt][1]);
            if (qb < Lq)
              *reinterpret_cast<float2*>(part + rb * D + d) = make_float2(acc[nt][2], acc[nt][3]);
          }
        }
      }
      st = nst;
    }
  }
}

template <typename T, int D>
int launch_d(const void* value, const void* loc, const void* attw, void* out, void* part,
             int B, int S, int M, int Lq, int L, int P, const Levels& lv, const Plan& plan,
             int smem, cudaStream_t s) {
  auto kernel = msdeform_sep_kernel<T, D>;
  int blocks = 0;
  const cudaError_t e = resident_blocks(kernel, kThreads, (size_t)smem, &blocks);
  if (e != cudaSuccess) return (int)e;
  // a grid of about one wave: the (b, m) heads side by side, each split
  // over as many blocks as the wave leaves it
  const int n_tiles = (Lq + 15) / 16;
  const int split = max(1, min(blocks / (B * M), (n_tiles + kWarps - 1) / kWarps));
  kernel<<<dim3(split, B * M), kThreads, smem, s>>>(
      static_cast<const T*>(value), static_cast<const float*>(loc),
      static_cast<const float*>(attw), static_cast<T*>(out), static_cast<float*>(part), S,
      M, Lq, L, P, lv, plan);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* value, const void* loc, const void* attw, void* out, void* part,
           int B, int S, int M, int D, int Lq, int L, int P, const Levels& lv,
           const Plan& plan, int smem, cudaStream_t s) {
  switch (D) {
    case 8:
      return launch_d<T, 8>(value, loc, attw, out, part, B, S, M, Lq, L, P, lv, plan, smem, s);
    case 16:
      return launch_d<T, 16>(value, loc, attw, out, part, B, S, M, Lq, L, P, lv, plan, smem, s);
    case 32:
      return launch_d<T, 32>(value, loc, attw, out, part, B, S, M, Lq, L, P, lv, plan, smem, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// plan (host int[]): n_pass, first[0 .. n_pass], then n_seg = first[n_pass]
// segments of (level, h0, h1, off); smem: dynamic shared bytes of the
// largest pass.  part: f32 [B, Lq, M, D] scratch for the partial sums
// between passes of a bf16 value (f32 values use out; unused for one pass).
extern "C" int pctrans_msdeform_sep_fwd(const void* value, const void* loc,
                                        const void* attw, void* out, void* part, int B,
                                        int S, int M, int D, int Lq, int L, int P,
                                        const int* shapes, const int* plan_in, int smem,
                                        int is_bf16, void* stream) {
  Levels lv;
  if (!make_levels(shapes, L, S, &lv)) return (int)cudaErrorInvalidValue;
  Plan plan;
  plan.n_pass = plan_in[0];
  if (plan.n_pass < 1 || plan.n_pass > kMaxPasses) return (int)cudaErrorInvalidValue;
  for (int i = 0; i <= plan.n_pass; ++i) plan.first[i] = plan_in[1 + i];
  const int n_seg = plan.first[plan.n_pass];
  if (plan.first[0] != 0 || n_seg < 1 || n_seg > kMaxSegments) return (int)cudaErrorInvalidValue;
  const int* sg = plan_in + 2 + plan.n_pass;
  for (int i = 0; i < n_seg; ++i) {
    plan.level[i] = sg[4 * i], plan.h0[i] = sg[4 * i + 1];
    plan.h1[i] = sg[4 * i + 2], plan.off[i] = sg[4 * i + 3];
    if (plan.level[i] < 0 || plan.level[i] >= L || plan.h0[i] < 0 ||
        plan.h1[i] <= plan.h0[i] || plan.h1[i] > lv.h[plan.level[i]])
      return (int)cudaErrorInvalidValue;
  }
  if ((int64_t)B * M > 65535) return (int)cudaErrorInvalidValue;
  if (is_bf16 && plan.n_pass > 1 && part == nullptr) return (int)cudaErrorInvalidValue;
  if (B == 0 || M == 0 || Lq == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(value, loc, attw, out, part, B, S, M, D, Lq, L, P, lv, plan,
                                 smem, s);
  return launch<float>(value, loc, attw, out, part ? part : out, B, S, M, D, Lq, L, P, lv,
                       plan, smem, s);
}
