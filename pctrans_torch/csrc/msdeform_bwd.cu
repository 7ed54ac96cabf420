// K2: multi-scale deformable attention, backward (direct scatter).
//
// Replaces the TPU kernel pctrans_tpu/ops/msdeform_pallas2.py:_level_bwd_kernel
// (per (batch*head) slab, hat matrices on the MXU, d_value accumulated in
// VMEM, deterministic).  On Hopper the backward of a gather is a scatter.
//
// What bounds it: the scatter into d_value, then the corner gathers.  At
// the CVPPP train shape (B=2, Lq=S=4116, M=8, D=16, L=3, P=4, bf16 value)
// the function reads value, loc, w and grad once (13.4 MB) and writes the
// f32 d_value, d_loc and d_w once (13.7 MB): 27.4 MB, 8.2 us at 3.35 TB/s.
// Every inside sample adds w * corner weight * grad into the f32 d_value at
// 4 corners x D channels (50.6M channel adds per launch onto 4.2 MB, held
// in L2), and L2 serves a reduction per 128-byte line a warp touches: one
// line per (query, head, corner) at D = 16, wherever the locations fall.
// The 14x14 level takes ~84 samples per position per (batch, head), and
// neighbouring queries sample the same coarse cells, so its adds collide.
//
// Design (the first K2 ran one thread per channel: the 16 lanes of a
// head loaded the same loc and w, redid the same corner arithmetic, made
// three 16-lane shuffle reductions per sample and one scalar f32 atomic per
// channel and corner):
//   - one thread per (b, q, head, 4 channels): every corner is one 16-byte
//     (f32) or 8-byte (bf16) load and one 4-channel vector reduction,
//     atomicAdd(float4*) (REDG.E.ADD.F32 on sm_90: no value returned), and
//     the d_w, d_x and d_y sums over the head's channels reduce over D / 4
//     lanes.  Four channels per thread in bf16 too: with 8 (one 16-byte
//     load) a thread issues two reductions per corner and a warp touches
//     twice the lines per reduction, which ran slower;
//   - a block owns one (b, head) and a run of query tiles (256 / (D / 4)
//     queries each); their loc and w rows are staged into shared memory by
//     cp.async, the next tile's while this one computes; results go to a
//     shared tile of the same layout and out as whole rows;
//   - branch-free samples, as in K1: corner indices clamped into the map,
//     validity from float compares, loads and reductions predicated on it,
//     the reach test (which also rejects NaN) and the hat-derivative tests
//     as selects; (L, P) = (3, 4), the recipe, is a template instance with
//     both loops unrolled, so a thread's gathers can be in flight together;
//   - on the levels named in `agg_mask` (the wrapper's plan: those with at
//     least 32 samples per position on average, the 14x14 level of the
//     recipe) the lanes of a warp that hit the same corner first sum their
//     adds (__match_any_sync, then shuffles from each peer) and one of them
//     issues the reduction: neighbouring queries share coarse cells, so this
//     cuts the lines L2 must serve where the adds collide, at the price of a
//     match per corner where they do not;
//   - no shared-memory accumulation of d_value: a per-block slab of the
//     coarse levels, flushed once per block, was slower on every input,
//     contention included, because sm_90 has no shared-memory f32 add (an
//     atomicAdd on shared f32 compiles to a compare-and-swap loop,
//     ATOMS.CAST.SPIN);
//   - __launch_bounds__(256, 4): 64 registers, 32 warps per SM.
//
// Derivative convention (msdeform_pallas2.py:138-144): the bilinear weights
// are hats relu(1 - |s - p|) and their location derivative is sign(s - p) on
// the open support.  For tx = x - floor(x) > 0 that is the usual
// v(x0+1) - v(x0); at an exactly integral x (tx == 0) it is zero, where
// grid_sample's backward would still take the floor difference.  The same
// holds for y.  The chain rule through x = loc * W - 0.5 multiplies by W.
// Samples outside the map, and NaN samples, contribute zero.
//
// Not deterministic: the reductions add in a different order on every run,
// so d_value differs from run to run by f32 rounding (the TPU kernel is
// deterministic).  d_loc and d_w have one writer each.
//
// Contract: value [B, S, M, D] (f32 or bf16) with D / 4 a power of two <=
// 32; loc [B, Lq, M, L, P, 2] f32; w [B, Lq, M, L, P] f32; grad [B, Lq, M*D]
// in the value dtype; all 16-byte aligned.  Outputs: d_value [B, S, M, D]
// f32 (zeroed by the caller), d_loc like loc, d_w like w (f32, every element
// written).  The entry point refuses what the kernel does not take with
// cudaErrorInvalidValue; nothing falls back.

#include <limits.h>

#include <initializer_list>

#include "async_copy.cuh"
#include "msdeform_common.cuh"

using namespace msdeform;

namespace {

constexpr int kThreads = 256;
constexpr int kV = 4;               // channels per thread: one float4 reduction per corner
constexpr int kSmemLimit = 232448;  // bytes of shared memory a block may use

// 4 channels at p as f32 (16 bytes of f32 or 8 of bf16, aligned); zeros
// when !ok.  A bf16 32-bit word holds channels 2i (low half) and 2i + 1.
__device__ __forceinline__ void load4(const float* p, bool ok, float* v) {
  const uint4 r = ok ? __ldg(reinterpret_cast<const uint4*>(p)) : make_uint4(0u, 0u, 0u, 0u);
  v[0] = __uint_as_float(r.x);
  v[1] = __uint_as_float(r.y);
  v[2] = __uint_as_float(r.z);
  v[3] = __uint_as_float(r.w);
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, bool ok, float* v) {
  const uint2 r = ok ? __ldg(reinterpret_cast<const uint2*>(p)) : make_uint2(0u, 0u);
  v[0] = __uint_as_float(r.x << 16);
  v[1] = __uint_as_float(r.x & 0xffff0000u);
  v[2] = __uint_as_float(r.y << 16);
  v[3] = __uint_as_float(r.y & 0xffff0000u);
}

// p[0..3] += f * g[0..3] in global memory: one vector reduction
// (atomicAdd(float4*) compiles to REDG.E.ADD.F32 on sm_90, no return value)
__device__ __forceinline__ void red_add4(float* p, float f, const float* g) {
  atomicAdd(reinterpret_cast<float4*>(p), make_float4(f * g[0], f * g[1], f * g[2], f * g[3]));
}

// p[0..3] += f * g[0..3] summed over the lanes of the warp with the same
// key: one reduction per key, issued by the lowest of those lanes.  Every
// lane of the warp calls it; a lane with !ok takes no part.
__device__ __forceinline__ void red_add4_aggregated(float* p, bool ok, int key, float f,
                                                    const float* g) {
  const int lane = threadIdx.x & 31;
  const unsigned peers = __match_any_sync(0xffffffffu, ok ? key : -1 - lane);
  const float v[4] = {f * g[0], f * g[1], f * g[2], f * g[3]};
  float s[4] = {v[0], v[1], v[2], v[3]};
  unsigned rest = peers & ~(1u << lane);
  const int rounds = (int)__reduce_max_sync(0xffffffffu, (unsigned)__popc(rest));
  for (int r = 0; r < rounds; ++r) {
    const int src = rest ? __ffs(rest) - 1 : lane;
    rest &= rest - 1;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float o = __shfl_sync(0xffffffffu, v[c], src);
      if (src != lane) s[c] += o;
    }
  }
  if (ok && lane == __ffs(peers) - 1)
    atomicAdd(reinterpret_cast<float4*>(p), make_float4(s[0], s[1], s[2], s[3]));
}

// sum over the aligned group of `width` lanes (a power of two <= 32); every
// lane of the warp takes part
__device__ __forceinline__ float group_sum(float v, int width) {
  for (int off = width >> 1; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// rows of `row_floats` floats, packed back to back in shared memory, to
// global rows `dst_stride` floats apart: 16-byte stores when both are
// multiples of 4
__device__ __forceinline__ void store_rows(float* dst, const float* src, int rows,
                                           int row_floats, int dst_stride, int tid,
                                           int nthreads) {
  if ((row_floats & 3) == 0 && (dst_stride & 3) == 0) {
    const int per = row_floats >> 2;
    for (int i = tid; i < rows * per; i += nthreads) {
      const int r = i / per, k = i - r * per;
      *reinterpret_cast<float4*>(dst + (int64_t)r * dst_stride + 4 * k) =
          *reinterpret_cast<const float4*>(src + r * row_floats + 4 * k);
    }
  } else {
    for (int i = tid; i < rows * row_floats; i += nthreads) {
      const int r = i / row_floats, k = i - r * row_floats;
      dst[(int64_t)r * dst_stride + k] = src[r * row_floats + k];
    }
  }
}

// kL = kP = 0: L and P at run time
template <typename T, int kL, int kP>
__global__ void __launch_bounds__(kThreads, 4)
msdeform_bwd_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                    const float* __restrict__ attw, const T* __restrict__ grad,
                    float* __restrict__ d_value, float* __restrict__ d_loc,
                    float* __restrict__ d_w, int Lq, int S, int M, int D, int L_rt,
                    int P_rt, int tq, int tiles_per_block, int agg_mask, Levels lv) {
  const int L = kL ? kL : L_rt, P = kP ? kP : P_rt;
  const int LP = L * P;
  const int groups = D / kV;                // lanes per (query, head)
  const int buf_floats = tq * LP * 3;       // loc (x, y) rows, then w rows
  const int n_tiles = (Lq + tq - 1) / tq;
  const int tile0 = blockIdx.x * tiles_per_block;
  const int tile_end = min(tile0 + tiles_per_block, n_tiles);
  const int m = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int qi = tid / groups, grp = tid - qi * groups;
  const int sstride = M * D;
  // two input buffers (this tile, the next), then this tile's results in
  // the same layout (d_loc rows, then d_w rows)
  extern __shared__ __align__(16) float smem[];
  float* s_out = smem + 2 * buf_floats;

  // loc and w rows of (b, q, m) are LP*2 and LP floats, M rows apart
  const int64_t row0 = (int64_t)b * Lq * M + m;
  auto stage = [&](int tile, int buf) {
    const int q0 = tile * tq, nq = min(tq, Lq - q0);
    float* s = smem + buf * buf_floats;
    async_copy::copy_rows(s, loc + (row0 + (int64_t)q0 * M) * LP * 2, nq, LP * 2,
                          M * LP * 2, tid, blockDim.x);
    async_copy::copy_rows(s + tq * LP * 2, attw + (row0 + (int64_t)q0 * M) * LP, nq,
                          LP, M * LP, tid, blockDim.x);
  };

  const T* vb = value + (int64_t)b * S * sstride + m * D + 4 * grp;
  float* dvb = d_value + (int64_t)b * S * sstride + m * D + 4 * grp;
  if (tile0 < tile_end) stage(tile0, 0);
  async_copy::commit();
  for (int tile = tile0, it = 0; tile < tile_end; ++tile, ++it) {
    if (tile + 1 < tile_end) stage(tile + 1, (it + 1) & 1);
    async_copy::commit();
    async_copy::wait<1>();
    __syncthreads();

    const int q0 = tile * tq, nq = min(tq, Lq - q0);
    const bool live = qi < nq;
    const float* s_in = smem + (it & 1) * buf_floats;
    const float* sl = s_in + qi * LP * 2;
    const float* sw = s_in + tq * LP * 2 + qi * LP;
    float* ol = s_out + qi * LP * 2;
    float* ow = s_out + tq * LP * 2 + qi * LP;
    float g[kV];
    load4(grad + ((row0 + (int64_t)(q0 + qi) * M) * D + 4 * grp), live, g);
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const int H = lv.h[l], W = lv.w[l];
      const float Wf = (float)W, Hf = (float)H;
      const T* vl = vb + lv.start[l] * sstride;
      float* dvl = dvb + lv.start[l] * sstride;
      const bool aggregate = (agg_mask >> l) & 1;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int lp = l * P + p;
        // __fmul_rn: no FMA contraction, so x rounds as the twin's
        // loc * W - 0.5 does and an integral coordinate stays integral
        const float x = __fmul_rn(sl[2 * lp], Wf) - 0.5f;
        const float y = __fmul_rn(sl[2 * lp + 1], Hf) - 0.5f;
        const float a = sw[lp];
        const float x0f = floorf(x), y0f = floorf(y);
        const float tx = x - x0f, ty = y - y0f;
        // a corner of the map is in reach (float compares: NaN gives false)
        const bool inside = live && x > -1.f && x < Wf && y > -1.f && y < Hf;
        const bool vx0 = x0f >= 0.f, vx1 = x0f < Wf - 1.f;
        const bool vy0 = y0f >= 0.f, vy1 = y0f < Hf - 1.f;
        // clamped corner indices, as in K1 (fmaxf maps NaN to -1)
        const int ix = (int)fminf(fmaxf(x0f, -1.f), Wf);
        const int iy = (int)fminf(fmaxf(y0f, -1.f), Hf);
        const int cx0 = min(max(ix, 0), W - 1), cx1 = min(ix + 1, W - 1);
        const int cy0 = min(max(iy, 0), H - 1), cy1 = min(iy + 1, H - 1);
        const bool ok[4] = {inside && vy0 && vx0, inside && vy0 && vx1,
                            inside && vy1 && vx0, inside && vy1 && vx1};
        const int pos[4] = {cy0 * W + cx0, cy0 * W + cx1, cy1 * W + cx0, cy1 * W + cx1};
        float v[4][kV];
#pragma unroll
        for (int k = 0; k < 4; ++k) load4(vl + pos[k] * sstride, ok[k], v[k]);
        const float wx0 = 1.f - tx, wx1 = tx, wy0 = 1.f - ty, wy1 = ty;
        float dot = 0.f, sx = 0.f, sy = 0.f;
#pragma unroll
        for (int c = 0; c < kV; ++c) {
          const float smp = wy0 * (wx0 * v[0][c] + wx1 * v[1][c]) +
                            wy1 * (wx0 * v[2][c] + wx1 * v[3][c]);
          dot += g[c] * smp;
          sx += g[c] * (wy0 * (v[1][c] - v[0][c]) + wy1 * (v[3][c] - v[2][c]));
          sy += g[c] * (wx0 * (v[2][c] - v[0][c]) + wx1 * (v[3][c] - v[1][c]));
        }
        // selects, not products: a NaN sample's sums are NaN.  The hat
        // derivative is zero at an integral coordinate.
        dot = inside ? dot : 0.f;
        float gx = inside && tx > 0.f ? a * sx : 0.f;
        float gy = inside && ty > 0.f ? a * sy : 0.f;
        const float f[4] = {a * wy0 * wx0, a * wy0 * wx1, a * wy1 * wx0, a * wy1 * wx1};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (aggregate)   // the same for every lane of the block
            red_add4_aggregated(dvl + pos[k] * sstride, ok[k], pos[k] * 32 + grp, f[k], g);
          else if (ok[k])
            red_add4(dvl + pos[k] * sstride, f[k], g);
        }
        dot = group_sum(dot, groups);
        gx = group_sum(gx, groups);
        gy = group_sum(gy, groups);
        if (live && grp == 0) {
          ow[lp] = dot;
          ol[2 * lp] = gx * Wf;
          ol[2 * lp + 1] = gy * Hf;
        }
      }
    }
    __syncthreads();
    store_rows(d_loc + (row0 + (int64_t)q0 * M) * LP * 2, s_out, nq, LP * 2, M * LP * 2,
               tid, blockDim.x);
    store_rows(d_w + (row0 + (int64_t)q0 * M) * LP, s_out + tq * LP * 2, nq, LP, M * LP,
               tid, blockDim.x);
    __syncthreads();  // the input buffer is restaged, the results rewritten
  }
  async_copy::wait<0>();
}

template <typename T, int kL, int kP>
int launch(const void* value, const void* loc, const void* attw, const void* grad,
           void* d_value, void* d_loc, void* d_w, int B, int Lq, int S, int M, int D,
           int L, int P, int tq, int agg_mask, size_t smem, const Levels& lv,
           cudaStream_t s) {
  const auto kernel = msdeform_bwd_kernel<T, kL, kP>;
  int wave = 0;
  const cudaError_t e = resident_blocks(kernel, kThreads, smem, &wave);
  if (e != cudaSuccess) return (int)e;
  // one resident wave over the (b, head) pairs; each block walks a run of
  // query tiles with the next tile's copy ahead
  const int n_tiles = (Lq + tq - 1) / tq;
  const int runs = max(1, min(n_tiles, wave / (B * M)));
  const int per_block = (n_tiles + runs - 1) / runs;
  dim3 grid((n_tiles + per_block - 1) / per_block, M, B);
  kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(value), static_cast<const float*>(loc),
      static_cast<const float*>(attw), static_cast<const T*>(grad),
      static_cast<float*>(d_value), static_cast<float*>(d_loc),
      static_cast<float*>(d_w), Lq, S, M, D, L, P, tq, per_block, agg_mask, lv);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* value, const void* loc, const void* attw, const void* grad,
             void* d_value, void* d_loc, void* d_w, int B, int Lq, int S, int M, int D,
             int L, int P, int tq, int agg_mask, size_t smem, const Levels& lv,
             cudaStream_t s) {
  if (L == 3 && P == 4)
    return launch<T, 3, 4>(value, loc, attw, grad, d_value, d_loc, d_w, B, Lq, S, M,
                           D, L, P, tq, agg_mask, smem, lv, s);
  return launch<T, 0, 0>(value, loc, attw, grad, d_value, d_loc, d_w, B, Lq, S, M, D,
                         L, P, tq, agg_mask, smem, lv, s);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" int pctrans_msdeform_bwd(const void* value, const void* loc,
                                    const void* attw, const void* grad,
                                    void* d_value, void* d_loc, void* d_w,
                                    int B, int S, int M, int D, int Lq, int L,
                                    int P, const int* shapes, int agg_mask,
                                    int is_bf16, void* stream) {
  Levels lv;
  if (!make_levels(shapes, L, S, &lv) || P < 1 || M < 1 || B < 1 || B > 65535 ||
      M > 65535)
    return (int)cudaErrorInvalidValue;
  const int groups = D / kV;
  // a (query, head)'s lanes form one aligned group of a warp
  if (D < kV || D % kV || groups > 32 || (groups & (groups - 1)) ||
      (int64_t)S * M * D >= INT_MAX)
    return (int)cudaErrorInvalidValue;
  for (const void* p : {value, loc, attw, grad, (const void*)d_value,
                        (const void*)d_loc, (const void*)d_w})
    if (!aligned16(p)) return (int)cudaErrorInvalidValue;
  if (agg_mask >> L) return (int)cudaErrorInvalidValue;
  if (Lq == 0) return (int)cudaSuccess;
  const int tq = kThreads / groups;
  const size_t smem = sizeof(float) * 3 * (size_t)tq * L * P * 3;
  if (smem > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(value, loc, attw, grad, d_value, d_loc, d_w, B, Lq,
                                   S, M, D, L, P, tq, agg_mask, smem, lv, s);
  return dispatch<float>(value, loc, attw, grad, d_value, d_loc, d_w, B, Lq, S, M, D,
                         L, P, tq, agg_mask, smem, lv, s);
}
