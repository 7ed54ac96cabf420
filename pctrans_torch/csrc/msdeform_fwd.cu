// K1: multi-scale deformable attention, forward (direct bilinear gather).
//
// Replaces the TPU kernel pctrans_tpu/ops/msdeform_pallas2.py:_fused_kernel
// (hat-matmul over lane-major sample chunks, a workaround for the TPU's lack
// of a gather).  On Hopper the natural form is a gather of the four corners.
//
// What bounds it: bytes.  At the CVPPP eval shape (B=4, Lq=S=5581, M=8,
// D=16, L=3, P=4, bf16 value) the function reads value 5.7 MB, loc 17.1 MB
// and w 8.6 MB and writes 5.7 MB: 37.1 MB, 11.1 us at 3.35 TB/s.  Loc and w
// are 70% of those bytes.  The value map stays in the 50 MB L2, but every
// inside sample still gathers 4 corners x 32 bytes per head from it (274 MB
// of L2 sectors at that shape with random locations), so L2 bandwidth, not
// HBM, is the working limit when neighbouring queries do not share corners.
//
// Design:
//   - one thread per (b, q, head, group of V channels), V = 8 for bf16 and
//     4 for f32, so every corner is one 16-byte load and the output one
//     16-byte store (the first K1 ran one thread per channel: the 16 lanes of
//     a head loaded the same loc and w and redid the same corner math);
//   - a block takes a tile of tq queries (tq a multiple of 4) and stages
//     their loc and w slabs, contiguous in memory, into shared memory with
//     cp.async; a grid-stride loop over tiles double-buffers the copy, so
//     the next tile's loc and w arrive while this tile gathers;
//   - branch-free points: each corner's address is clamped into the map and
//     its validity and bilinear weight fold into one f32 factor (a select,
//     so NaN locations give 0 as in the twin); (L, P) = (3, 4), the recipe,
//     is a template instance with both loops unrolled, so all 48 corner loads
//     of a thread can be in flight together; other sizes run the same code
//     with runtime trip counts;
//   - 32-bit offsets inside one image (the wrapper refuses S * M * D >=
//     2^31); f32 accumulation; one rounding to the value dtype at the store.
//
// Contract (pctrans_tpu/ops/msdeform.py:1-18): value [B, S, M, D] with D a
// multiple of V and M * D / V <= 64 (threads per query); loc
// [B, Lq, M, L, P, 2] f32 normalised (x, y); w [B, Lq, M, L, P] f32; out
// [B, Lq, M*D] in the value dtype; all four 16-byte aligned.  Pixel position = loc * size - 0.5 (with __fmul_rn, so an
// integral coordinate stays integral), corners outside the map contribute
// zero (grid_sample, zero padding).  The entry point refuses what the kernel
// does not take with cudaErrorInvalidValue; nothing falls back.

#include <limits.h>

#include "async_copy.cuh"
#include "msdeform_common.cuh"

using namespace msdeform;

namespace {

constexpr int kMaxThreads = 256;  // tq * tpq <= 4 * 64
constexpr int kSmemLimit = 232448;  // bytes of shared memory a block may use

// V channels of the value dtype per 16-byte load
template <typename T>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int V = 4;
  __device__ static void fma(float (&acc)[V], float f, uint4 r) {
    acc[0] = fmaf(f, __uint_as_float(r.x), acc[0]);
    acc[1] = fmaf(f, __uint_as_float(r.y), acc[1]);
    acc[2] = fmaf(f, __uint_as_float(r.z), acc[2]);
    acc[3] = fmaf(f, __uint_as_float(r.w), acc[3]);
  }
  __device__ static uint4 pack(const float (&acc)[V]) {
    return make_uint4(__float_as_uint(acc[0]), __float_as_uint(acc[1]),
                      __float_as_uint(acc[2]), __float_as_uint(acc[3]));
  }
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int V = 8;
  // a 32-bit word holds channels 2i (low half) and 2i + 1 (high half)
  __device__ static void fma2(float* acc, float f, uint32_t w) {
    acc[0] = fmaf(f, __uint_as_float(w << 16), acc[0]);
    acc[1] = fmaf(f, __uint_as_float(w & 0xffff0000u), acc[1]);
  }
  __device__ static void fma(float (&acc)[V], float f, uint4 r) {
    fma2(acc + 0, f, r.x);
    fma2(acc + 2, f, r.y);
    fma2(acc + 4, f, r.z);
    fma2(acc + 6, f, r.w);
  }
  __device__ static uint32_t pack2(float lo, float hi) {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
  __device__ static uint4 pack(const float (&acc)[V]) {
    return make_uint4(pack2(acc[0], acc[1]), pack2(acc[2], acc[3]),
                      pack2(acc[4], acc[5]), pack2(acc[6], acc[7]));
  }
};

__device__ __forceinline__ uint4 load16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// kL = kP = 0: L and P at run time
template <typename T, int kL, int kP>
__global__ void __launch_bounds__(kMaxThreads, 2)
msdeform_fwd_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                    const float* __restrict__ attw, T* __restrict__ out,
                    int n_bq, int Lq, int S, int M, int D, int L_rt, int P_rt,
                    int tq, Levels lv) {
  constexpr int V = Pack<T>::V;
  const int L = kL ? kL : L_rt, P = kP ? kP : P_rt;
  const int LP = L * P;
  const int groups = D / V;            // threads per head
  const int tpq = M * groups;          // threads per query
  const int mlp = M * LP;              // samples per query
  const int buf_floats = tq * mlp * 3;  // loc (x, y) then w, per tile
  const int n_tiles = (n_bq + tq - 1) / tq;
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x;
  const int qi = tid / tpq;
  const int m = (tid - qi * tpq) / groups;
  const int grp = tid - qi * tpq - m * groups;
  const int sstride = M * D;

  auto stage = [&](int tile, int buf) {
    const int q0 = tile * tq, nq = min(tq, n_bq - q0);
    float* s = smem + buf * buf_floats;
    async_copy::copy_floats(s, loc + (int64_t)q0 * mlp * 2, nq * mlp * 2, tid,
                            blockDim.x);
    async_copy::copy_floats(s + tq * mlp * 2, attw + (int64_t)q0 * mlp,
                            nq * mlp, tid, blockDim.x);
  };

  int tile = blockIdx.x;
  if (tile < n_tiles) stage(tile, 0);
  async_copy::commit();
  for (int it = 0; tile < n_tiles; ++it, tile += gridDim.x) {
    // the next tile's copy goes into the buffer the previous tile used
    if (tile + (int)gridDim.x < n_tiles) stage(tile + gridDim.x, (it + 1) & 1);
    async_copy::commit();
    async_copy::wait<1>();
    __syncthreads();

    const int bq = tile * tq + qi;
    if (bq < n_bq) {
      const float* s = smem + (it & 1) * buf_floats;
      const float* sl = s + (qi * M + m) * LP * 2;
      const float* sw = s + tq * mlp * 2 + (qi * M + m) * LP;
      const T* vb = value + (int64_t)(bq / Lq) * S * sstride + m * D + grp * V;
      float acc[V];
#pragma unroll
      for (int c = 0; c < V; ++c) acc[c] = 0.f;
#pragma unroll
      for (int l = 0; l < L; ++l) {
        const int H = lv.h[l], W = lv.w[l];
        const float Wf = (float)W, Hf = (float)H;
        const T* vl = vb + lv.start[l] * sstride;
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
          // corner validity in float compares: NaN gives false
          const bool vx0 = x0f >= 0.f && x0f < Wf, vx1 = x0f >= -1.f && x0f < Wf - 1.f;
          const bool vy0 = y0f >= 0.f && y0f < Hf, vy1 = y0f >= -1.f && y0f < Hf - 1.f;
          // clamped corner indices (fmaxf maps NaN to -1)
          const int ix = (int)fminf(fmaxf(x0f, -1.f), Wf);
          const int iy = (int)fminf(fmaxf(y0f, -1.f), Hf);
          const int cx0 = min(max(ix, 0), W - 1), cx1 = min(ix + 1, W - 1);
          const int cy0 = min(max(iy, 0), H - 1), cy1 = min(iy + 1, H - 1);
          const float ax0 = a * (1.f - tx), ax1 = a * tx;
          const float f00 = (vy0 && vx0) ? ax0 * (1.f - ty) : 0.f;
          const float f01 = (vy0 && vx1) ? ax1 * (1.f - ty) : 0.f;
          const float f10 = (vy1 && vx0) ? ax0 * ty : 0.f;
          const float f11 = (vy1 && vx1) ? ax1 * ty : 0.f;
          const uint4 r00 = load16(vl + (cy0 * W + cx0) * sstride);
          const uint4 r01 = load16(vl + (cy0 * W + cx1) * sstride);
          const uint4 r10 = load16(vl + (cy1 * W + cx0) * sstride);
          const uint4 r11 = load16(vl + (cy1 * W + cx1) * sstride);
          Pack<T>::fma(acc, f00, r00);
          Pack<T>::fma(acc, f01, r01);
          Pack<T>::fma(acc, f10, r10);
          Pack<T>::fma(acc, f11, r11);
        }
      }
      *reinterpret_cast<uint4*>(out + (int64_t)bq * sstride + m * D + grp * V) =
          Pack<T>::pack(acc);
    }
    __syncthreads();  // this buffer is restaged by the next iteration
  }
  async_copy::wait<0>();
}

template <typename T, int kL, int kP>
int launch(const void* value, const void* loc, const void* attw, void* out,
           int n_bq, int Lq, int S, int M, int D, int L, int P, int tq,
           int threads, size_t smem, const Levels& lv, cudaStream_t s) {
  auto kernel = msdeform_fwd_kernel<T, kL, kP>;
  // The resident blocks depend only on this instance, the device, the block
  // size and the shared memory: worked out once per host thread and key, so
  // a launch makes no occupancy query.
  struct Wave {
    int dev = -1, threads = 0;
    size_t smem = 0;
    int blocks = 0;
  };
  static thread_local Wave wave;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev != wave.dev || threads != wave.threads || smem != wave.smem) {
    if (smem > 48 * 1024) {
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    if (e != cudaSuccess) return (int)e;
    wave = Wave{dev, threads, smem, sms * max(per_sm, 1)};
  }
  const int n_tiles = (n_bq + tq - 1) / tq;
  // one resident wave; each block walks its tiles with the copy ahead
  const int grid = max(1, min(n_tiles, wave.blocks));
  kernel<<<grid, threads, smem, s>>>(
      static_cast<const T*>(value), static_cast<const float*>(loc),
      static_cast<const float*>(attw), static_cast<T*>(out), n_bq, Lq, S, M, D,
      L, P, tq, lv);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* value, const void* loc, const void* attw, void* out,
             int n_bq, int Lq, int S, int M, int D, int L, int P, int tq,
             int threads, size_t smem, const Levels& lv, cudaStream_t s) {
  if (L == 3 && P == 4)
    return launch<T, 3, 4>(value, loc, attw, out, n_bq, Lq, S, M, D, L, P, tq,
                           threads, smem, lv, s);
  return launch<T, 0, 0>(value, loc, attw, out, n_bq, Lq, S, M, D, L, P, tq,
                         threads, smem, lv, s);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" int pctrans_msdeform_fwd(const void* value, const void* loc,
                                    const void* attw, void* out, int B, int S,
                                    int M, int D, int Lq, int L, int P,
                                    const int* shapes, int is_bf16,
                                    void* stream) {
  Levels lv;
  if (!make_levels(shapes, L, S, &lv) || P < 1 || M < 1)
    return (int)cudaErrorInvalidValue;
  const int V = is_bf16 ? 8 : 4;
  const int64_t n_bq = (int64_t)B * Lq;
  if (D < V || D % V || (int64_t)S * M * D >= INT_MAX || n_bq * M * D >= INT_MAX ||
      !aligned16(value) || !aligned16(loc) || !aligned16(attw) || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  if (n_bq == 0) return (int)cudaSuccess;
  const int tpq = M * (D / V);
  if (tpq > 64) return (int)cudaErrorInvalidValue;
  const int tq = 4 * max(1, 64 / tpq);  // a multiple of 4 keeps slabs aligned
  const int threads = tq * tpq;
  const size_t smem = 2 * sizeof(float) * (size_t)tq * M * L * P * 3;
  if (smem > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(value, loc, attw, out, (int)n_bq, Lq, S, M, D,
                                   L, P, tq, threads, smem, lv, s);
  return dispatch<float>(value, loc, attw, out, (int)n_bq, Lq, S, M, D, L, P,
                         tq, threads, smem, lv, s);
}

extern "C" const char* pctrans_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
