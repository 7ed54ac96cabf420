// K6: Swin's (shifted-)window self-attention with its relative-position
// bias, forward only, between the qkv projection and proj.
//
// Replaces no TPU kernel: the JAX package leaves this attention to XLA
// (pctrans_tpu/models/swin.py:71-109), and so did the port's twin
// (pctrans_torch/ops/window_attn.py:window_attention_twin), which writes the
// logits to device memory and reads them back six times (the bf16 q.k^T, its
// f32 copy, the bias add with the table gathered anew, the shift-mask add,
// the f32 softmax and its bf16 cast before P.V).  At Swin-L's widths on a
// 4 x 530x500 batch that is ~139M logits per image and ~20 GB of traffic per
// forward.
//
//   per window w and head h (N = ws*ws tokens, head width 32):
//     q = bf16(q * scale)                       (the twin's rounding)
//     S = bf16(q . k^T)                         (f32 sums, one bf16 rounding)
//     A = S + table[idx(i, j), h] + mask(w, i, j)          (f32)
//     P = bf16(softmax_j(A))       (f32: the SFU's exp, sum, one reciprocal)
//     out[w, i, h*32:(h+1)*32] = bf16(P . v)    (f32 sums)
//
// idx(i, j) is the relative offset of tokens i and j, (yi - yj + t - 1) *
// (2t - 1) + (xi - xj + t - 1), into the table of the configured window t
// (a window clamped to a small map reads the table's central offsets);
// mask is -100 between tokens that a cyclic shift by `shift` brings into one
// window from different regions of the padded map (the regions split each
// axis at Hp - ws and Hp - shift, so only the grid's last row and column of
// windows hold two), 0 otherwise and everywhere when shift is 0.  Both come
// from (i, j) and the window's place; no index or mask tensor is read.
//
// What bounds it: bytes.  Per window-head the kernel reads q, k and v once
// (3 x N x 32 bf16) and the head's table column, and writes N x 32 bf16;
// 4 N^2 32 FLOP of products.  At Swin-L's first stage (528 windows of 144
// tokens, 6 heads, B = 4) that is 117 MB, 35 us at 3.35 TB/s, against 8.4
// GFLOP, 8.5 us at 989 TFLOP/s.
//
// Design: a block per (window, head) of N_pad / 16 warps (N_pad = N rounded
// up to 16; 9 warps for window 12), two blocks resident per SM (at most 113
// registers a thread for window 12: one block alone left the SM idle while
// it loaded).  The block stages the head's K rows and V transposed in
// shared memory (zero past N) and the table column; each warp owns 16 query
// rows.  S for the warp's rows lives in registers as mma.sync m16n8k16 bf16
// accumulators (2 k-steps over the head width); the bias, mask, row max,
// exp, sum and reciprocal run on those fragments, each row spread over the
// 4 lanes of a quad (two shuffles per reduction); P is
// rounded to bf16 and repacked in place as the A fragments of P.V (the
// accumulator of n-tiles 2k and 2k+1 is the A operand of k-step k), which
// runs N_pad / 16 k-steps into four n8 output tiles.  The output is written
// as [windows, N, C] bf16, the head's 32 columns of each token row: the
// twin's transpose is fused.  Nothing but q, k, v, the table and the
// output touches device memory.
//
// Contract: qkv [Bn, N, 3C] bf16 contiguous (q, k, v each [H, 32] per
// token, as the nn.Linear lays them out), read in place; table
// [(2t-1)^2, H] f32 contiguous; out [Bn, N, C] bf16; C = 32 H; 1 <= ws <= t
// <= 12; 0 <= shift < ws; the windows of one image are nWh x nWw in row
// order and Bn a multiple of nWh nWw; qkv and out 16-byte aligned.  The
// entry point refuses anything else with cudaErrorInvalidValue.

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHd = 32;                    // head width
constexpr int kMaxWs = 12;                 // largest window (and table window)
constexpr int kMaxTiles = 9;               // 16-row tiles of 144 tokens
constexpr int kKStride = kHd + 8;          // bf16 per row of Ks: 80 bytes
constexpr int kVStride = kMaxTiles * 16 + 8;   // bf16 per row of Vt: 304 bytes
constexpr int kMaxTable = (2 * kMaxWs - 1) * (2 * kMaxWs - 1);

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// d += a . b, m16n8k16, bf16 inputs, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int NT>
__global__ void __launch_bounds__(NT * 32, 2)
window_attn_kernel(const __nv_bfloat16* __restrict__ qkv, const float* __restrict__ table,
                   __nv_bfloat16* __restrict__ out, int N, int ws, int C, int H, int tws,
                   int nWh, int nWw, int shift, float scale) {
  constexpr int NS = 2 * NT;               // n8 tiles of keys
  __shared__ __align__(16) __nv_bfloat16 Ks[kMaxTiles * 16][kKStride];
  __shared__ __align__(16) __nv_bfloat16 Vt[kHd][kVStride];
  __shared__ float tab[kMaxTable];

  const int w = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int64_t row = 3LL * C;
  const __nv_bfloat16* base = qkv + (int64_t)w * N * row + h * kHd;

  // K rows and V columns of this head, zero past N; 16 bytes a load
  for (int i = tid; i < NT * 16 * 4; i += NT * 32) {
    const int r = i >> 2, c = (i & 3) * 8;
    uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
    if (r < N) {
      kv = *reinterpret_cast<const uint4*>(base + r * row + C + c);
      vv = *reinterpret_cast<const uint4*>(base + r * row + 2 * C + c);
    }
    *reinterpret_cast<uint4*>(&Ks[r][c]) = kv;
    const __nv_bfloat16* v8 = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
    for (int e = 0; e < 8; ++e) Vt[c + e][r] = v8[e];
  }
  for (int i = tid; i < (2 * tws - 1) * (2 * tws - 1); i += NT * 32)
    tab[i] = table[(int64_t)i * H + h];

  // this warp's query rows as A fragments, scaled and rounded as the twin
  const int r0 = warp * 16 + g, r1 = r0 + 8;
  uint32_t qa[2][4];
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
    for (int part = 0; part < 4; ++part) {
      const int r = (part & 1) ? r1 : r0;
      const int c = kk * 16 + (part >> 1) * 8 + t4 * 2;
      float lo = 0.f, hi = 0.f;
      if (r < N) {
        __nv_bfloat162 q2 = *reinterpret_cast<const __nv_bfloat162*>(base + r * row + c);
        lo = __bfloat162float(q2.x) * scale;
        hi = __bfloat162float(q2.y) * scale;
      }
      qa[kk][part] = pack_bf16(lo, hi);
    }
  }
  __syncthreads();

  // S = q . k^T for the warp's 16 rows and every key
  float s[NS][4];
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const __nv_bfloat16* kp = &Ks[j * 8 + g][kk * 16 + t4 * 2];
      mma_bf16(s[j], qa[kk], *reinterpret_cast<const uint32_t*>(kp),
               *reinterpret_cast<const uint32_t*>(kp + 8));
    }
  }

  // logits: S rounded as the twin rounds it, plus the bias and the shift
  // mask from each pair's place; keys past N at -inf.  A thread's keys step
  // 8 tokens per n-tile, so their (y, x) in the window step without a
  // division.  Under a shift only a window in the grid's last row (column)
  // holds two regions along y (x): there a token's region is whether it
  // lies before ws - shift on that axis; elsewhere every token shares one.
  const int win = w % (nWh * nWw);
  const bool mask_y = shift && win / nWw == nWh - 1;
  const bool mask_x = shift && win % nWw == nWw - 1;
  const int cut = ws - shift, T = 2 * tws - 1;
  int row_off[2];                          // row i's offset into the table
  bool ay[2], ax[2];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int i = min(a ? r1 : r0, N - 1), y = i / ws, x = i % ws;
    row_off[a] = (y + tws - 1) * T + x + tws - 1;
    ay[a] = y < cut;
    ax[a] = x < cut;
  }
  int yj[2] = {0, 0}, xj[2] = {t4 * 2, t4 * 2 + 1};
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < NS; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      while (xj[e] >= ws) {
        xj[e] -= ws;
        ++yj[e];
      }
      const bool key = j * 8 + t4 * 2 + e < N;
      const int off = yj[e] * T + xj[e];
      const bool by = yj[e] < cut, bx = xj[e] < cut;
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        float x = -INFINITY;
        if (key) {
          x = round_bf16(s[j][e + 2 * a]) + tab[row_off[a] - off];
          if ((mask_y && ay[a] != by) || (mask_x && ax[a] != bx)) x += -100.f;
        }
        s[j][e + 2 * a] = x;
        mx[a] = fmaxf(mx[a], x);
      }
      xj[e] += 8;
    }
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    mx[a] = fmaxf(mx[a], __shfl_xor_sync(0xffffffffu, mx[a], 1));
    mx[a] = fmaxf(mx[a], __shfl_xor_sync(0xffffffffu, mx[a], 2));
  }
#pragma unroll
  for (int j = 0; j < NS; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = __expf(s[j][e] - mx[e >> 1]);
      sum[e >> 1] += s[j][e];
    }
  }
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    sum[a] += __shfl_xor_sync(0xffffffffu, sum[a], 1);
    sum[a] += __shfl_xor_sync(0xffffffffu, sum[a], 2);
  }

  const float inv[2] = {1.f / sum[0], 1.f / sum[1]};

  // out = P . v: the accumulators of key tiles 2k and 2k+1 are k-step k's A
  float o[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < NT; ++kk) {
    uint32_t pa[4];
    pa[0] = pack_bf16(s[2 * kk][0] * inv[0], s[2 * kk][1] * inv[0]);
    pa[1] = pack_bf16(s[2 * kk][2] * inv[1], s[2 * kk][3] * inv[1]);
    pa[2] = pack_bf16(s[2 * kk + 1][0] * inv[0], s[2 * kk + 1][1] * inv[0]);
    pa[3] = pack_bf16(s[2 * kk + 1][2] * inv[1], s[2 * kk + 1][3] * inv[1]);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const __nv_bfloat16* vp = &Vt[nt * 8 + g][kk * 16 + t4 * 2];
      mma_bf16(o[nt], pa, *reinterpret_cast<const uint32_t*>(vp),
               *reinterpret_cast<const uint32_t*>(vp + 8));
    }
  }

  __nv_bfloat16* dst = out + (int64_t)w * N * C + h * kHd + t4 * 2;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    if (r0 < N)
      *reinterpret_cast<uint32_t*>(dst + (int64_t)r0 * C + nt * 8) =
          pack_bf16(o[nt][0], o[nt][1]);
    if (r1 < N)
      *reinterpret_cast<uint32_t*>(dst + (int64_t)r1 * C + nt * 8) =
          pack_bf16(o[nt][2], o[nt][3]);
  }
}

template <int NT>
int launch(const void* qkv, const void* table, void* out, int Bn, int N, int ws, int C,
           int H, int tws, int nWh, int nWw, int shift, float scale, cudaStream_t s) {
  window_attn_kernel<NT><<<dim3(Bn, H), NT * 32, 0, s>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<const float*>(table),
      static_cast<__nv_bfloat16*>(out), N, ws, C, H, tws, nWh, nWw, shift, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pctrans_window_attn_fwd(const void* qkv, const void* table, void* out,
                                       int Bn, int ws, int C, int H, int tws, int nWh,
                                       int nWw, int shift, float scale, void* stream) {
  if (Bn <= 0) return (int)cudaSuccess;
  if (ws < 1 || ws > tws || tws > kMaxWs || H < 1 || H > 65535 || C != kHd * H ||
      shift < 0 || shift >= ws || nWh < 1 || nWw < 1 || Bn % (nWh * nWw) ||
      reinterpret_cast<uintptr_t>(qkv) % 16 || reinterpret_cast<uintptr_t>(out) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int N = ws * ws;
  switch ((N + 15) / 16) {
    case 1: return launch<1>(qkv, table, out, Bn, N, ws, C, H, tws, nWh, nWw, shift, scale, s);
    case 2: return launch<2>(qkv, table, out, Bn, N, ws, C, H, tws, nWh, nWw, shift, scale, s);
    case 3: return launch<3>(qkv, table, out, Bn, N, ws, C, H, tws, nWh, nWw, shift, scale, s);
    case 4: return launch<4>(qkv, table, out, Bn, N, ws, C, H, tws, nWh, nWw, shift, scale, s);
    case 5: return launch<5>(qkv, table, out, Bn, N, ws, C, H, tws, nWh, nWw, shift, scale, s);
    case 6: return launch<6>(qkv, table, out, Bn, N, ws, C, H, tws, nWh, nWw, shift, scale, s);
    case 7: return launch<7>(qkv, table, out, Bn, N, ws, C, H, tws, nWh, nWw, shift, scale, s);
    case 8: return launch<8>(qkv, table, out, Bn, N, ws, C, H, tws, nWh, nWw, shift, scale, s);
    default: return launch<9>(qkv, table, out, Bn, N, ws, C, H, tws, nWh, nWw, shift, scale, s);
  }
}
