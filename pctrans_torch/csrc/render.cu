// K3: CondInst dynamic mask render, forward.
//
// Replaces the TPU kernel pctrans_tpu/ops/render_pallas.py:_render_kernel
// (block-diagonal MXU packing of 16 queries' 8x8 convolutions, a TPU
// matrix-unit workaround).  Here each thread owns one (b, q, pixel) and runs
// the query's 3-layer 1x1 MLP in registers:
//
//   x1 = relu(W1[q] @ [inst_xy(q) - loc(pixel) ; feats(pixel)] + b1[q])  (ch=8)
//   x2 = relu(W2[q] @ x1 + b2[q])
//   out = W3[q] @ x2 + b3[q]
//
// A block covers one (b, q) and a tile of pixels; the query's weights sit in
// shared memory and are read as broadcasts.  Only the [B, Q, HW] f32 output
// is written.
//
// Bound: at the CVPPP eval shape (B=4, Q=100, HW=133*125, Cm=16) the output
// is 26.6 MB and the feature map (4.3 MB) is re-read once per query from L2
// (425 MB of L2 traffic); arithmetic is ~2.9 GFLOP of f32 FMA.  The design
// keeps the three [B, Q, 8, HW] intermediates of the einsum twin (213 MB
// each) out of device memory entirely.  A thread's feature row is 64 bytes
// away from its neighbour's, so the row is read as float4: a quarter of the
// load instructions (0.363 -> 0.196 ms at this shape on an H100 80GB HBM3,
// 700 W limit; the einsum twin takes 1.69 ms there).  Hence Cm % 4 == 0 and
// a 16-byte aligned feature map (the CVPPP and BBBC configs have
// mask_dim 16).
//
// Rel coords follow pctrans_tpu/ops/render_pallas.py:73-79: pixel (i, j) of
// the stride-s map sits at (j*s + s/2, i*s + s/2) and rel = inst_xy - that,
// channels (x, y) ahead of the Cm feature channels in w1's input axis.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCh = 8;  // dynamic_mask_channels
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
render_kernel(const float* __restrict__ feats, const float* __restrict__ inst_xy,
              const float* __restrict__ w1, const float* __restrict__ w2,
              const float* __restrict__ w3, const float* __restrict__ b1,
              const float* __restrict__ b2, const float* __restrict__ b3,
              float* __restrict__ out, int Q, int Hm, int Wm, int Cm, int rel,
              int stride) {
  extern __shared__ float smem[];
  const int cin = Cm + (rel ? 2 : 0);
  float* s_w1 = smem;                 // [kCh, cin]
  float* s_w2 = s_w1 + kCh * cin;     // [kCh, kCh]
  float* s_w3 = s_w2 + kCh * kCh;     // [kCh]
  float* s_b1 = s_w3 + kCh;           // [kCh]
  float* s_b2 = s_b1 + kCh;           // [kCh]
  float* s_misc = s_b2 + kCh;         // b3, inst_x, inst_y

  const int64_t bq = (int64_t)blockIdx.z * Q + blockIdx.y;
  for (int i = threadIdx.x; i < kCh * cin; i += blockDim.x)
    s_w1[i] = w1[bq * kCh * cin + i];
  for (int i = threadIdx.x; i < kCh * kCh; i += blockDim.x)
    s_w2[i] = w2[bq * kCh * kCh + i];
  if (threadIdx.x < kCh) {
    s_w3[threadIdx.x] = w3[bq * kCh + threadIdx.x];
    s_b1[threadIdx.x] = b1[bq * kCh + threadIdx.x];
    s_b2[threadIdx.x] = b2[bq * kCh + threadIdx.x];
  }
  if (threadIdx.x == 0) {
    s_misc[0] = b3[bq];
    s_misc[1] = inst_xy[bq * 2];
    s_misc[2] = inst_xy[bq * 2 + 1];
  }
  __syncthreads();

  const int HW = Hm * Wm;
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= HW) return;

  float h1[kCh];
#pragma unroll
  for (int o = 0; o < kCh; ++o) h1[o] = s_b1[o];
  int off = 0;
  if (rel) {
    const int i = n / Wm, j = n - (n / Wm) * Wm;
    const float rx = s_misc[1] - (float)(j * stride + stride / 2);
    const float ry = s_misc[2] - (float)(i * stride + stride / 2);
#pragma unroll
    for (int o = 0; o < kCh; ++o)
      h1[o] += s_w1[o * cin] * rx + s_w1[o * cin + 1] * ry;
    off = 2;
  }
  const float* f = feats + ((int64_t)blockIdx.z * HW + n) * Cm;
  const float* w1f = s_w1 + off;  // feature columns of W1
  const float4* f4 = reinterpret_cast<const float4*>(f);
  for (int c4 = 0; c4 < Cm / 4; ++c4) {
    const float4 v = __ldg(f4 + c4);
    const int c = 4 * c4;
#pragma unroll
    for (int o = 0; o < kCh; ++o) {
      const float* wr = w1f + o * cin + c;
      h1[o] += wr[0] * v.x + wr[1] * v.y + wr[2] * v.z + wr[3] * v.w;
    }
  }
#pragma unroll
  for (int o = 0; o < kCh; ++o) h1[o] = fmaxf(h1[o], 0.f);

  float r = s_misc[0];
#pragma unroll
  for (int o = 0; o < kCh; ++o) {
    float h2 = s_b2[o];
#pragma unroll
    for (int c = 0; c < kCh; ++c) h2 += s_w2[o * kCh + c] * h1[c];
    r += s_w3[o] * fmaxf(h2, 0.f);
  }
  out[bq * HW + n] = r;
}

}  // namespace

extern "C" int pctrans_render_fwd(const void* feats, const void* inst_xy,
                                  const void* w1, const void* w2,
                                  const void* w3, const void* b1,
                                  const void* b2, const void* b3, void* out,
                                  int B, int Q, int Hm, int Wm, int Cm,
                                  int rel_coord, int stride, void* stream) {
  if (B <= 0 || Q <= 0 || Hm <= 0 || Wm <= 0) return (int)cudaSuccess;
  if (Q > 65535 || B > 65535 || Cm % 4 != 0 ||
      reinterpret_cast<uintptr_t>(feats) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int cin = Cm + (rel_coord ? 2 : 0);
  const size_t smem = sizeof(float) * (kCh * cin + kCh * kCh + 3 * kCh + 3);
  const int HW = Hm * Wm;
  dim3 grid((HW + kThreads - 1) / kThreads, Q, B);
  render_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(feats), static_cast<const float*>(inst_xy),
      static_cast<const float*>(w1), static_cast<const float*>(w2),
      static_cast<const float*>(w3), static_cast<const float*>(b1),
      static_cast<const float*>(b2), static_cast<const float*>(b3),
      static_cast<float*>(out), Q, Hm, Wm, Cm, rel_coord, stride);
  return (int)cudaGetLastError();
}
