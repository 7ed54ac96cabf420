// K4: fused bilinear upsample + threshold binarize.
//
// Replaces the TPU kernel pctrans_tpu/ops/resize_pallas.py:_kernel (two bf16
// MXU dots against jax.image.resize-of-identity matrices per query).  Per
// output pixel: the 2x2 stencil in f32 -- W axis first, then H, the twin's
// separable order -- compared with the threshold logit, one byte out.  The
// full-resolution f32 logits are never stored.
//
// What bounds it: bytes, mostly the u8 write.  At the CVPPP eval shape
// ([4, 50, 133, 125] f32 -> [4, 50, 530, 500] u8) the function reads 13.3 MB
// and writes 53.0 MB: 66.3 MB, 19.8 us at 3.35 TB/s; the full-Q re-run
// ([4, 100, ...]) moves twice that.  The unfused twin writes and re-reads
// 212 MB of f32 logits before its compare.
//
// Design (the first K4 ran one thread per output column of a 16-row
// strip: 4 scalar f32 loads per output pixel, each W-interpolated value
// formed again for every output row that taps it, and one byte store per
// pixel):
//   - one thread per 4 consecutive output columns of a tile of
//     `rows_per_tile` output rows of one image; its column taps (two source
//     columns and two weights per column) sit in registers;
//   - walking its rows in order, the thread keeps the last two
//     W-interpolated source rows, t[r][j] = wc0 * x[r][c0] + wc1 * x[r][c1],
//     in registers.  The row taps are non-decreasing in the output row, so
//     each source row of the tile's window is interpolated once per thread,
//     not once per output row that taps it (at 133 -> 530 a source row feeds
//     ~4 output rows);
//   - the 4 output bytes of a row are compared and stored as one 32-bit
//     word, a warp's stores one coalesced 128-byte run.  That needs W % 4 ==
//     0 (every row then starts 4-byte aligned, as H * W does); other widths
//     store byte by byte;
//   - no shared memory and no barrier.  A first redesign staged the tile's
//     interpolated rows in shared memory and re-read two of them per output
//     row, 8 bytes of shared-memory reads per output byte, and ran slower;
//     so did 8 columns per thread, and prefetching the next source row.
//     What is left is the latency of each row's dependent loads (the row
//     taps, then on a new source row its texels): with the stores alone the
//     same loop runs at about the u8 write's bound;
//   - the arithmetic and its order are the first K4's, so the bytes are
//     expected to equal its bytes.
//
// The wrapper (ops/resize_binarize.py) gives the per-row and per-column
// tables (two source indices, two weights: jax.image.resize's half-pixel
// rule with the off-edge taps dropped and renormalised, which for upsampling
// equals clamping the source coordinate) and the rows per tile.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

template <bool kPack4>
__global__ void __launch_bounds__(kThreads)
resize_binarize_kernel(const float* __restrict__ x, const int* __restrict__ row_idx,
                       const float* __restrict__ row_w,
                       const int* __restrict__ col_idx,
                       const float* __restrict__ col_w,
                       unsigned char* __restrict__ out, int h, int w, int H,
                       int W, int rows_per_tile, int tiles, float logit_t) {
  // grid: (image x row tile, chunk of kThreads column quads)
  const int j0 = 4 * (blockIdx.y * kThreads + threadIdx.x);
  if (j0 >= W) return;
  const int n = blockIdx.x / tiles, tile = blockIdx.x - n * tiles;
  const int i0 = tile * rows_per_tile, i1 = min(i0 + rows_per_tile, H);
  const float* xp = x + (int64_t)n * h * w;
  unsigned char* op = out + (int64_t)n * H * W + j0;

  int c0[4], c1[4];
  float wc0[4], wc1[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int j = min(j0 + c, W - 1);   // past the edge: a copy, never stored
    c0[c] = __ldg(col_idx + 2 * j);
    c1[c] = __ldg(col_idx + 2 * j + 1);
    wc0[c] = __ldg(col_w + 2 * j);
    wc1[c] = __ldg(col_w + 2 * j + 1);
  }
  auto interp = [&](int r, float (&t)[4]) {
    const float* xr = xp + r * w;
#pragma unroll
    for (int c = 0; c < 4; ++c) t[c] = wc0[c] * __ldg(xr + c0[c]) + wc1[c] * __ldg(xr + c1[c]);
  };

  int ia = -1, ib = -1;        // the source rows held in ta and tb
  float ta[4], tb[4];
  for (int i = i0; i < i1; ++i) {
    const int r0 = __ldg(row_idx + 2 * i), r1 = __ldg(row_idx + 2 * i + 1);
    const float wr0 = __ldg(row_w + 2 * i), wr1 = __ldg(row_w + 2 * i + 1);
    float t0[4], t1[4];
    if (r0 == ia) {
#pragma unroll
      for (int c = 0; c < 4; ++c) t0[c] = ta[c];
    } else if (r0 == ib) {
#pragma unroll
      for (int c = 0; c < 4; ++c) t0[c] = tb[c];
    } else {
      interp(r0, t0);
    }
    if (r1 == r0) {
#pragma unroll
      for (int c = 0; c < 4; ++c) t1[c] = t0[c];
    } else if (r1 == ib) {
#pragma unroll
      for (int c = 0; c < 4; ++c) t1[c] = tb[c];
    } else {
      interp(r1, t1);
    }
    ia = r0, ib = r1;
#pragma unroll
    for (int c = 0; c < 4; ++c) ta[c] = t0[c], tb[c] = t1[c];

    uint32_t bits = 0;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      bits |= (uint32_t)(wr0 * t0[c] + wr1 * t1[c] > logit_t) << (8 * c);
    unsigned char* row = op + (int64_t)i * W;
    if (kPack4) {
      *reinterpret_cast<uint32_t*>(row) = bits;
    } else {
      for (int c = 0; c < 4 && j0 + c < W; ++c) row[c] = (bits >> (8 * c)) & 1;
    }
  }
}

}  // namespace

extern "C" int pctrans_resize_binarize(const void* x, const void* row_idx,
                                       const void* row_w, const void* col_idx,
                                       const void* col_w, void* out, int N,
                                       int h, int w, int H, int W,
                                       int rows_per_tile, float logit_t,
                                       void* stream) {
  if (N <= 0 || H <= 0 || W <= 0) return (int)cudaSuccess;
  if (rows_per_tile < 1) return (int)cudaErrorInvalidValue;
  const int tiles = (H + rows_per_tile - 1) / rows_per_tile;
  const int chunks = ((W + 3) / 4 + kThreads - 1) / kThreads;
  if ((int64_t)N * tiles > INT32_MAX || chunks > 65535) return (int)cudaErrorInvalidValue;
  const bool pack4 = W % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 4 == 0;
  auto kernel = pack4 ? resize_binarize_kernel<true> : resize_binarize_kernel<false>;
  kernel<<<dim3(N * tiles, chunks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(row_idx),
      static_cast<const float*>(row_w), static_cast<const int*>(col_idx),
      static_cast<const float*>(col_w), static_cast<unsigned char*>(out), h, w, H, W,
      rows_per_tile, tiles, logit_t);
  return (int)cudaGetLastError();
}
