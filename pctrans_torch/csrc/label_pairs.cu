// K8: the label-pair table of each scored image -- table[b][g][p], the
// number of pixels of image b with ground-truth id g and predicted id p.
//
// Replaces no Pallas kernel: the JAX package scores on the host in numpy
// (pctrans_tpu/inference/metrics_bbbc.py, metrics_cvppp.py), and so did the
// port (`metrics_bbbc._contingency`, one `bincount` per image after two
// relabelling passes).  Every BBBC and CVPPP score reads only this table,
// so the host makes no pass over the pixels (inference/metrics_*.py take it).
//
// Inputs: the int16 label maps [B, H, W] the paint wrote; the ground truth
// [B, H, W] as int32, int16 or uint16; optionally a u8 foreground [B, H, W]
// (CVPPP's: a pixel outside it counts as predicted id 0).  Output: i32
// [B, G+1, C+1], zeroed here first.  A pixel whose g is not in [0, G] or
// whose p is not in [0, C] is not counted: the table then sums to less
// than H x W, which the caller checks.
//
// What bounds it: bytes.  BBBC's batch (B=2, 520x696) reads 2 + 4 bytes per
// pixel, 4.3 MB, 1.3 us at 3.35 TB/s; CVPPP's (B=4, 530x500) 6.4 MB,
// 1.9 us; the table (149 x 301 x 4 B = 179 KB per BBBC image) stays in L2.
// At these sizes the launch and the memset take longer than the reads.
//
// Design:
//   - the pixels of the batch are one flat range; each thread takes 16
//     consecutive pixels, loaded as 16-byte vectors where every base
//     address is 16-byte aligned (scalar loads otherwise, and for the
//     range's last, partial group).  The image of each pixel follows from
//     its flat index, so a group may span two images;
//   - the thread merges runs of equal keys (b, g, p) within its 16 pixels:
//     labels are spatially coherent, and most pixels are (0, 0);
//   - at the end of each run the lanes that end one there group by key
//     (`__match_any_sync`), sum their counts (`__reduce_add_sync`), and the
//     group's first lane adds the sum with one integer atomic.  A warp of
//     background pixels makes one atomic for 512 pixels;
//   - counts are exact integers, so the table is bit-equal to the twin's
//     `bincount` (ops/label_pairs.py) whatever the order of the atomics.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPx = 16;                 // pixels per thread
constexpr unsigned kNone = 0xffffffffu; // a pixel that is not counted
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned word_of(const uint4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// pixel j of 16 consecutive T held in sizeof(T) 16-byte words
template <typename T>
__device__ __forceinline__ int unpack(const uint4 (&w)[sizeof(T)], int j) {
  const int byte = j * (int)sizeof(T);
  const unsigned u = word_of(w[byte / 16], (byte % 16) / 4) >> (8 * (byte % 4));
  if (sizeof(T) == 4) return (int)u;
  if (sizeof(T) == 1) return (int)(u & 0xffu);
  return (T)(-1) < (T)0 ? (int)(short)(u & 0xffffu) : (int)(u & 0xffffu);
}

template <typename T>
__device__ __forceinline__ void load16(const T* __restrict__ src, unsigned i0, unsigned n,
                                       bool vec, int (&out)[kPx]) {
  if (vec) {
    uint4 w[sizeof(T)];
    const uint4* s = reinterpret_cast<const uint4*>(src + i0);
#pragma unroll
    for (int k = 0; k < (int)sizeof(T); ++k) w[k] = __ldg(s + k);
#pragma unroll
    for (int j = 0; j < kPx; ++j) out[j] = unpack<T>(w, j);
  } else {
#pragma unroll
    for (int j = 0; j < kPx; ++j) out[j] = i0 + j < n ? (int)__ldg(src + i0 + j) : 0;
  }
}

template <typename TG, bool kFg>
__global__ void __launch_bounds__(kThreads)
label_pairs_kernel(const short* __restrict__ labels, const TG* __restrict__ gt,
                   const unsigned char* __restrict__ fg, unsigned* __restrict__ table,
                   unsigned n, unsigned P, int G, int C, bool aligned) {
  const unsigned group = blockIdx.x * kThreads + threadIdx.x;
  const unsigned i0 = group * kPx;
  const bool inside = i0 < n;
  const bool vec = aligned && inside && n - i0 >= kPx;
  int p[kPx] = {}, g[kPx] = {}, f[kPx] = {};
  if (inside) {
    load16(labels, i0, n, vec, p);
    load16(gt, i0, n, vec, g);
    if (kFg) load16(fg, i0, n, vec, f);
  }
  const unsigned cols = (unsigned)C + 1, per_image = ((unsigned)G + 1) * cols;
  unsigned b = inside ? i0 / P : 0, r = inside ? i0 - b * P : 0;
  unsigned key[kPx];
#pragma unroll
  for (int j = 0; j < kPx; ++j) {
    const int pj = kFg && f[j] == 0 ? 0 : p[j];
    const bool ok = inside && i0 + j < n && g[j] >= 0 && g[j] <= G && pj >= 0 && pj <= C;
    key[j] = ok ? b * per_image + (unsigned)g[j] * cols + (unsigned)pj : kNone;
    if (++r == P) { r = 0; ++b; }
  }
  const unsigned lane = threadIdx.x & 31;
  unsigned count = 0;
#pragma unroll
  for (int j = 0; j < kPx; ++j) {
    ++count;
    const bool ends = j == kPx - 1 || key[j + 1] != key[j];
    const unsigned ending = __ballot_sync(kFull, ends);
    if (ends) {
      const unsigned peers = __match_any_sync(ending, key[j]);
      const unsigned sum = __reduce_add_sync(peers, count);
      if (key[j] != kNone && lane == (unsigned)(__ffs(peers) - 1)) atomicAdd(table + key[j], sum);
      count = 0;
    }
  }
}

template <typename TG>
cudaError_t launch(const void* labels, const void* gt, const void* fg, void* table,
                   unsigned n, unsigned P, int G, int C, bool aligned, cudaStream_t s) {
  const unsigned blocks = (n + kThreads * kPx - 1) / (kThreads * kPx);
  const short* l = static_cast<const short*>(labels);
  const TG* t = static_cast<const TG*>(gt);
  unsigned* out = static_cast<unsigned*>(table);
  if (fg != nullptr)
    label_pairs_kernel<TG, true><<<blocks, kThreads, 0, s>>>(
        l, t, static_cast<const unsigned char*>(fg), out, n, P, G, C, aligned);
  else
    label_pairs_kernel<TG, false><<<blocks, kThreads, 0, s>>>(l, t, nullptr, out, n, P, G, C,
                                                              aligned);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// gt_kind: 0 int32, 1 int16, 2 uint16.  fg may be NULL.
extern "C" int pctrans_label_pairs(const void* labels, const void* gt, const void* fg,
                                   void* table, int B, long long P, int G, int C,
                                   int gt_kind, void* stream) {
  if (B < 0 || P < 0 || G < 0 || C < 0 || gt_kind < 0 || gt_kind > 2)
    return (int)cudaErrorInvalidValue;
  const int64_t n = (int64_t)B * P, cells = (int64_t)B * (G + 1) * (C + 1);
  if (n >= INT32_MAX - kPx || cells >= INT32_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(table, 0, (size_t)cells * sizeof(int), s);
  if (e != cudaSuccess || n == 0) return (int)e;
  const bool aligned = aligned16(labels) && aligned16(gt) && (fg == nullptr || aligned16(fg));
  const unsigned un = (unsigned)n, uP = (unsigned)P;
  if (gt_kind == 0) return (int)launch<int>(labels, gt, fg, table, un, uP, G, C, aligned, s);
  if (gt_kind == 1) return (int)launch<short>(labels, gt, fg, table, un, uP, G, C, aligned, s);
  return (int)launch<unsigned short>(labels, gt, fg, table, un, uP, G, C, aligned, s);
}
