// K7: the masks' statistics, packed -- areas, pairwise intersections and an
// optional per-mask column -- from the binarized u8 masks [B, K, H, W].
//
// Replaces no Pallas kernel: the JAX package leaves this product to XLA
// (pctrans_tpu/inference/device_postprocess.py:62-69, `_binary_dot`).  The
// port's plain version (ops/mask_stats.py, `packed_mask_stats_twin`) casts
// the masks to f32 and runs one f32 `bmm` M M^T on the CUDA cores; at the
// eval shapes (K = 50-300 masks against 265,000-361,920 pixels) cuBLAS
// takes 32x32x8 tiles with no split over the pixels, 16-64 blocks on 132
// SMs, after writing an f32 copy of the masks four times their size.
//
// What bounds it: bytes.  Each mask byte is read once: at the CVPPP eval's
// B=4, K=100, 530x500 that is 106 MB, 31.6 us at 3.35 TB/s.  The product
// over the i <= j pairs is K(K+1)/2 x P x 2 u8 operations, 10.7 G there,
// 5.4 us at 1,979 TOPS; at BBBC's K=300 the two approach (65 us of bytes,
// 33 us of operations).  The output is K x (K+2) f32 per image.
//
// Design:
//   - 0/1 u8 are the operands of wgmma u8 x u8 -> s32, both read from
//     shared memory: no f32 copy, and the counts are exact integers (i32
//     sums in any order);
//   - the masks are cut into tiles of 128; a block takes one tile pair
//     I <= J (only the upper triangle: inter is symmetric) of one image
//     over one chunk of pixels, so the grid (pairs, chunks, images) fills
//     the card even at B=4, K=50; the wrapper sizes the chunks from B, K, P
//     and the SM count (ops/mask_stats.py, `plan`).  Up to 128 masks
//     (CVPPP's 50 and 100) are one diagonal pair, so each mask byte crosses
//     from memory to an SM once; BBBC's 160 and 300 are 3 and 6 pairs,
//     each tile read by 2 and 3 of them (all but the first from L2);
//   - the pixels stream through a ring of stages of 128 pixels in shared
//     memory, filled by TMA in the 128-byte swizzled layout that wgmma
//     reads without bank conflicts (pixels past P read as zeros).  A
//     producer warp issues each stage's boxes once the consumers have
//     released its slot (an `empty` mbarrier); the consumers wait for the
//     boxes' bytes (a `full` mbarrier), so loads run ahead of the products;
//   - a mask row starts every P bytes, and CVPPP's P = 265,000 is a
//     multiple of 8 and not of 16, while TMA copies rows whose starts lie
//     a multiple of 16 bytes apart, from a 16-byte boundary.  The rows are
//     split by q mod `phases` (q = b K + m; phases = 16 / gcd(P, 16): 2 for
//     CVPPP, 1 for BBBC): each phase's rows are phases x P bytes apart and
//     start `off` bytes past a boundary, a 2-D tensor of their own.  A tile
//     holds its rows phase by phase, in boxes of a multiple of 8 rows; a
//     phase with off > 0 comes 16 bytes wider from the boundary into
//     staging rows, and the consumers move its 128 bytes into place (half
//     of CVPPP's rows); the epilogue maps each row back to its mask;
//   - two warpgroups each multiply 64 of tile I's 128 rows by tile J's
//     rows into 64 s32 registers per thread for the whole chunk, four
//     m64nNk32 wgmma per stage; in a diagonal pair the second warpgroup
//     takes only rows 64-127 as its columns (N = 64), since their products
//     with rows 0-63 are the first's;
//   - at the end every non-zero partial goes to the workspace's (min, max)
//     entry of its pair with one atomicAdd (red.global), once per pair:
//     exact and order-free;
//   - a second kernel writes the packed f32 [B, K, K+1(+1)]: inter[i][j]
//     from the workspace's (min, max) entry, the area of mask i from its
//     diagonal (m . m = sum m for 0/1 masks), the extra column copied.
//
// Two earlier designs ran on the older path to the tensor cores (cp.async,
// ldmatrix and mma.sync.m16n8k32): with 64-mask tiles CVPPP's 100 masks
// were read twice and the kernel read 22% of its bound; with 128-mask
// tiles the loads (8-byte copies for CVPPP's rows) and the mma.sync issue
// each took as long as the whole kernel should.  A first TMA design issued
// the copies from a consumer thread and stalled its warpgroup on each.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;              // masks per tile; a block takes a tile pair
constexpr int kStagePx = 128;           // pixels per stage: one 128-byte swizzled row
constexpr int kRegion = kTile * kStagePx;   // bytes of one tile's rows in one stage
constexpr int kConsumers = 256;         // two warpgroups multiply
constexpr int kThreads = kConsumers + 32;   // and one warp issues the copies
constexpr int kMaxPhases = 16;
constexpr int kStagedPitch = kStagePx + 16;  // a staged row: 16-byte aligned, 9 chunks

// TMA descriptors of the masks' rows, one 2-D tensor per phase: boxes of a
// full tile's rows of the phase, and of the last tile's
struct Maps {
  CUtensorMap full[kMaxPhases];
  CUtensorMap tail[kMaxPhases];
  int rows[kMaxPhases];                 // rows of each phase's tensor (0: none)
  int off[kMaxPhases];                  // its rows' start past a 16-byte boundary
  int staged[kMaxPhases];               // its place among the staged phases, or -1
  int staged_phase[kMaxPhases];         // the phase of each staged place
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// the copies' issue runs on a whole warp, its instructions predicated on
// `leader`, so that no lane of a warp that later runs wgmma branches off
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes, bool leader) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.u32 p, %2, 0;\n"
      "@p mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n}\n" ::"r"(smem_addr(bar)),
      "r"(bytes), "r"((unsigned)leader)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int x, int y,
                                         uint64_t* bar, bool leader) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.u32 p, %5, 0;\n"
      "@p cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n}\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(smem_addr(bar)),
      "r"((unsigned)leader)
      : "memory");
}

// K-major operand in the 128-byte swizzled layout: 8-row groups 1024 bytes
// apart (the stride byte offset); the leading byte offset is unused there
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  return ((uint64_t)(smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_and_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_n128(int (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.u8.u8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_n64(int (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.u8.u8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

// keeps the compiler from moving the accumulators across the asynchronous
// wgmma that writes them
__device__ __forceinline__ void fence_operands(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// first row, in phase `ph`'s tensor, of the masks from row q_start on
__device__ __forceinline__ int phase_row0(int q_start, int ph, int phases) {
  return (q_start - ph + phases - 1) / phases;
}

// the mask (index in its image) in shared row s of a tile's region, whose
// boxes of `box` rows per phase start at row q_start; -1 past the tile
__device__ __forceinline__ int row_mask(int s, int box, int phases, int q_start, int qb,
                                        int lo, int hi) {
  const int ph = s / box;
  if (ph >= phases) return -1;
  const int m = ph + phases * (phase_row0(q_start, ph, phases) + s - ph * box) - qb;
  return m >= lo && m < hi ? m : -1;
}

// bytes of one ring slot: the regions (one per tile of the pair) and their
// staging rows, rounded up so that every slot starts on a 1024-byte
// boundary (the swizzled layout repeats every 8 rows of 128 bytes)
__host__ __device__ __forceinline__ int slot_bytes(int regions, int staging_bytes) {
  return (regions * (kRegion + staging_bytes) + 1023) / 1024 * 1024;
}

__global__ void __launch_bounds__(kThreads, 2)
mask_stats_kernel(const __grid_constant__ Maps maps, int* __restrict__ ws, int K, int64_t P,
                  int tiles, int phases, int n_staged, int box_full, int box_tail,
                  int stages_per_chunk, int ring) {
  // grid: (tile pair, pixel chunk, image)
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  int I = 0, rem = blockIdx.x;
  while (rem >= tiles - I) rem -= tiles - I, ++I;
  const int J = I + rem;
  const bool diag = I == J;
  const int regions = diag ? 1 : 2;
  const int staging_bytes = n_staged * box_full * kStagedPitch;    // per region
  const int stage_bytes = slot_bytes(regions, staging_bytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + ring * stage_bytes);
  uint64_t* empty = full + ring;
  const int qb = blockIdx.z * K;                          // the image's first row
  const int box_i = I == tiles - 1 ? box_tail : box_full;
  const int box_j = J == tiles - 1 ? box_tail : box_full;
  const int qi = qb + I * kTile, qj = qb + J * kTile;
  const int64_t px_begin = (int64_t)blockIdx.y * stages_per_chunk * kStagePx;
  const int64_t px_end = min(P, px_begin + (int64_t)stages_per_chunk * kStagePx);
  const int n_stages = (int)((px_end - px_begin + kStagePx - 1) / kStagePx);

  if (threadIdx.x == 0) {
    for (int st = 0; st < ring; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // the producer warp (lane 0's instructions): each stage's boxes once
    // the consumers have released its slot.  A phase whose rows start on a
    // 16-byte boundary goes straight to its rows [ph box, (ph + 1) box) of
    // its tile's region (I first; a diagonal pair has one); any other
    // phase, whose rows TMA cannot start mid-chunk, goes 16 bytes wider
    // from the boundary before each row into the region's staging rows
    const bool leader = threadIdx.x == kConsumers;
    const CUtensorMap* map_i = I == tiles - 1 ? maps.tail : maps.full;
    const CUtensorMap* map_j = J == tiles - 1 ? maps.tail : maps.full;
    unsigned bytes = 0;
    for (int ph = 0; ph < phases; ++ph) {
      if (maps.rows[ph] == 0) continue;
      bytes += (box_i + (diag ? 0 : box_j)) * (maps.staged[ph] < 0 ? kStagePx : kStagedPitch);
      if (leader) {
        asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map_i[ph])));
        asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map_j[ph])));
      }
    }
    for (int stage = 0; stage < n_stages; ++stage) {
      unsigned char* slot = smem + (stage % ring) * stage_bytes;
      mbar_wait(&empty[stage % ring], ((stage / ring) & 1) ^ 1);
      uint64_t* bar = &full[stage % ring];
      mbar_expect_tx(bar, bytes, leader);
      const int x = (int)(px_begin + (int64_t)stage * kStagePx);
      for (int ph = 0; ph < phases; ++ph) {
        if (maps.rows[ph] == 0) continue;
        const int st = maps.staged[ph];
        for (int r = 0; r < regions; ++r) {
          const int box = r ? box_j : box_i;
          unsigned char* dst =
              st < 0 ? slot + r * kRegion + ph * box * kStagePx
                     : slot + regions * kRegion + r * staging_bytes + st * box * kStagedPitch;
          tma_load(dst, r ? &map_j[ph] : &map_i[ph], x, phase_row0(r ? qj : qi, ph, phases),
                   bar, leader);
        }
      }
    }
    return;
  }

  // the consumers: warpgroup wg multiplies its 64 rows of tile I (rows
  // [64 wg, 64 wg + 64) of the first region) by tile J's rows.  In a
  // diagonal pair the second warpgroup takes only rows 64-127 as its
  // columns: their products with rows 0-63 are the first's
  const int wg = threadIdx.x >> 7;
  const bool active = wg * 64 < phases * box_i;
  const bool n128 = phases * box_j > 64 && !(diag && wg == 1);
  const int col0 = diag && wg == 1 ? 64 : 0;     // the first column's row in J's region
  int d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0;

  for (int it = 0; it < n_stages; ++it) {
    unsigned char* slot = smem + (it % ring) * stage_bytes;
    mbar_wait(&full[it % ring], (it / ring) & 1);
    if (n_staged) {
      // each staged row's 128 bytes from `off` on, 16 at a time, into its
      // row of the region in the swizzled layout TMA writes (16-byte chunk
      // c of row s at c ^ (s % 8)), then made visible to wgmma
      for (int r = 0; r < regions; ++r) {
        const int box = r ? box_j : box_i;
        for (int st = 0; st < n_staged; ++st) {
          const int ph = maps.staged_phase[st], q = maps.off[ph] >> 2, sh = 8 * (maps.off[ph] & 3);
          const unsigned char* staging =
              slot + regions * kRegion + r * staging_bytes + st * box * kStagedPitch;
          unsigned char* region = slot + r * kRegion + ph * box * kStagePx;
          for (int idx = threadIdx.x; idx < box * 8; idx += kConsumers) {
            const int c = idx & 7, t = idx >> 3;
            const uint4 lo = *reinterpret_cast<const uint4*>(staging + t * kStagedPitch + 16 * c);
            const uint4 hi =
                *reinterpret_cast<const uint4*>(staging + t * kStagedPitch + 16 * c + 16);
            const unsigned w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
            unsigned v[5];
#pragma unroll
            for (int k = 0; k < 5; ++k)
              v[k] = q == 0 ? w[k] : q == 1 ? w[k + 1] : q == 2 ? w[k + 2] : w[k + 3];
            // row ph box + t of the region: box is a multiple of 8, so its
            // swizzle row is t % 8
            *reinterpret_cast<uint4*>(region + t * kStagePx + 16 * (c ^ (t & 7))) =
                make_uint4(__funnelshift_r(v[0], v[1], sh), __funnelshift_r(v[1], v[2], sh),
                           __funnelshift_r(v[2], v[3], sh), __funnelshift_r(v[3], v[4], sh));
          }
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
    }
    __syncwarp();                          // wgmma runs on converged warps
    if (active) {
      const unsigned char* a = slot + wg * 64 * kStagePx;
      const unsigned char* bm = slot + (diag ? 0 : kRegion) + col0 * kStagePx;
      fence_operands(d);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < kStagePx; k += 32) {
        if (n128)
          wgmma_n128(d, smem_desc(a + k), smem_desc(bm + k));
        else
          wgmma_n64(d, smem_desc(a + k), smem_desc(bm + k));
      }
      wgmma_commit_and_wait();
      fence_operands(d);
    }
    mbar_arrive(&empty[it % ring]);
  }
  if (!active) return;

  // register 4c + 2h + e holds (row 16 w + lane / 4 + 8 h, column 8 c +
  // 2 (lane % 4) + e) of the warpgroup's 64 x N product, w its warp.  Each
  // pair of masks goes to the workspace's (min, max) entry once: where the
  // warpgroup computed both (a, b) and (b, a) (a diagonal pair's rows and
  // columns on the same side of row 64), only the one with a <= b
  int* wsb = ws + (int64_t)blockIdx.z * K * K;
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
  const int lo_i = I * kTile, hi_i = min(K, lo_i + kTile);
  const int lo_j = J * kTile, hi_j = min(K, lo_j + kTile);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = row_mask(wg * 64 + 16 * w + (lane >> 2) + 8 * h, box_i, phases, qi, qb,
                           lo_i, hi_i);
    if (i < 0) continue;
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      if (c >= 8 && !n128) break;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = col0 + 8 * c + 2 * (lane & 3) + e;
        const int j = row_mask(col, box_j, phases, qj, qb, lo_j, hi_j);
        const int v = d[4 * c + 2 * h + e];
        const bool both = diag && (col < 64) == (wg == 0);
        if (v != 0 && j >= 0 && (!both || i <= j))
          atomicAdd(wsb + (int64_t)min(i, j) * K + max(i, j), v);
      }
    }
  }
}

// out[b, i, j] = inter (the workspace's (min, max) entry) for j < K, the
// area (the diagonal) at j = K, extra[b, i] at j = K + 1
__global__ void pack_kernel(const int* __restrict__ ws, const float* __restrict__ extra,
                            float* __restrict__ out, int K, int cols, int64_t n) {
  for (int64_t idx = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; idx < n;
       idx += (int64_t)gridDim.x * blockDim.x) {
    const int j = (int)(idx % cols);
    const int64_t bi = idx / cols;
    const int i = (int)(bi % K);
    const int* w = ws + (bi - i) * K;      // image bi / K
    float v;
    if (j < K)
      v = (float)w[(int64_t)min(i, j) * K + max(i, j)];
    else if (j == K)
      v = (float)w[(int64_t)i * K + i];
    else
      v = extra[bi];
    out[idx] = v;
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up through the runtime (no libcuda link)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// rows of a box: a tile's rows of one phase, rounded up to the 8-row groups
// of the swizzled layout so that every box starts on one
int box_rows(int n, int phases) { return ((n + phases - 1) / phases + 7) / 8 * 8; }

// a phase's rows as a 2-D tensor from the 16-byte boundary at or before its
// first row's start, rows phases x P bytes apart; boxes 128 bytes wide in
// the swizzled layout where the rows start on the boundary (off = 0), else
// 144 bytes wide and plain, for staging
bool encode(EncodeTiled fn, CUtensorMap* map, const unsigned char* row, int64_t P, int off,
            int rows, int phases, int box) {
  const cuuint64_t dim[2] = {(cuuint64_t)(P + off), (cuuint64_t)rows};
  const cuuint64_t stride[1] = {(cuuint64_t)(phases * P)};
  const cuuint32_t boxdim[2] = {(cuuint32_t)(off ? kStagedPitch : kStagePx), (cuuint32_t)box};
  const cuuint32_t step[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<unsigned char*>(row - off), dim,
            stride, boxdim, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
            off ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the ring holds as many stages as leave room for two blocks on an SM
// (between 2 and 8): 6 of 16 KB for BBBC's single tile of one phase, 4 of
// 25 KB for CVPPP's with its staging rows, 3 of 32 KB for two tiles
constexpr int kRingBytes = 110 * 1024;

cudaError_t launch(const Maps& maps, int* ws, int B, int K, int64_t P, int tiles, int phases,
                   int n_staged, int box_full, int box_tail, int chunks, int stages_per_chunk,
                   cudaStream_t s) {
  const int slot = slot_bytes(tiles > 1 ? 2 : 1, n_staged * box_full * kStagedPitch);
  const int fit = kRingBytes / slot, ring = fit < 2 ? 2 : fit > 8 ? 8 : fit;
  const int smem = ring * slot + ring * 16 + 1024;
  cudaError_t e = cudaFuncSetAttribute(mask_stats_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  mask_stats_kernel<<<dim3(tiles * (tiles + 1) / 2, chunks, B), kThreads, smem, s>>>(
      maps, ws, K, P, tiles, phases, n_staged, box_full, box_tail, stages_per_chunk, ring);
  return cudaGetLastError();
}

}  // namespace

// masks [B, K, P] u8 (0/1), extra [B, K] f32 or NULL, ws [B, K, K] i32
// scratch, out [B, K, K + 1 + (extra != NULL)] f32; tiles = ceil(K / 128);
// the pixels in `chunks` chunks of `stages_per_chunk` stages of 128
extern "C" int pctrans_mask_stats(const void* masks, const void* extra, void* ws, void* out,
                                  int B, int K, long long P, int tiles, int chunks,
                                  int stages_per_chunk, void* stream) {
  if (B <= 0 || K <= 0) return (int)cudaSuccess;
  if (P < 0 || P >= INT32_MAX - 16 || (int64_t)B * K >= INT32_MAX ||
      tiles != (K + kTile - 1) / kTile || chunks < 1 || chunks > 65535 || B > 65535 ||
      stages_per_chunk < 1 || (int64_t)chunks * stages_per_chunk * kStagePx < P)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(ws, 0, (size_t)B * K * K * sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  if (P > 0) {
    const EncodeTiled fn = encode_tiled();
    if (fn == nullptr) return (int)cudaErrorNotSupported;
    // rows q = b K + m start q P bytes in: split them by q mod phases, so
    // that each phase's rows lie phases x P bytes apart, a multiple of 16
    int phases = 16;
    while (phases > 1 && (P * (phases / 2)) % 16 == 0) phases /= 2;
    const int box_full = box_rows(kTile, phases);
    const int box_tail = box_rows(K - (tiles - 1) * kTile, phases);
    const unsigned char* m = static_cast<const unsigned char*>(masks);
    Maps maps = {};
    int n_staged = 0;
    for (int ph = 0; ph < phases; ++ph) {
      const int n = B * K;
      const unsigned char* row = m + ph * P;
      maps.rows[ph] = n > ph ? (n - ph + phases - 1) / phases : 0;
      maps.off[ph] = (int)(reinterpret_cast<uintptr_t>(row) & 15);
      maps.staged[ph] = maps.off[ph] ? n_staged : -1;
      if (maps.off[ph]) maps.staged_phase[n_staged++] = ph;
      if (maps.rows[ph] == 0) continue;
      if (!encode(fn, &maps.tail[ph], row, P, maps.off[ph], maps.rows[ph], phases, box_tail) ||
          (tiles > 1 &&
           !encode(fn, &maps.full[ph], row, P, maps.off[ph], maps.rows[ph], phases, box_full)))
        return (int)cudaErrorInvalidValue;
    }
    e = launch(maps, static_cast<int*>(ws), B, K, P, tiles, phases, n_staged, box_full,
               box_tail, chunks, stages_per_chunk, s);
    if (e != cudaSuccess) return (int)e;
  }
  const int cols = K + 1 + (extra != nullptr);
  const int64_t n = (int64_t)B * K * cols;
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  pack_kernel<<<blocks, 256, 0, s>>>(static_cast<const int*>(ws),
                                     static_cast<const float*>(extra),
                                     static_cast<float*>(out), K, cols, n);
  return (int)cudaGetLastError();
}
