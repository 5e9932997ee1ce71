// Tensor-core tile machinery of the bfloat16 flash-attention kernels
// (attn_fwd.cu: K2-fwd, attn_dq.cu: K2-dq, attn_dkv.cu: K2-dkv) for
// Hopper (sm_90a); the primitives under it are tc_common.cuh's.
//
// Products run on the bf16 tensor cores as warpgroup-wide
// wgmma.mma_async m64nNk16 (bf16 in, float32 accumulators). The score
// products read both operands from shared memory (K-major); the
// accumulating products take their A operand - p or ds, rounded to bf16
// - from registers and their B operand from shared memory through the
// instruction's transpose flag (MN-major). The float32 instances of the
// kernels keep the CUDA-core code of attn_common.cuh: their bar
// against the plain versions (rtol 1e-4, atol 1e-5) rules out TF32.
//
// A block owns 128 rows of the output (64 at head_dim > 128; K2-fwd: 64
// with one warpgroup for a sequence of at most 64) - query rows of o and
// dq, key rows of dk/dv - so no atomics are needed and the
// result is the same bits from run to run. Its 2 warpgroups (4 warps,
// 128 threads each) own 64 rows each and share the streamed tiles; at
// head_dim > 128 they split the accumulator columns of the block's 64
// rows instead, each recomputing the score tile, so that a thread holds
// at most 2 x 64 accumulator floats.
//
// Shared memory holds bfloat16 tiles of 64 rows x DP columns, DP the
// head_dim rounded up to a power of two of at least 64 (64, 128, 256:
// a smaller head_dim is zero-padded to 64, the width of one 128-byte
// swizzle row). A tile is DP / 64 blocks of 64 rows x 128 bytes, each
// 128-byte row with the 128-byte swizzle (16-byte piece p of row r at
// p ^ (r % 8)), the layout the wgmma descriptors name, free of bank
// conflicts. Columns [d, DP) and rows past the sequence are zero, so
// they add nothing to a product; rows past the sequence are also masked
// (p = 0) and never stored. Two resident tiles are loaded once; the two
// streamed tiles go through a ring of 2 stages: tile t + 1 is in flight
// while tile t is multiplied.
//
// Load paths, picked by the C entry from what it is given:
//   VEC   every bf16 base pointer 16-byte aligned and d % 8 == 0: rows
//         are copied in 16-byte cp.async pieces (zero-filled past the
//         sequence within the head, so nothing of the next head is read)
//         and columns [d, DP) are zeroed once per block;
//   !VEC  any d or alignment (head_dim 7 of seq_mnist is 14-byte rows,
//         a view with a storage offset may be 2-byte aligned): element
//         loads into the zero-padded tile, and element stores.
// Both paths compute the same products on the tensor cores.
//
// Past head_dim 256 neither the resident 64 x DP tiles nor one
// warpgroup's float32 accumulator over all of d fit any more (a 64 x 512
// accumulator is 256 floats a thread). Two routes take such heads:
//
// The whole-head route (256 < head_dim <= 512; K2-fwd and K2-dkv): a
// block spans the whole head (K2-dkv: a cluster of two blocks, one half
// each), so every score tile is computed once. One warpgroup computes
// the score tiles over all of d; the block's other warpgroups each own
// a slice of the output columns and take p (or p^T and ds^T), rounded
// to bf16, from shared memory as the A operand of their products. The
// operands fixed for the block's life are staged once (K2-fwd: q, then
// held as A fragments in the score warpgroup's registers; K2-dkv: the
// block's half of k and v); the streamed tiles (k and v; q, do, lse and
// delta) have kHeadRows = 32 rows, so that three stages of the stream,
// the resident tiles and the p tiles fit a block's shared memory. A
// step of the block's loop is one streamed tile: the score
// warpgroup takes tile i while the others multiply with tile i - 1 and
// the copies of the next tile are in flight; a barrier (K2-dkv: a
// cluster barrier) opens each step. Tiles are the swizzled 64-column
// blocks below, of 64 or 32 rows (swz_r, kstep_r).
//
// The chunked route (head_dim > 512, and K2-dq past 256): d is cut
// into chunks of kWideCols = 128 columns, the geometry of the DP 128
// instances (two swizzled 64-column blocks a tile). A block is one
// warpgroup that owns 64 rows and the 128 output columns [c0, c0 + 128)
// of them; the d / 128 blocks of one row range each recompute the score
// tiles they need, so the route executes (d + 128) / 256 x the useful
// products in K2-fwd, (d + 64) / 192 x in K2-dq and (d + 128) / 256 x in
// K2-dkv (2.5x, 3.0x and 2.5x at d 512). Each
// score product (q.k^T, do.v^T) is summed chunk by chunk into its
// float32 accumulator (wg_score_chunk), the chunk pair staged in one
// stage of a 2-stage ring of asynchronous copies; the step after the
// last chunk stages the 128 columns of the accumulating product's B
// operand (v, k, or do and q). Every step is one stage of two 64 x 128
// tiles, so tile i + 1 of the step sequence is in flight while tile i is
// multiplied. stage_chunk (stage_rows) zero-fills columns past d and
// rows past the sequence on both load paths.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_common.cuh"

#include <initializer_list>

namespace attn_tc {

using namespace tc;

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;     // rows of every tile, owned or streamed
constexpr int kStages = 2;    // depth of the streamed ring
constexpr float kLog2e = 1.4426950408889634f;

// A block is 2 warpgroups (256 threads). Up to DP 128 each owns 64 of
// the block's 128 rows (rowg = 2); at DP 256 both take the block's 64
// rows and split the accumulator columns (nsplit = 2), so that a thread
// holds at most 2 x 64 accumulator floats.
constexpr int kTcThreads = 256;
__host__ __device__ constexpr int nsplit(int dp) { return dp > 128 ? 2 : 1; }
__host__ __device__ constexpr int rowg(int dp) { return 2 / nsplit(dp); }

// Blocks along a sequence of `rows` rows: rowg(dp) x 64 rows each.
inline int own_tiles(int rows, int dp) {
  const int own = kRows * rowg(dp);
  return (rows + own - 1) / own;
}

// One 64-column block of a staged tile: 64 rows of 128 bytes, 8 KB.
constexpr int kBlkBytes = kRows * 128;

// Elements of one staged tile: 64 rows x DP columns, as DP / 64 blocks.
template <int DP>
__host__ __device__ constexpr int tile_elems() {
  return kRows * DP;
}

// Dynamic shared memory of a kernel instance: 2 resident tiles per 64
// owned rows, the ring of 2 tiles per stage, `stat_floats` float32
// values, and 1 KB of slack to align the base to the 1,024-byte swizzle
// atom.
template <int DP>
constexpr size_t smem_bytes(int stat_floats) {
  return (size_t)(2 * rowg(DP) + 2 * kStages) * tile_elems<DP>() *
             sizeof(bf16) +
         (size_t)stat_floats * sizeof(float) + 1024;
}

// Byte offset of element (r, c) in a staged tile: the 128-byte swizzle -
// 16-byte piece c / 8 of row r sits at piece (c / 8) ^ (r % 8) of its
// 128-byte row within the row's 64-column block.
__device__ __forceinline__ int swz(int r, int c) {
  return (c >> 6) * kBlkBytes + r * 128 +
         ((((c >> 3) & 7) ^ (r & 7)) << 4) + ((c & 7) << 1);
}

// K-major operand: the 64 rows of a tile, its first 16 columns as the
// contraction. 8-row groups are 1,024 bytes apart; k-step kk starts
// kstep(kk) further (32 bytes a step inside a 64-column block).
__device__ __forceinline__ uint64_t desc_k(const bf16* tile) {
  return desc(tile, 16, 1024);
}

// MN-major operand (transposed B): the tile's first 16 rows as the
// contraction, columns [col0, col0 + N) as N. 8-row groups are 1,024
// bytes apart (stride offset), 64-column blocks kBlkBytes (leading); a
// k-step of 16 rows moves the start 2,048 bytes.
__device__ __forceinline__ uint64_t desc_mn(const bf16* tile, int col0) {
  return desc(reinterpret_cast<const char*>(tile) + (col0 >> 6) * kBlkBytes,
              kBlkBytes, 1024);
}

// d (64 x 64, float32) = A (64 x 16, smem) . B (64 x 16, smem)^T, plus
// d itself when `accumulate`; both K-major (no transpose).
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64, float32) += A (64 x 16, bf16 fragments in registers) .
// B (16 x 64, smem, MN-major: transposed).
__device__ __forceinline__ void wgmma_rs(float (&d)[8][4],
                                         const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 128, float32) += A (64 x 16, bf16 fragments in registers) .
// B (16 x 128, smem, MN-major: transposed).
__device__ __forceinline__ void wgmma_rs(float (&d)[16][4],
                                         const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


// Two float32 values rounded to bf16 (to nearest even, as torch casts),
// lo in the low half: one 32-bit fragment register.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Stage rows [row0, row0 + kRows) of a row-major (rows, d) bf16 matrix
// as a swizzled tile (see the load paths above). NT threads.
template <int DP, int NT, bool VEC>
__device__ __forceinline__ void stage_tile(bf16* __restrict__ dst,
                                           const bf16* __restrict__ src,
                                           int row0, int rows, int d) {
  char* base = reinterpret_cast<char*>(dst);
  if constexpr (VEC) {
    const int cpr = d >> 3;  // 16-byte pieces per row
    for (int i = threadIdx.x; i < kRows * cpr; i += NT) {
      const int r = i / cpr;
      const int c = (i - r * cpr) << 3;
      const int gr = row0 + r;
      const bool ok = gr < rows;
      cp_async16(base + swz(r, c), ok ? src + (long long)gr * d + c : src,
                 ok);
    }
  } else {
    for (int i = threadIdx.x; i < kRows * DP; i += NT) {
      const int r = i / DP;
      const int c = i - r * DP;
      const int gr = row0 + r;
      bf16 val = __float2bfloat16(0.f);
      if (gr < rows && c < d) val = src[(long long)gr * d + c];
      *reinterpret_cast<bf16*>(base + swz(r, c)) = val;
    }
  }
}

// Zero columns [d, DP) of `ntiles` consecutive tiles (the VEC path copies
// columns [0, d) only).
template <int DP, int NT>
__device__ __forceinline__ void zero_cols(bf16* __restrict__ dst, int ntiles,
                                          int d) {
  const int w = DP - d;
  for (int i = threadIdx.x; i < ntiles * kRows * w; i += NT) {
    const int r = i / w;  // row over all tiles
    *reinterpret_cast<bf16*>(reinterpret_cast<char*>(dst) +
                             (r / kRows) * tile_elems<DP>() * 2 +
                             swz(r % kRows, d + (i - r * w))) =
        __float2bfloat16(0.f);
  }
}

// kRows float32 values [row0, row0 + kRows) of a (rows,) vector,
// asynchronously, zero past `rows`.
template <int NT>
__device__ __forceinline__ void load_stats(float* __restrict__ dst,
                                           const float* __restrict__ src,
                                           int row0, int rows) {
  for (int i = threadIdx.x; i < kRows; i += NT) {
    const int gr = row0 + i;
    const bool ok = gr < rows;
    cp_async4(dst + i, ok ? src + gr : src, ok);
  }
}

// The start-address step (16-byte units, added to a descriptor) of
// k-step kk of a K-major tile: the start field holds at most 14 bits of a
// shared address, so the addition never carries out of it.
__host__ __device__ constexpr uint64_t kstep(int kk) {
  return (uint64_t)(((kk >> 2) * kBlkBytes + (kk & 3) * 32) >> 4);
}

// The score products of one warpgroup, issued, not waited on: acc
// (64 x 64) = A[64 rows] . B[64 rows]^T over DP columns, both K-major.
// The accumulator fragment of thread (warp w of the warpgroup, lane
// 4 g + t): acc[j] holds rows 16 w + g, 16 w + g + 8 and columns 8 j + 2 t,
// 8 j + 2 t + 1, as {(g, c), (g, c+1), (g+8, c), (g+8, c+1)} - per warp,
// the m16n8 accumulator layout of mma.sync. a and b are the tiles' base
// descriptors, desc_k(A) and desc_k(B).
template <int DP>
__device__ __forceinline__ void wg_score(float (&acc)[kRows / 8][4],
                                         uint64_t a, uint64_t b) {
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    wgmma_ss(acc, a + kstep(kk), b + kstep(kk), kk > 0);
}
template <int DP>
__device__ __forceinline__ void wg_score(float (&acc)[kRows / 8][4],
                                         const bf16* A, const bf16* B) {
  wg_score<DP>(acc, desc_k(A), desc_k(B));
}

// A descriptor laundered through an empty asm, so that the compiler
// cannot hoist the k-step descriptors derived from it out of a loop:
// the loop keeps one 64-bit base live instead of one per k-step.
__device__ __forceinline__ uint64_t opaque(uint64_t d) {
  asm volatile("" : "+l"(d));
  return d;
}

// P (64 x 64 float32, a score accumulator) rounded to bf16 in registers
// as the A fragments of the next product: its m16n8 layout is exactly
// the A operand's (FA2's register reuse), so P never goes through
// shared memory.
__device__ __forceinline__ void pack_a(uint32_t (&a)[kRows / 16][4],
                                       const float (&p)[kRows / 8][4]) {
#pragma unroll
  for (int ks = 0; ks < kRows / 16; ++ks) {
    a[ks][0] = pack_bf16(p[2 * ks][0], p[2 * ks][1]);
    a[ks][1] = pack_bf16(p[2 * ks][2], p[2 * ks][3]);
    a[ks][2] = pack_bf16(p[2 * ks + 1][0], p[2 * ks + 1][1]);
    a[ks][3] = pack_bf16(p[2 * ks + 1][2], p[2 * ks + 1][3]);
  }
}

// The accumulating product of one warpgroup, issued, not waited on:
// acc (64 x DC) += P (64 x 64, packed) . X[64 rows, columns col0 ..
// col0 + DC), X row-major over the contraction (MN-major B, the
// instruction's transpose flag). x is the base descriptor
// desc_mn(X, col0); k-step ks starts 16 rows of 128 bytes further.
template <int DC>
__device__ __forceinline__ void wg_acc(float (&acc)[DC / 8][4],
                                       const uint32_t (&a)[kRows / 16][4],
                                       uint64_t x) {
#pragma unroll
  for (int ks = 0; ks < kRows / 16; ++ks)
    wgmma_rs(acc, a[ks], x + (uint64_t)(ks * 16 * 128 >> 4));
}
template <int DC>
__device__ __forceinline__ void wg_acc(float (&acc)[DC / 8][4],
                                       const uint32_t (&a)[kRows / 16][4],
                                       const bf16* X, int col0) {
  wg_acc<DC>(acc, a, desc_mn(X, col0));
}

// Store one warp's 16 x DC accumulator rows, times `mul`, rounded to
// bf16: rows row0 + g (+ 8) below `rows`, columns col0 + 8 j + 2 t (+ 1)
// below d. VEC: pairs as one 4-byte store (d is even, out aligned).
template <int DC, bool VEC>
__device__ __forceinline__ void store_rows(bf16* __restrict__ out,
                                           const float (&acc)[DC / 8][4],
                                           int row0, int rows, int d,
                                           int col0, float mul, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + g + 8 * half;
    if (r >= rows) continue;
    bf16* o = out + (long long)r * d;
#pragma unroll
    for (int j = 0; j < DC / 8; ++j) {
      const int c = col0 + 8 * j + 2 * t;
      const float v0 = acc[j][2 * half] * mul;
      const float v1 = acc[j][2 * half + 1] * mul;
      if constexpr (VEC) {
        if (c < d)
          *reinterpret_cast<__nv_bfloat162*>(o + c) =
              __floats2bfloat162_rn(v0, v1);
      } else {
        if (c < d) o[c] = __float2bfloat16(v0);
        if (c + 1 < d) o[c + 1] = __float2bfloat16(v1);
      }
    }
  }
}

// The chunked route (see the header): chunk width, threads a block (one
// warpgroup), elements of a staged chunk, and the dynamic shared memory
// of every chunked kernel: 2 stages of 2 chunks and 1 KB of alignment
// slack.
constexpr int kWideCols = 128;
constexpr int kWideThreads = 128;
constexpr int kWideTE = kRows * kWideCols;
constexpr size_t kWideTcSmem =
    (size_t)2 * kStages * kWideTE * sizeof(bf16) + 1024;

// Chunks of kWideCols columns in a row of d.
__host__ __device__ inline int wide_chunks(int d) {
  return (d + kWideCols - 1) / kWideCols;
}

// Byte offset of element (r, c) in a swizzled tile of R rows: 64-column
// blocks of R rows x 128 bytes, the 128-byte swizzle inside each (swz is
// swz_r<64>).
template <int R>
__device__ __forceinline__ int swz_r(int r, int c) {
  return (c >> 6) * (R * 128) + r * 128 + ((((c >> 3) & 7) ^ (r & 7)) << 4) +
         ((c & 7) << 1);
}

// Stage rows [row0, row0 + R) and columns [col0, col0 + W) of a
// row-major (rows, ld) bf16 matrix as an R x W swizzled tile; rows >=
// `rows` and columns >= ld are zero. VEC: 16-byte cp.async pieces (ld
// and col0 multiples of 8), zero-filled where they lie outside; else
// element loads. NT threads, this one tid of them. The element loop is
// kept rolled (the kernels stage while their accumulators are live);
// ROLLED keeps the cp.async loop rolled too (the whole-head route,
// whose staging warpgroups hold their accumulators within their
// setmaxnreg share), while the chunked route leaves it to the compiler
// to unroll, which K2-dq's chunked instance measured faster.
template <int R, int W, int NT, bool VEC, bool ROLLED = true>
__device__ __forceinline__ void stage_rows(bf16* __restrict__ dst,
                                           const bf16* __restrict__ src,
                                           int row0, int rows, int ld,
                                           int col0, int tid) {
  char* base = reinterpret_cast<char*>(dst);
  if constexpr (VEC) {
    constexpr int PR = W / 8;  // pieces a row
    auto piece = [&](int i) {
      const int r = i / PR;
      const int c = (i - r * PR) << 3;
      const int gr = row0 + r;
      const bool ok = gr < rows && col0 + c < ld;
      cp_async16(base + swz_r<R>(r, c),
                 ok ? src + (long long)gr * ld + col0 + c : src, ok);
    };
    if constexpr (ROLLED) {
#pragma unroll 1
      for (int i = tid; i < R * PR; i += NT) piece(i);
    } else {
      for (int i = tid; i < R * PR; i += NT) piece(i);
    }
  } else {
#pragma unroll 1
    for (int i = tid; i < R * W; i += NT) {
      const int r = i / W;
      const int c = i - r * W;
      const int gr = row0 + r;
      bf16 val = __float2bfloat16(0.f);
      if (gr < rows && col0 + c < ld)
        val = src[(long long)gr * ld + col0 + c];
      *reinterpret_cast<bf16*>(base + swz_r<R>(r, c)) = val;
    }
  }
}

// One 64 x 128 chunk of the chunked route, staged by the block's one
// warpgroup: stage_rows with its cp.async loop unrolled.
template <bool VEC>
__device__ __forceinline__ void stage_chunk(bf16* __restrict__ dst,
                                            const bf16* __restrict__ src,
                                            int row0, int rows, int ld,
                                            int col0) {
  stage_rows<kRows, kWideCols, kWideThreads, VEC, false>(
      dst, src, row0, rows, ld, col0, threadIdx.x);
}

// One chunk's share of a score product of one warpgroup, issued, not
// waited on: acc (64 x 64) += A[64 rows] . B[64 rows]^T over the 128
// columns of two staged chunks (both K-major), or = when `first` (the
// first chunk). a and b are desc_k of the chunks.
__device__ __forceinline__ void wg_score_chunk(float (&acc)[kRows / 8][4],
                                               uint64_t a, uint64_t b,
                                               bool first) {
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < kWideCols / 16; ++kk)
    wgmma_ss(acc, a + kstep(kk), b + kstep(kk), kk > 0 || !first);
}

// True when the VEC load path may run: every pointer 16-byte aligned and
// rows of a whole number of 16-byte pieces.
inline bool vec_ok(int d, std::initializer_list<const void*> ptrs) {
  if (d % 8 != 0) return false;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

// The instance for head_dim d: DP and the load path; CALL sees DP and
// VEC as constants; past 256 the chunked route, WIDE, which sees VEC
// (K2-fwd and K2-dkv take the whole-head route up to 512 before this).
#define ATTN_TC_DISPATCH(d, vec, CALL, WIDE) \
  do {                                 \
    if ((d) <= 64) {                   \
      constexpr int DP = 64;           \
      ATTN_TC_VEC(vec, CALL);          \
    }                                  \
    if ((d) <= 128) {                  \
      constexpr int DP = 128;          \
      ATTN_TC_VEC(vec, CALL);          \
    }                                  \
    if ((d) <= 256) {                  \
      constexpr int DP = 256;          \
      ATTN_TC_VEC(vec, CALL);          \
    }                                  \
    ATTN_TC_VEC(vec, WIDE);            \
  } while (0)

#define ATTN_TC_VEC(vec, CALL)   \
  do {                           \
    if (vec) {                   \
      constexpr bool VEC = true; \
      return CALL;               \
    }                            \
    constexpr bool VEC = false;  \
    return CALL;                 \
  } while (0)


// ---------------------------------------------------------------------------
// The whole-head route (see the header)
// ---------------------------------------------------------------------------

constexpr int kHeadRows = 32;   // rows of a streamed tile (keys or queries)
constexpr int kHeadMax = 512;   // the widest head the route takes
constexpr int kHalf = 256;      // columns of a K2-dkv block (one of two)

// The start-address step of k-step kk of a K-major R-row tile (kstep is
// kstep_r<64>).
template <int R>
__host__ __device__ constexpr uint64_t kstep_r(int kk) {
  return (uint64_t)(((kk >> 2) * R * 128 + (kk & 3) * 32) >> 4);
}

// MN-major operand of a 32-row tile: columns from col0 (a multiple of
// 64); 64-column blocks are 4,096 bytes apart (leading offset).
__device__ __forceinline__ uint64_t desc_mn32(const bf16* tile, int col0) {
  return desc(reinterpret_cast<const char*>(tile) +
                  (col0 >> 6) * (kHeadRows * 128),
              kHeadRows * 128, 1024);
}

// kHeadRows float32 values [row0, row0 + kHeadRows) of a (rows,) vector,
// asynchronously, zero past `rows`. NT threads, this one tid of them.
template <int NT>
__device__ __forceinline__ void load_stats32(float* __restrict__ dst,
                                             const float* __restrict__ src,
                                             int row0, int rows, int tid) {
  for (int i = tid; i < kHeadRows; i += NT) {
    const int gr = row0 + i;
    const bool ok = gr < rows;
    cp_async4(dst + i, ok ? src + gr : src, ok);
  }
}

// Named barriers between the warpgroups of a block, reached from their
// own code paths (so without the .aligned promise): bar_sync waits until
// `n` threads have reached barrier `id`, bar_arrive counts this thread
// and goes on.
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("barrier.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("barrier.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

#define ATTN_TC_F4(i) "+f"(d[i][0]), "+f"(d[i][1]), "+f"(d[i][2]), "+f"(d[i][3])

// d (64 x 32, float32) = A (64 x 16, smem) . B (32 x 16, smem)^T, plus d
// itself when `accumulate`; both K-major.
__device__ __forceinline__ void wgmma_ss32(float (&d)[4][4], uint64_t a,
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : ATTN_TC_F4(0), ATTN_TC_F4(1), ATTN_TC_F4(2),
        ATTN_TC_F4(3)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 128, float32) += A (64 x 16, smem, K-major) . B (16 x 128,
// smem, MN-major: transposed).
__device__ __forceinline__ void wgmma_sst(float (&d)[16][4], uint64_t a,
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : ATTN_TC_F4(0), ATTN_TC_F4(1), ATTN_TC_F4(2),
        ATTN_TC_F4(3), ATTN_TC_F4(4), ATTN_TC_F4(5),
        ATTN_TC_F4(6), ATTN_TC_F4(7), ATTN_TC_F4(8),
        ATTN_TC_F4(9), ATTN_TC_F4(10), ATTN_TC_F4(11),
        ATTN_TC_F4(12), ATTN_TC_F4(13), ATTN_TC_F4(14),
        ATTN_TC_F4(15)
      : "l"(a), "l"(b), "r"(1));
}

// d (64 x 256, float32) += A (64 x 16, smem, K-major) . B (16 x 256,
// smem, MN-major: transposed).
__device__ __forceinline__ void wgmma_sst(float (&d)[32][4], uint64_t a,
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : ATTN_TC_F4(0), ATTN_TC_F4(1), ATTN_TC_F4(2),
        ATTN_TC_F4(3), ATTN_TC_F4(4), ATTN_TC_F4(5),
        ATTN_TC_F4(6), ATTN_TC_F4(7), ATTN_TC_F4(8),
        ATTN_TC_F4(9), ATTN_TC_F4(10), ATTN_TC_F4(11),
        ATTN_TC_F4(12), ATTN_TC_F4(13), ATTN_TC_F4(14),
        ATTN_TC_F4(15), ATTN_TC_F4(16), ATTN_TC_F4(17),
        ATTN_TC_F4(18), ATTN_TC_F4(19), ATTN_TC_F4(20),
        ATTN_TC_F4(21), ATTN_TC_F4(22), ATTN_TC_F4(23),
        ATTN_TC_F4(24), ATTN_TC_F4(25), ATTN_TC_F4(26),
        ATTN_TC_F4(27), ATTN_TC_F4(28), ATTN_TC_F4(29),
        ATTN_TC_F4(30), ATTN_TC_F4(31)
      : "l"(a), "l"(b), "r"(1));
}

#undef ATTN_TC_F4

// A score tile of the whole-head route, issued, not waited on: s (64 x
// 32) = A[64 rows] . B[32 rows]^T over NK k-steps of 16 columns, A a
// 64-row tile and B a 32-row one, both K-major (a and b: desc_k). The
// fragment of thread (warp w, lane 4 g + t): s[j] holds rows 16 w + g,
// 16 w + g + 8 and columns 8 j + 2 t, 8 j + 2 t + 1, as wg_score's.
template <int NK>
__device__ __forceinline__ void wg_score32(float (&s)[kHeadRows / 8][4],
                                           uint64_t a, uint64_t b) {
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < NK; ++kk)
    wgmma_ss32(s, a + kstep_r<kRows>(kk), b + kstep_r<kHeadRows>(kk),
               kk > 0);
}

// An accumulating product of the whole-head route, issued, not waited
// on: acc (64 x N) += A (64 rows x 32, K-major: a = desc_k of a 64 x 64
// tile, plus 4 per 32 columns the A operand starts further) . X (32 rows
// x N, MN-major: x = desc_mn32).
template <int N>
__device__ __forceinline__ void wg_acc32(float (&acc)[N / 8][4], uint64_t a,
                                         uint64_t x) {
#pragma unroll
  for (int kk = 0; kk < kHeadRows / 16; ++kk)
    wgmma_sst(acc, a + 2 * kk, x + (uint64_t)(kk * 16 * 128 >> 4));
}

// Store a 16 x 32 fragment pair of one warp (rows r0, r0 + 8 of a 64 x
// 64 tile, columns col0 + 8 j + 2 t (+ 1)) as bf16 into the swizzled
// tile: the A operand of wg_acc32.
__device__ __forceinline__ void put_a32(bf16* __restrict__ tile,
                                        const float (&x)[kHeadRows / 8][4],
                                        int r0, int col0, int t4) {
  char* base = reinterpret_cast<char*>(tile);
#pragma unroll
  for (int j = 0; j < kHeadRows / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(base +
                                   swz_r<kRows>(r0 + 8 * h,
                                                col0 + 8 * j + 2 * t4)) =
          pack_bf16(x[j][2 * h], x[j][2 * h + 1]);
}

// d (64 x 32, float32) = A (64 x 16, bf16 fragments in registers) . B (32
// x 16, smem, K-major)^T, plus d itself when `accumulate`.
__device__ __forceinline__ void wgmma_rs32(float (&d)[4][4],
                                           const uint32_t (&a)[4], uint64_t b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

// Move registers between the warpgroups of a block (the whole warpgroup
// executes it): raise this warpgroup's limit to N a thread, or lower it.
template <int N>
__device__ __forceinline__ void reg_raise() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void reg_lower() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// The A fragments of rows [0, 64) x columns [16 kk, 16 kk + 16) of a
// swizzled 64-row tile, for each k-step kk < NK: thread (warp w, lane
// 4 g + t) holds rows 16 w + g (+ 8), columns 16 kk + 2 t (+ 1), + 8 (+ 1),
// the layout pack_a gives a score fragment.
template <int NK>
__device__ __forceinline__ void load_a(uint32_t (&a)[NK][4],
                                       const bf16* __restrict__ tile,
                                       int r0, int t4) {
  const char* base = reinterpret_cast<const char*>(tile);
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    const int c = 16 * kk + 2 * t4;
    a[kk][0] = *reinterpret_cast<const uint32_t*>(base + swz_r<kRows>(r0, c));
    a[kk][1] =
        *reinterpret_cast<const uint32_t*>(base + swz_r<kRows>(r0 + 8, c));
    a[kk][2] =
        *reinterpret_cast<const uint32_t*>(base + swz_r<kRows>(r0, c + 8));
    a[kk][3] = *reinterpret_cast<const uint32_t*>(
        base + swz_r<kRows>(r0 + 8, c + 8));
  }
}

}  // namespace attn_tc
