// Tile helpers shared by the flash-attention kernels on the CUDA cores
// for Hopper (sm_90a): the float32 instances of attn_fwd.cu, attn_dq.cu
// and attn_dkv.cu (their bfloat16 instances run on the tensor cores,
// attn_tc.cuh).
//
// Every kernel works on 64 x 64 tiles: a block of 256 threads, seen as
// 16 x 16 (ty, tx), holds a resident 64-row tile of one operand in
// shared memory and walks the other operand's 64-row tiles in a loop -
// the loop takes the place of the TPU grid's sequential ("arbitrary")
// axis, and one block owns every output row it writes, so no atomics
// are needed. Thread (ty, tx) owns score-tile rows ty + 16 r and
// columns tx + 16 c (r, c < 4), and accumulator rows ty + 16 r and
// columns tx + 16 c (c < DP / 16).
//
// Tiles are staged as float32 with a row stride of DP + 1 words, DP the
// head_dim padded to a power of two in {16, ..., 256}: the odd stride
// puts the 16 rows a half-warp reads at one column on 16 different
// banks. Padding columns (>= d) and rows past the sequence are zero, so
// they change no dot product; rows past the sequence are also masked
// (p = 0) and never stored.
//
// The wide route (head_dim > 256, where a 64 x (d + 1) float32 tile per
// operand no longer fits a block's shared memory): d is cut into chunks
// of kWide columns. The score products (q.k^T, do.v^T) sum over the
// chunks, staged one pair at a time (tile_dot_acc); a block owns the
// kWide output columns [c0, c0 + kWide) of its rows and recomputes the
// score tile it needs, so the d / kWide blocks of one row range share no
// state and need no atomics.

#pragma once

#include <cuda_runtime.h>

namespace attn {

constexpr int kTile = 64;        // query rows and key rows per tile
constexpr int kThreads = 256;    // 16 x 16
constexpr int kPLd = kTile + 1;  // row stride of the 64 x 64 score tile
constexpr float kNeg = -1e30f;   // the masked score, as in the JAX package
constexpr int kWide = 128;       // columns of a chunk on the wide route

// Stage rows [row0, row0 + kTile) and columns [col0, col0 + w) of a
// row-major (rows, ld) matrix as a kTile x (W + 1) float32 tile; rows >=
// `rows` and columns >= w are 0. Neighbouring threads read neighbouring
// columns of one row.
template <int W>
__device__ __forceinline__ void load_cols(float* __restrict__ dst,
                                          const float* __restrict__ src,
                                          int row0, int rows, int ld,
                                          int col0, int w) {
  constexpr int tld = W + 1;
  for (int idx = threadIdx.x; idx < kTile * W; idx += kThreads) {
    int r = idx / W;
    int c = idx - r * W;
    int gr = row0 + r;
    float val = 0.f;
    if (gr < rows && c < w) val = src[(long long)gr * ld + col0 + c];
    dst[r * tld + c] = val;
  }
}

// Stage rows [row0, row0 + kTile) of a row-major (rows, d) matrix as a
// kTile x (DP + 1) float32 tile; rows >= `rows` and columns >= d are 0.
template <int DP>
__device__ __forceinline__ void load_tile(float* __restrict__ dst,
                                          const float* __restrict__ src,
                                          int row0, int rows, int d) {
  load_cols<DP>(dst, src, row0, rows, d, 0, d);
}

// s[r][c] += sum_{e < d} A[ty + 16 r][e] * B[tx + 16 c][e] over two
// staged tiles: a score tile A . B^T in float32, or one chunk's share of
// it on the wide route.
template <int DP>
__device__ __forceinline__ void tile_dot_acc(float (&s)[4][4],
                                             const float* __restrict__ A,
                                             const float* __restrict__ B,
                                             int d, int ty, int tx) {
  constexpr int ld = DP + 1;
#pragma unroll 4
  for (int e = 0; e < d; ++e) {
    float a[4], b[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = A[(ty + 16 * r) * ld + e];
#pragma unroll
    for (int c = 0; c < 4; ++c) b[c] = B[(tx + 16 * c) * ld + e];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = fmaf(a[r], b[c], s[r][c]);
  }
}

// s = A . B^T over e < d (tile_dot_acc from zero).
template <int DP>
__device__ __forceinline__ void tile_dot(float (&s)[4][4],
                                         const float* __restrict__ A,
                                         const float* __restrict__ B, int d,
                                         int ty, int tx) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
  tile_dot_acc<DP>(s, A, B, d, ty, tx);
}

// One score product of the wide route: s = A[a0 rows] . B[b0 rows]^T
// summed over the kWide-column chunks of d, each pair staged in As, Bs.
__device__ __forceinline__ void wide_dot(float (&s)[4][4], float* As,
                                         float* Bs, const float* a, int a0,
                                         int arows, const float* b, int b0,
                                         int brows, int d, int ty, int tx) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
  for (int e0 = 0; e0 < d; e0 += kWide) {
    const int w = d - e0 < kWide ? d - e0 : kWide;
    __syncthreads();  // the last chunk's (or tile's) reads are done
    load_cols<kWide>(As, a, a0, arows, d, e0, w);
    load_cols<kWide>(Bs, b, b0, brows, d, e0, w);
    __syncthreads();
    tile_dot_acc<kWide>(s, As, Bs, w, ty, tx);
  }
}

// acc[r][c] += sum_{j < n} P[ty + 16 r][j] * X[j][tx + 16 c]: a 64 x 64
// score-shaped tile (row stride kPLd) times a staged 64 x DP tile.
template <int DP>
__device__ __forceinline__ void tile_acc(float (&acc)[4][DP / 16],
                                         const float* __restrict__ P,
                                         const float* __restrict__ X, int n,
                                         int ty, int tx) {
  constexpr int ld = DP + 1;
  constexpr int NC = DP / 16;
#pragma unroll 4
  for (int j = 0; j < n; ++j) {
    float p[4], x[NC];
#pragma unroll
    for (int r = 0; r < 4; ++r) p[r] = P[(ty + 16 * r) * kPLd + j];
#pragma unroll
    for (int c = 0; c < NC; ++c) x[c] = X[j * ld + tx + 16 * c];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] = fmaf(p[r], x[c], acc[r][c]);
  }
}

// Bytes of dynamic shared memory for `tiles` staged 64 x (DP + 1) tiles
// and one 64 x 64 score tile.
template <int DP>
constexpr size_t smem_bytes(int tiles) {
  return (size_t)(tiles * kTile * (DP + 1) + kTile * kPLd) * sizeof(float);
}

// Launch `kernel` on `blocks` blocks with `smem` bytes of dynamic shared
// memory - above the 48 KB default only once the kernel's attribute is
// raised, which is done at its first launch (one instance of this
// template per kernel instance, and `smem` fixed by the instance).
template <auto kernel, typename... Args>
int launch(long long blocks, size_t smem, cudaStream_t stream,
           Args... args) {
  if (blocks <= 0) return (int)cudaGetLastError();
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  kernel<<<(unsigned int)blocks, kThreads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// Bytes of dynamic shared memory of a wide-route kernel: two staged
// 64 x (kWide + 1) chunks and one 64 x 64 score tile.
constexpr size_t kWideSmem = smem_bytes<kWide>(2);

// Chunks of kWide columns in a row of d.
__host__ __device__ inline int wide_chunks(int d) {
  return (d + kWide - 1) / kWide;
}

// The head_dim padded to a power of two: the template instance to run;
// past 256 the wide route, WIDE.
#define ATTN_DISPATCH_DP(d, CALL, WIDE) \
  do {                            \
    if ((d) <= 16) {              \
      constexpr int DP = 16;      \
      return CALL;                \
    }                             \
    if ((d) <= 32) {              \
      constexpr int DP = 32;      \
      return CALL;                \
    }                             \
    if ((d) <= 64) {              \
      constexpr int DP = 64;      \
      return CALL;                \
    }                             \
    if ((d) <= 128) {             \
      constexpr int DP = 128;     \
      return CALL;                \
    }                             \
    if ((d) <= 256) {             \
      constexpr int DP = 256;     \
      return CALL;                \
    }                             \
    return WIDE;                  \
  } while (0)

}  // namespace attn
