// Tile helpers shared by the flash-attention kernels on the CUDA cores
// for Hopper (sm_90a): attn_fwd.cu (float32 and bfloat16) and the
// float32 instances of attn_dq.cu and attn_dkv.cu (their bfloat16
// instances run on the tensor cores, attn_tc.cuh).
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

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace attn {

constexpr int kTile = 64;        // query rows and key rows per tile
constexpr int kThreads = 256;    // 16 x 16
constexpr int kPLd = kTile + 1;  // row stride of the 64 x 64 score tile
constexpr float kNeg = -1e30f;   // the masked score, as in the JAX package

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch casts
}

// v rounded to the working type T and widened back: the rounding point
// of p and ds before their products (p.astype(v.dtype) in the TPU
// kernels).
template <typename T>
__device__ __forceinline__ float round_t(float v) {
  return to_f(from_f<T>(v));
}

// Stage rows [row0, row0 + kTile) of a row-major (rows, d) matrix as a
// kTile x (DP + 1) float32 tile; rows >= `rows` and columns >= d are 0.
// Neighbouring threads read neighbouring columns of one row.
template <typename T, int DP>
__device__ __forceinline__ void load_tile(float* __restrict__ dst,
                                          const T* __restrict__ src,
                                          int row0, int rows, int d) {
  constexpr int ld = DP + 1;
  for (int idx = threadIdx.x; idx < kTile * DP; idx += kThreads) {
    int r = idx / DP;
    int c = idx - r * DP;
    int gr = row0 + r;
    float val = 0.f;
    if (gr < rows && c < d) val = to_f(src[(long long)gr * d + c]);
    dst[r * ld + c] = val;
  }
}

// s[r][c] = sum_{e < d} A[ty + 16 r][e] * B[tx + 16 c][e] over two staged
// tiles: a score tile A . B^T in float32.
template <int DP>
__device__ __forceinline__ void tile_dot(float (&s)[4][4],
                                         const float* __restrict__ A,
                                         const float* __restrict__ B, int d,
                                         int ty, int tx) {
  constexpr int ld = DP + 1;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
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

// The head_dim padded to a power of two: the template instance to run.
#define ATTN_DISPATCH_DP(d, CALL) \
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
    return (int)cudaErrorInvalidValue; \
  } while (0)

}  // namespace attn
