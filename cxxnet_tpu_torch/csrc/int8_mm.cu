// K3: the int8 dot for Hopper (sm_90a): int8 x int8 -> int32, exact.
//
// Replaces the TPU kernel cxxnet_tpu/ops/int8.py:_mm_kernel (launched
// through _matmul_pallas -> pl.pallas_call, entry int8_matmul). For
// row-major x (m, k) and w (n, k), both int8 and k-contiguous (an "NT"
// product):
//
//   out[i][j] = sum_t x[i][t] * w[j][t]        (int32)
//
// Every partial sum is an integer, and int32 addition is associative, so
// the result is exact and independent of the order of the sums: the bar
// against the plain version is bitwise equality.
//
// What bounds it: at the main path's fullc shapes (m = 64 rows against
// 4096-wide weights) the bytes - each weight byte is used by only 64
// rows, far below the card's int8 ridge; at the im2col GEMMs of the
// int8 convolutions (m in the tens of thousands) the operations. This
// first version runs on the CUDA cores with __dp4a (four int8 products
// summed into an int32 per instruction), not the tensor cores: simple
// and right first; mma.sync / wgmma with TMA are later work.
//
// Design. A block of 256 threads owns a 64 x 64 output tile; each thread
// accumulates a 4 x 4 sub-tile in int32 registers. The k loop stages
// 64-byte slices of 64 x rows and 64 w rows through shared memory,
// stored k-word-major (As[k/4][row]) so that one 16-byte shared load
// gives a thread the four words of its four rows (or columns) at one k
// word: two 16-byte loads feed 16 __dp4a. The next slice is loaded into
// registers while the current one is consumed (register double
// buffering). The TPU kernel's grid required k % 128 == 0, m % 32 == 0
// and n % 128 == 0 (Mosaic's tiling); this kernel takes every shape:
//   - rows of a k that is not a multiple of 16 are not 16-byte aligned,
//     so such operands are read byte by byte (ALIGNED = false); the k
//     tail and the m / n edges are zero-filled in shared memory, and
//     zeros add nothing to a sum;
//   - the m / n edges are guarded at the store.
// Split-k: where the output has too few tiles to fill the card's 132
// SMs (m = 64 against n = 1000-4096), blockIdx.z cuts k into `splits`
// ranges and each block adds its partial sums into the (zeroed) output
// with atomicAdd - exact, because integer addition is.
// m tiles run along grid x (no 65535 limit: an im2col GEMM has up to
// hundreds of thousands of rows), n tiles along grid y.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;       // output rows per block
constexpr int kBN = 64;       // output columns per block
constexpr int kBK = 64;       // k bytes per stage
constexpr int kKW = kBK / 4;  // k words per stage
constexpr int kPad = 4;       // words of padding per shared row
constexpr int kThreads = 256;

// One thread's share of a stage: 16 bytes (a quarter of one row's
// 64-byte slice), packed into 4 words, little-endian byte order - the
// order __dp4a pairs bytes in, the same for both operands.
template <bool ALIGNED>
__device__ __forceinline__ int4 load_chunk(const int8_t* __restrict__ p,
                                           long long row, long long rows,
                                           long long col, long long kend,
                                           long long ld) {
  int4 v = make_int4(0, 0, 0, 0);
  if (row >= rows || col >= kend) return v;
  const int8_t* src = p + row * ld + col;
  if (ALIGNED) {
    // k % 16 == 0 and 16-byte aligned bases: the chunk lies wholly
    // inside [col, kend) whenever its first byte does
    return *reinterpret_cast<const int4*>(src);
  }
  unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int b = 0; b < 16; ++b) {
    if (col + b < kend) {
      w[b >> 2] |= (unsigned)(uint8_t)src[b] << (8 * (b & 3));
    }
  }
  v.x = (int)w[0];
  v.y = (int)w[1];
  v.z = (int)w[2];
  v.w = (int)w[3];
  return v;
}

template <bool ALIGNED>
__global__ void __launch_bounds__(kThreads)
    int8_mm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   int* __restrict__ out, int m, int n, int k, int k_split,
                   int atomic) {
  __shared__ __align__(16) int As[kKW][kBM + kPad];
  __shared__ __align__(16) int Bs[kKW][kBN + kPad];

  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // 0..15: rows ty*4 .. ty*4+3 of the tile
  const int tx = tid & 15;  // 0..15: cols tx*4 .. tx*4+3
  const long long m0 = (long long)blockIdx.x * kBM;
  const long long n0 = (long long)blockIdx.y * kBN;
  const long long kbeg = (long long)blockIdx.z * k_split;
  long long kend = kbeg + k_split;
  if (kend > k) kend = k;

  // loader mapping: thread -> (row lr, 16-byte chunk lc) of the stage
  const int lr = tid >> 2;
  const int lc = tid & 3;

  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  if (kbeg < kend) {
    int4 ra = load_chunk<ALIGNED>(x, m0 + lr, m, kbeg + 16 * lc, kend, k);
    int4 rb = load_chunk<ALIGNED>(w, n0 + lr, n, kbeg + 16 * lc, kend, k);
    for (long long k0 = kbeg; k0 < kend; k0 += kBK) {
      As[4 * lc + 0][lr] = ra.x;
      As[4 * lc + 1][lr] = ra.y;
      As[4 * lc + 2][lr] = ra.z;
      As[4 * lc + 3][lr] = ra.w;
      Bs[4 * lc + 0][lr] = rb.x;
      Bs[4 * lc + 1][lr] = rb.y;
      Bs[4 * lc + 2][lr] = rb.z;
      Bs[4 * lc + 3][lr] = rb.w;
      __syncthreads();
      const long long kn = k0 + kBK;
      if (kn < kend) {  // the next stage's loads overlap this one's math
        ra = load_chunk<ALIGNED>(x, m0 + lr, m, kn + 16 * lc, kend, k);
        rb = load_chunk<ALIGNED>(w, n0 + lr, n, kn + 16 * lc, kend, k);
      }
#pragma unroll
      for (int kw = 0; kw < kKW; ++kw) {
        const int4 a = *reinterpret_cast<const int4*>(&As[kw][ty * 4]);
        const int4 b = *reinterpret_cast<const int4*>(&Bs[kw][tx * 4]);
        const int av[4] = {a.x, a.y, a.z, a.w};
        const int bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long row = m0 + ty * 4 + i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long col = n0 + tx * 4 + j;
      if (col >= n) continue;
      if (atomic) {
        atomicAdd(out + row * n + col, acc[i][j]);
      } else {
        out[row * n + col] = acc[i][j];
      }
    }
  }
}

}  // namespace

// out (m, n) int32 = x (m, k) int8 . w (n, k)^T. `splits` > 1 cuts k
// into that many ranges of whole 64-byte stages, added into `out` with
// atomics: the caller must pass a zeroed `out` then. `aligned` = 1 only
// when k % 16 == 0 and both bases are 16-byte aligned. Returns the
// launch's cudaError_t (0 = launched).
extern "C" int int8_mm(const void* x, const void* w, void* out, int m, int n,
                       int k, int splits, int aligned, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || splits < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int stages = (k + kBK - 1) / kBK;
  const int per = (stages + splits - 1) / splits;
  const int k_split = per * kBK;
  const int used = (stages + per - 1) / per;  // no empty split ranges
  dim3 grid((m + kBM - 1) / kBM, (n + kBN - 1) / kBN, used);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int atomic = used > 1 ? 1 : 0;
  if (aligned) {
    int8_mm_kernel<true><<<grid, kThreads, 0, s>>>(
        static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
        static_cast<int*>(out), m, n, k, k_split, atomic);
  } else {
    int8_mm_kernel<false><<<grid, kThreads, 0, s>>>(
        static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
        static_cast<int*>(out), m, n, k, k_split, atomic);
  }
  return (int)cudaGetLastError();
}
