// K3: the int8 dot for Hopper (sm_90a): int8 x int8 -> int32, exact, on
// the int8 tensor cores.
//
// Replaces the TPU kernel cxxnet_tpu/ops/int8.py:_mm_kernel (launched
// through _matmul_pallas -> pl.pallas_call, entry int8_matmul). For
// row-major x (m, k) and w (n, k), both int8 and k-contiguous (an "NT"
// product):
//
//   out[i][j] = sum_t x[i][t] * w[j][t]        (int32)
//
// Every product of two int8 values is an integer of at most 16,384 in
// magnitude and the tensor cores add them into int32 without rounding;
// with k <= 37,000 on the port's paths no partial sum leaves int32. int32
// addition is associative, so the result is exact and independent of
// the order of the sums - also across split-k atomics: the bar against
// the plain version is bitwise equality.
//
// What bounds it: at the im2col GEMMs of the int8 convolutions and at the
// measuring shape (4096, 4096, 4096) the operations (1,979 TOP/s dense
// int8 on the H100 SXM); at the main path's fullc shapes (m = 64 rows
// against 4096-wide weights) the bytes - each weight byte is used by only
// 64 rows, far below the card's int8 ridge.
//
// Design. wgmma.mma_async m64nNk32 .s32.s8.s8 (N = BN = 128 or 256, the
// wrapper picks the one that pads n least) from 128-byte-swizzled shared
// tiles: the NT layout is K-major for both operands, which is what int8
// wgmma requires (it has no transpose). A block of 2 warpgroups owns a
// 128 x BN output tile, each warpgroup 64 rows x BN columns in int32
// registers (BN / 2 a thread). The k loop stages 128-byte slices (one
// swizzle row: 128 rows of x and BN rows of w) through a ring of 4 stages
// of asynchronous copies, two slices ahead; each warpgroup keeps one
// wgmma group in flight while it issues the next. Shared memory: 4 x
// (16 KB + BN x 128 B) + 1 KB alignment = 132,096 B (BN 128) or 197,632 B
// (BN 256), one block a multiprocessor.
//
// Every shape is taken (the TPU kernel's grid required k % 128 == 0,
// m % 32 == 0 and n % 128 == 0, Mosaic's tiling):
//   - VEC (k % 16 == 0 and both bases 16-byte aligned): 16-byte cp.async
//     pieces, zero-filled past m, n and the k range;
//   - !VEC (conv1's im2col has k = 363, a view may sit at any byte): the
//     same pieces assembled from aligned 4-byte loads (funnel-shifted,
//     bytes past the k range zeroed) and stored into the swizzled tile -
//     the same tensor-core products;
//   - the m / n edges are guarded at the store.
// Split-k: where the output has too few tiles to fill the card's 132
// SMs (m = 64 against n = 1000-4096), blockIdx.z cuts k into `splits`
// ranges of whole stages and each block adds its partial sums into the
// (zeroed) output with atomicAdd - exact, because integer addition is.
// m tiles run along grid x (no 65535 limit: an im2col GEMM has up to
// hundreds of thousands of rows), n tiles along grid y.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_common.cuh"

namespace {

using namespace tc;

constexpr int kBM = 128;      // output rows per block: 2 warpgroups x 64
constexpr int kBK = 128;      // k bytes per stage: one swizzle row
constexpr int kStages = 4;    // depth of the ring
constexpr int kAhead = kStages - 2;  // stages in flight ahead of the one used
constexpr int kThreads = 256;

template <int BN>
__host__ __device__ constexpr int stage_bytes() {
  return (kBM + BN) * kBK;
}
template <int BN>
constexpr size_t smem_bytes() {
  return (size_t)kStages * stage_bytes<BN>() + 1024;
}

// d (64 x 128, int32) += A (64 x 32, smem) . B (128 x 32, smem)^T, both
// K-major s8; d is ignored (not added) when !accumulate.
__device__ __forceinline__ void wgmma_s8(int (&d)[16][4], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]),
        "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]),
        "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]),
        "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3]),
        "+r"(d[4][0]), "+r"(d[4][1]), "+r"(d[4][2]), "+r"(d[4][3]),
        "+r"(d[5][0]), "+r"(d[5][1]), "+r"(d[5][2]), "+r"(d[5][3]),
        "+r"(d[6][0]), "+r"(d[6][1]), "+r"(d[6][2]), "+r"(d[6][3]),
        "+r"(d[7][0]), "+r"(d[7][1]), "+r"(d[7][2]), "+r"(d[7][3]),
        "+r"(d[8][0]), "+r"(d[8][1]), "+r"(d[8][2]), "+r"(d[8][3]),
        "+r"(d[9][0]), "+r"(d[9][1]), "+r"(d[9][2]), "+r"(d[9][3]),
        "+r"(d[10][0]), "+r"(d[10][1]), "+r"(d[10][2]), "+r"(d[10][3]),
        "+r"(d[11][0]), "+r"(d[11][1]), "+r"(d[11][2]), "+r"(d[11][3]),
        "+r"(d[12][0]), "+r"(d[12][1]), "+r"(d[12][2]), "+r"(d[12][3]),
        "+r"(d[13][0]), "+r"(d[13][1]), "+r"(d[13][2]), "+r"(d[13][3]),
        "+r"(d[14][0]), "+r"(d[14][1]), "+r"(d[14][2]), "+r"(d[14][3]),
        "+r"(d[15][0]), "+r"(d[15][1]), "+r"(d[15][2]), "+r"(d[15][3])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 256, int32) += A (64 x 32, smem) . B (256 x 32, smem)^T, both
// K-major s8; d is ignored (not added) when !accumulate.
__device__ __forceinline__ void wgmma_s8(int (&d)[32][4], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
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
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]),
        "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]),
        "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]),
        "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3]),
        "+r"(d[4][0]), "+r"(d[4][1]), "+r"(d[4][2]), "+r"(d[4][3]),
        "+r"(d[5][0]), "+r"(d[5][1]), "+r"(d[5][2]), "+r"(d[5][3]),
        "+r"(d[6][0]), "+r"(d[6][1]), "+r"(d[6][2]), "+r"(d[6][3]),
        "+r"(d[7][0]), "+r"(d[7][1]), "+r"(d[7][2]), "+r"(d[7][3]),
        "+r"(d[8][0]), "+r"(d[8][1]), "+r"(d[8][2]), "+r"(d[8][3]),
        "+r"(d[9][0]), "+r"(d[9][1]), "+r"(d[9][2]), "+r"(d[9][3]),
        "+r"(d[10][0]), "+r"(d[10][1]), "+r"(d[10][2]), "+r"(d[10][3]),
        "+r"(d[11][0]), "+r"(d[11][1]), "+r"(d[11][2]), "+r"(d[11][3]),
        "+r"(d[12][0]), "+r"(d[12][1]), "+r"(d[12][2]), "+r"(d[12][3]),
        "+r"(d[13][0]), "+r"(d[13][1]), "+r"(d[13][2]), "+r"(d[13][3]),
        "+r"(d[14][0]), "+r"(d[14][1]), "+r"(d[14][2]), "+r"(d[14][3]),
        "+r"(d[15][0]), "+r"(d[15][1]), "+r"(d[15][2]), "+r"(d[15][3]),
        "+r"(d[16][0]), "+r"(d[16][1]), "+r"(d[16][2]), "+r"(d[16][3]),
        "+r"(d[17][0]), "+r"(d[17][1]), "+r"(d[17][2]), "+r"(d[17][3]),
        "+r"(d[18][0]), "+r"(d[18][1]), "+r"(d[18][2]), "+r"(d[18][3]),
        "+r"(d[19][0]), "+r"(d[19][1]), "+r"(d[19][2]), "+r"(d[19][3]),
        "+r"(d[20][0]), "+r"(d[20][1]), "+r"(d[20][2]), "+r"(d[20][3]),
        "+r"(d[21][0]), "+r"(d[21][1]), "+r"(d[21][2]), "+r"(d[21][3]),
        "+r"(d[22][0]), "+r"(d[22][1]), "+r"(d[22][2]), "+r"(d[22][3]),
        "+r"(d[23][0]), "+r"(d[23][1]), "+r"(d[23][2]), "+r"(d[23][3]),
        "+r"(d[24][0]), "+r"(d[24][1]), "+r"(d[24][2]), "+r"(d[24][3]),
        "+r"(d[25][0]), "+r"(d[25][1]), "+r"(d[25][2]), "+r"(d[25][3]),
        "+r"(d[26][0]), "+r"(d[26][1]), "+r"(d[26][2]), "+r"(d[26][3]),
        "+r"(d[27][0]), "+r"(d[27][1]), "+r"(d[27][2]), "+r"(d[27][3]),
        "+r"(d[28][0]), "+r"(d[28][1]), "+r"(d[28][2]), "+r"(d[28][3]),
        "+r"(d[29][0]), "+r"(d[29][1]), "+r"(d[29][2]), "+r"(d[29][3]),
        "+r"(d[30][0]), "+r"(d[30][1]), "+r"(d[30][2]), "+r"(d[30][3]),
        "+r"(d[31][0]), "+r"(d[31][1]), "+r"(d[31][2]), "+r"(d[31][3])
      : "l"(a), "l"(b), "r"(accumulate));
}

// Stage rows [row0, row0 + ROWS) x k bytes [k0, k0 + 128) of a row-major
// (rows, ld) int8 matrix as a swizzled tile (16-byte piece p of row r at
// r * 128 + (p ^ (r % 8)) * 16); rows >= `rows` and bytes >= kend are 0.
// Eight neighbouring threads take the eight pieces of one row.
template <int ROWS, bool VEC>
__device__ __forceinline__ void stage_tile(int8_t* __restrict__ dst,
                                           const int8_t* __restrict__ src,
                                           long long row0, int rows,
                                           long long k0, long long kend,
                                           long long ld) {
  char* base = reinterpret_cast<char*>(dst);
#pragma unroll 4
  for (int i = threadIdx.x; i < ROWS * 8; i += kThreads) {
    const int r = i >> 3, p = i & 7;
    const long long gr = row0 + r;
    const long long c = k0 + 16 * p;
    char* d = base + r * 128 + ((p ^ (r & 7)) << 4);
    if constexpr (VEC) {
      // k % 16 == 0: a piece lies wholly inside [k0, kend) or outside
      const bool ok = gr < rows && c < kend;
      cp_async16(d, ok ? src + gr * ld + c : src, ok);
    } else {
      // the piece's bytes from the 5 aligned words that cover them,
      // funnel-shifted into place; a word is read only when it holds a
      // byte of the piece (so no read leaves the row's aligned words),
      // and bytes past kend are zeroed
      uint32_t wd[4] = {0u, 0u, 0u, 0u};
      const long long nv = kend - c;  // valid bytes of the piece
      if (gr < rows && nv > 0) {
        const char* p = reinterpret_cast<const char*>(src + gr * ld + c);
        const char* end = p + (nv < 16 ? nv : 16);
        const uintptr_t a = reinterpret_cast<uintptr_t>(p);
        const uint32_t* w0 =
            reinterpret_cast<const uint32_t*>(a & ~(uintptr_t)3);
        const int sh = (int)(a & 3) * 8;
        uint32_t raw[5];
#pragma unroll
        for (int i = 0; i < 5; ++i)
          raw[i] = reinterpret_cast<const char*>(w0 + i) < end
                       ? __ldg(w0 + i)
                       : 0u;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t v = __funnelshift_r(raw[i], raw[i + 1], sh);
          const long long left = nv - 4 * i;  // valid bytes from here on
          if (left >= 4)
            wd[i] = v;
          else if (left > 0)
            wd[i] = v & ((1u << (8 * (int)left)) - 1u);
        }
      }
      *reinterpret_cast<uint4*>(d) = make_uint4(wd[0], wd[1], wd[2], wd[3]);
    }
  }
}

template <int BN, bool VEC>
__global__ void __launch_bounds__(kThreads, 1)
    int8_mm_tc(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
               int* __restrict__ out, int m, int n, int k, int k_split,
               int atomic) {
  extern __shared__ unsigned char smem_raw[];
  int8_t* sm = reinterpret_cast<int8_t*>(align_smem(smem_raw));
  constexpr int SB = stage_bytes<BN>();  // stage s: x at s SB, w after

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, wr = warp & 3;
  const int g = lane >> 2, t4 = lane & 3;
  const long long m0 = (long long)blockIdx.x * kBM;
  const long long n0 = (long long)blockIdx.y * BN;
  const long long kbeg = (long long)blockIdx.z * k_split;
  const long long kend = kbeg + k_split < k ? kbeg + k_split : k;
  const int nst = (int)((kend - kbeg + kBK - 1) / kBK);

  auto load = [&](int t) {
    int8_t* st = sm + (t % kStages) * SB;
    const long long k0 = kbeg + (long long)t * kBK;
    stage_tile<kBM, VEC>(st, x, m0, m, k0, kend, k);
    stage_tile<BN, VEC>(st + kBM * kBK, w, n0, n, k0, kend, k);
  };
#pragma unroll
  for (int t = 0; t < kAhead; ++t) {
    if (t < nst) load(t);
    cp_async_commit();
  }

  int acc[BN / 8][4];
  for (int t = 0; t < nst; ++t) {
    cp_async_wait<kAhead - 1>();  // stage t has landed (this thread's)
    fence_proxy_async();          // ... visible to the tensor cores
    __syncthreads();              // ... and every other thread's; every
                                  // warpgroup is done with stage t - 2
    if (t + kAhead < nst) load(t + kAhead);  // into stage t - 2's slot
    cp_async_commit();
    const int8_t* A = sm + (t % kStages) * SB + wg * 64 * kBK;
    const int8_t* B = sm + (t % kStages) * SB + kBM * kBK;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk)
      wgmma_s8(acc, desc(A + 32 * kk, 16, 1024), desc(B + 32 * kk, 16, 1024),
               t > 0 || kk > 0);
    wg_commit();
    wg_wait<1>();  // the previous stage's products are done
  }
  wg_wait<0>();
  keep(acc);
  cp_async_wait<0>();  // no copy outlives the block

  // the accumulator fragment: acc[j] holds rows g, g + 8 of the warp's 16
  // and columns 8 j + 2 t4, 8 j + 2 t4 + 1
  const bool pairs = !atomic && n % 2 == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long row = m0 + wg * 64 + wr * 16 + g + 8 * h;
    if (row >= m) continue;
    int* orow = out + row * n;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const long long col = n0 + 8 * j + 2 * t4;
      const int v0 = acc[j][2 * h], v1 = acc[j][2 * h + 1];
      if (pairs) {
        if (col < n)
          *reinterpret_cast<int2*>(orow + col) = make_int2(v0, v1);
      } else if (atomic) {
        if (col < n) atomicAdd(orow + col, v0);
        if (col + 1 < n) atomicAdd(orow + col + 1, v1);
      } else {
        if (col < n) orow[col] = v0;
        if (col + 1 < n) orow[col + 1] = v1;
      }
    }
  }
}

template <int BN, bool VEC>
int launch_mm(dim3 grid, cudaStream_t s, const int8_t* x, const int8_t* w,
              int* out, int m, int n, int k, int k_split, int atomic) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      int8_mm_tc<BN, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes<BN>());
  if (attr != cudaSuccess) return (int)attr;
  int8_mm_tc<BN, VEC><<<grid, kThreads, smem_bytes<BN>(), s>>>(
      x, w, out, m, n, k, k_split, atomic);
  return (int)cudaGetLastError();
}

}  // namespace

// out (m, n) int32 = x (m, k) int8 . w (n, k)^T on a 128 x bn tile a
// block (bn = 128 or 256). `splits` > 1 cuts k into that many ranges of
// whole 128-byte stages, added into `out` with atomics after `out` is
// zeroed on the same stream. `aligned` = 1 only when k % 16 == 0 and
// both bases are 16-byte aligned. Returns the launch's cudaError_t (0 =
// launched).
extern "C" int int8_mm(const void* x, const void* w, void* out, int m, int n,
                       int k, int bn, int splits, int aligned, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || splits < 1 || (bn != 128 && bn != 256))
    return (int)cudaErrorInvalidValue;
  const int stages = (k + kBK - 1) / kBK;
  const int per = (stages + splits - 1) / splits;
  const int used = (stages + per - 1) / per;  // no empty split ranges
  const int k_split = per * kBK;
  dim3 grid((m + kBM - 1) / kBM, (n + bn - 1) / bn, used);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* xi = static_cast<const int8_t*>(x);
  const int8_t* wi = static_cast<const int8_t*>(w);
  int* o = static_cast<int*>(out);
  const int atomic = used > 1 ? 1 : 0;
  if (atomic) {
    const cudaError_t z =
        cudaMemsetAsync(o, 0, (size_t)m * n * sizeof(int), s);
    if (z != cudaSuccess) return (int)z;
  }
  if (bn == 128)
    return aligned ? launch_mm<128, true>(grid, s, xi, wi, o, m, n, k,
                                          k_split, atomic)
                   : launch_mm<128, false>(grid, s, xi, wi, o, m, n, k,
                                           k_split, atomic);
  return aligned ? launch_mm<256, true>(grid, s, xi, wi, o, m, n, k, k_split,
                                        atomic)
                 : launch_mm<256, false>(grid, s, xi, wi, o, m, n, k,
                                         k_split, atomic);
}
