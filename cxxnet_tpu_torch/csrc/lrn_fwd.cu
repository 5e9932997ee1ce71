// Cross-channel LRN forward for Hopper (sm_90a), float32 and bfloat16:
// K1-fwd.
//
// Replaces the TPU kernel cxxnet_tpu/ops/pallas_lrn.py:_fwd_kernel
// (launched through _call -> pl.pallas_call, entry lrn_pallas). For an
// NCHW tensor x:
//
//   norm_c = knorm + alpha/n * sum_{j in [c-lo, c+hi]} x_j^2
//   out_c  = x_c * norm_c^(-beta)
//
// with lo = n/2, hi = n - lo - 1; channels outside [0, C) count as zero.
// The math is float32 whatever the storage type; the output keeps the
// input's type.
//
// What bounds it: bytes. Each element is read once and written once at
// about 2n + 6 flops - far below the card's flop-per-byte ridge. The
// TPU kernel kept a (1, C, 512) block in VMEM and shifted it along the
// sublane axis. The first port (one thread per spatial column, 2-byte
// loads straight from device memory, the window re-read and a 64-bit
// address formed for every load, an accurate powf) reached 13-18% of
// the bound: 0.1881 ms for both launches of an AlexNet b256 bf16 step
// against 0.0346, and 0.0658 ms at a served b64 batch against 0.0087,
// back to back (NVIDIA H100 80GB HBM3, 700 W). Its cold- and warm-L2
// times were nearly equal: it was held back by instructions and
// latency, not by the bytes.
//
// This design (lrn_slab.cuh) does two things about it. The bytes: a
// block takes one image and a chunk of channels (ops/lrn.py:lrn_plan
// picks 8-32) and copies the chunk's slab - channels [c0 - lo, c1 + hi)
// x all of H*W, one contiguous range in NCHW - into shared memory with
// 16-byte cp.async, rounded outward to 16-byte pieces (a 729- or
// 169-value row is never 16-byte aligned; a TMA tensor map could not
// describe its stride); the output range [c0, c1) x H*W leaves with
// 16-byte stores. The instructions: each thread owns spatial positions
// and walks the chunk's channels with the window's values and squares
// in register rings (n = 5, AlexNet's and GoogLeNet's window, known at
// compile time, the ring indexed only at compile time), so each step
// reads one 2-byte value
// from shared memory, adds the window afresh from the ring in
// ascending channel order - the plain version's order; never a
// subtracting running sum, which drifts in float32 - and writes out_c
// over x_c, whose slot no later step reads. Offsets inside a slab are
// 32-bit and the walk steps a pointer. bfloat16 takes the power on the
// fast intrinsics, float32 keeps powf (pow_f). Other n take the generic
// instance: each window is summed from shared memory and the results
// go to a second region, since a window there still reads channels
// already finished. Where H*W is so large that a row and its halo do
// not fit, the plan cuts it into segments, loaded row by row. A window
// over so many channels that even one position of its rows does not fit
// shared memory takes the direct instance, which reads its windows from
// device memory as the first port did. Any C, H*W and n >= 1 work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "lrn_slab.cuh"

namespace {

using lrn::Slab;

// The second launch bound (one block an SM at least) lifts ptxas's
// register target: with the first alone some instances spilled.
template <typename T, int N>
__global__ void __launch_bounds__(lrn::kMaxThreads, 1)
    lrn_fwd_kernel(const T* __restrict__ x, T* __restrict__ y,
                   long long total, int channels, long long hw, int n_rt,
                   int chunk, int seg, int nsegs, float alpha_over_n,
                   float neg_beta, float knorm) {
  extern __shared__ __align__(16) unsigned char smem[];
  const lrn::Block k = lrn::block_of(channels, hw, chunk, seg, nsegs);
  const int n = N > 0 ? N : n_rt;
  const int lo = n / 2, hi = n - lo - 1;
  const int j1 = min(channels, k.c1 + hi);
  const long long image = (long long)k.b * channels * hw;
  const Slab<T> sx =
      lrn::make_slab(smem, x + image, max(0, k.c0 - lo), hw, seg, k.s0);
  lrn::load_slab(sx, x + image, j1, hw, k.s0, k.len, x, x + total);
  lrn::slab_ready();
  const lrn::Power w = lrn::power(neg_beta);
  const int step = sx.step();
  // the generic instance writes to a second region laid out like rows
  // [c0, c1) of the first
  Slab<T> so = sx;
  if (N == 0) {
    so = lrn::make_slab(
        smem + lrn::region_bytes(j1 - sx.j0, hw, seg, sizeof(T)), x + image,
        k.c0, hw, seg, k.s0);
  }
  for (int p = threadIdx.x; p < k.len; p += blockDim.x) {
    if constexpr (N > 0) {
      // xr[i] = x_{c-lo+i}, sq[i] its square, for the channel c in
      // hand: each step loads the one channel entering the window
      float xr[N], sq[N];
      xr[0] = sq[0] = 0.f;
#pragma unroll
      for (int i = 1; i < N; ++i) {
        const int j = k.c0 - lo - 1 + i;
        xr[i] = j >= 0 && j < channels ? lrn::ld(sx.at(j, p)) : 0.f;
        sq[i] = __fmul_rn(xr[i], xr[i]);
      }
      T* xc = sx.at(k.c0, p);
      const int ahead = hi * step;
#pragma unroll N
      for (int c = k.c0; c < k.c1; ++c, xc += step) {
#pragma unroll
        for (int i = 0; i + 1 < N; ++i) {
          xr[i] = xr[i + 1];
          sq[i] = sq[i + 1];
        }
        xr[N - 1] = c + hi < channels ? lrn::ld(xc + ahead) : 0.f;
        sq[N - 1] = __fmul_rn(xr[N - 1], xr[N - 1]);
        float s = sq[0];
#pragma unroll
        for (int i = 1; i < N; ++i) s += sq[i];
        const float norm = knorm + __fmul_rn(alpha_over_n, s);
        // no later step reads x_c from shared memory
        lrn::st(xc, xr[N / 2] * lrn::pow_f<T>(norm, w));
      }
    } else {
      for (int c = k.c0; c < k.c1; ++c) {
        const int i1 = min(channels - 1, c + hi);
        float s = 0.f;
        for (int j = max(0, c - lo); j <= i1; ++j) {
          const float v = lrn::ld(sx.at(j, p));
          s += __fmul_rn(v, v);
        }
        const float norm = knorm + __fmul_rn(alpha_over_n, s);
        lrn::st(so.at(c, p),
                lrn::ld(sx.at(c, p)) * lrn::pow_f<T>(norm, w));
      }
    }
  }
  __syncthreads();
  lrn::store_slab(so, y + image, k.c0, k.c1, hw, k.s0, k.len);
}

// The plan without a slab (seg = 0, lrn_slab.cuh:check_direct): one
// thread an (image, position) column, a chunk of channels a grid row,
// each window summed from device memory through 64-bit offsets.
template <typename T>
__global__ void __launch_bounds__(lrn::kMaxThreads)
    lrn_fwd_direct(const T* __restrict__ x, T* __restrict__ y,
                   long long cols, int channels, long long hw, int n,
                   int chunk, float alpha_over_n, float neg_beta,
                   float knorm) {
  const long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= cols) return;
  const long long b = col / hw;
  const long long at = b * channels * hw + (col - b * hw);
  const int lo = n / 2, hi = n - lo - 1;
  const int c0 = blockIdx.y * chunk, c1 = min(c0 + chunk, channels);
  const lrn::Power w = lrn::power(neg_beta);
  for (int c = c0; c < c1; ++c) {
    const int i1 = min(channels - 1, c + hi);
    float s = 0.f;
    for (int j = max(0, c - lo); j <= i1; ++j) {
      const float v = lrn::ld(x + at + (long long)j * hw);
      s += __fmul_rn(v, v);
    }
    const float norm = knorm + __fmul_rn(alpha_over_n, s);
    lrn::st(y + at + (long long)c * hw,
            lrn::ld(x + at + (long long)c * hw) * lrn::pow_f<T>(norm, w));
  }
}

// Shared memory of a block's slab regions.
long long smem_need(int dtype, int channels, long long hw, int n,
                    int chunk, int seg) {
  const int size = dtype == 0 ? 4 : 2;
  const long long ch = chunk < channels ? chunk : channels;
  const long long rows = ch + n - 1 < channels ? ch + n - 1 : channels;
  long long need = lrn::region_bytes(rows, hw, seg, size);
  if (n != lrn::kRingN) need += lrn::region_bytes(ch, hw, seg, size);
  return lrn::align16(need);
}

template <typename T, int N>
int launch_n(const void* x, void* y, long long batch, int channels,
             long long hw, int n, int chunk, int seg, int threads,
             int smem_bytes, long long blocks, float alpha_over_n,
             float neg_beta, float knorm, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      lrn_fwd_kernel<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      lrn::kMaxSmem);
  if (attr != cudaSuccess) return (int)attr;
  const int nsegs = (int)((hw + seg - 1) / seg);
  lrn_fwd_kernel<T, N><<<(unsigned int)blocks, threads, smem_bytes,
                         stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), batch * channels * hw,
      channels, hw, n, chunk, seg, nsegs, alpha_over_n, neg_beta, knorm);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, void* y, long long batch, int channels,
           long long hw, int n, int chunk, int seg, int threads,
           int smem_bytes, long long blocks, float alpha_over_n,
           float neg_beta, float knorm, cudaStream_t s) {
  if (n == lrn::kRingN)
    return launch_n<T, lrn::kRingN>(x, y, batch, channels, hw, n, chunk,
                                    seg, threads, smem_bytes, blocks,
                                    alpha_over_n, neg_beta, knorm, s);
  return launch_n<T, 0>(x, y, batch, channels, hw, n, chunk, seg, threads,
                        smem_bytes, blocks, alpha_over_n, neg_beta, knorm,
                        s);
}

template <typename T>
int launch_direct(const void* x, void* y, long long batch, int channels,
                  long long hw, int n, int chunk, int threads, dim3 grid,
                  float alpha_over_n, float neg_beta, float knorm,
                  cudaStream_t s) {
  lrn_fwd_direct<T><<<grid, threads, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(y), batch * hw, channels, hw,
      n, chunk, alpha_over_n, neg_beta, knorm);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory (bytes) a block needs under the plan (chunk, seg): the
// same formula as ops/lrn.py:lrn_smem_bytes. dtype: 0 = float32,
// 1 = bfloat16.
extern "C" long long lrn_fwd_smem(int dtype, int channels, long long hw,
                                  int n, int chunk, int seg) {
  return smem_need(dtype, channels, hw, n, chunk, seg);
}

// Plain C entry point, bound with ctypes. dtype: 0 = float32,
// 1 = bfloat16. (chunk, seg, threads, smem_bytes) is the plan of
// ops/lrn.py:lrn_plan (seg = 0: the direct instance, no slab); a plan
// that does not fit is refused. Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() (0 = launched).
extern "C" int lrn_fwd(const void* x, void* y, int dtype, long long batch,
                       int channels, long long hw, int n, float alpha_over_n,
                       float neg_beta, float knorm, int chunk, int seg,
                       int threads, int smem_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch == 0 || channels == 0 || hw == 0) return (int)cudaGetLastError();
  if ((dtype != 0 && dtype != 1) || n < 1) return (int)cudaErrorInvalidValue;
  if (seg == 0) {
    dim3 grid;
    const int rc = lrn::check_direct(batch, channels, hw, chunk, threads,
                                     smem_bytes, &grid);
    if (rc != 0) return rc;
    if (dtype == 0)
      return launch_direct<float>(x, y, batch, channels, hw, n, chunk,
                                  threads, grid, alpha_over_n, neg_beta,
                                  knorm, s);
    return launch_direct<__nv_bfloat16>(x, y, batch, channels, hw, n, chunk,
                                        threads, grid, alpha_over_n,
                                        neg_beta, knorm, s);
  }
  long long blocks = 0;
  const int rc = lrn::check_plan(
      channels, hw, chunk, seg, threads,
      smem_need(dtype, channels, hw, n, chunk, seg), smem_bytes, batch,
      &blocks);
  if (rc != 0) return rc;
  if (dtype == 0)
    return launch<float>(x, y, batch, channels, hw, n, chunk, seg, threads,
                         smem_bytes, blocks, alpha_over_n, neg_beta, knorm, s);
  return launch<__nv_bfloat16>(x, y, batch, channels, hw, n, chunk, seg,
                               threads, smem_bytes, blocks, alpha_over_n,
                               neg_beta, knorm, s);
}
