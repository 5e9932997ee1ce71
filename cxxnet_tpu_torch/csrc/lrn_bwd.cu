// Cross-channel LRN input gradient for Hopper (sm_90a), float32 and
// bfloat16: K1-bwd.
//
// Replaces the TPU kernel cxxnet_tpu/ops/pallas_lrn.py:_bwd_kernel
// (launched through _call -> pl.pallas_call from the custom_vjp rule
// _vjp_bwd). For NCHW x and upstream gradient g, with lo = n/2,
// hi = n - lo - 1 and channels outside [0, C) counting as zero:
//
//   norm_c = knorm + alpha/n * sum_{j in [c-lo, c+hi]} x_j^2
//   u_j    = g_j * x_j * norm_j^(-beta-1)
//   gin_c  = g_c * norm_c^(-beta)
//            - (2*alpha*beta/n) * x_c * sum_{j in [c-hi, c+lo]} u_j
//
// The last sum runs over the REVERSED window. The math is float32 and
// gin keeps x's type; like the TPU kernel it recomputes norm from x and
// needs nothing else from the forward.
//
// What bounds it: bytes. It reads x and g once and writes gin once, at
// about 4n + 12 flops per element - far below the card's flop-per-byte
// ridge. The first port (one thread per spatial column, 2-byte loads
// straight from device memory, each norm re-reading its window through
// 64-bit addresses - about 10 loads an output - two accurate powf an
// element, and per-thread arrays indexed at run time) reached 12% of
// the bound: 0.4247 ms for both launches of an AlexNet b256 bf16 step
// against 0.0519 (NVIDIA H100 80GB HBM3, 700 W), with cold- and warm-L2
// times nearly equal - instruction- and latency-bound.
//
// This design is K1-fwd's slab (lrn_slab.cuh): a block takes one image
// and a chunk [c0, c1) of channels (8-32, from ops/lrn.py:lrn_plan) and
// copies two contiguous ranges into shared memory with 16-byte cp.async:
// x over channels [c0 - lo - hi, c1 + lo + hi) (the norms of every u the
// chunk's reversed windows read) and g over [c0 - hi, c1 + lo). For
// n = 5 (AlexNet's and GoogLeNet's window, known at compile time) each
// thread owns spatial positions and walks j over
// [c0 - hi, c1 + lo) with register rings indexed only at compile time:
// x and its square over the window of j, and u, norm^(-beta) and g over
// the reversed window of c = j - lo. A step reads x_{j+hi} and g_j from
// shared memory, forms norm_j, norm_j^(-beta) with one power and
// norm_j^(-beta-1) from it (bfloat16: times 1/norm_j; float32 keeps a
// second powf, as the plain version - its bar needs u rounded alike),
// u_j, and, once c >= c0, gin_c, written over x_c (no later step reads
// it); the walk is cut into the steps before the first output, those
// inside [0, C) and those past the last channel, so the inner loop
// tests only whether x_{j+hi} lies past the last channel. The generic
// instance (any other n) keeps the two phases in shared memory: phase 1
// writes u_j and norm_j^(-beta) for every j of the chunk's reach, phase
// 2 reads the reversed window of u. Every window sum is added afresh in
// ascending channel order, the plain version's order - never a
// subtracting running sum, which drifts in float32. The output range
// [c0, c1) x H*W leaves with 16-byte stores. A window over so many
// channels that even one position of its rows does not fit shared
// memory takes the direct instance: as the first port's wide-window
// path, it recomputes norm_j and u_j from device memory for every entry
// of a reversed window.
// knorm = 0 over an all-zero window gives 0 * inf = NaN, as in the JAX
// package; it is not guarded.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "lrn_slab.cuh"

namespace {

using lrn::Slab;

// The walk of a thread over j for one position, n = N known at compile
// time. For the j in hand: xr[i] = x_{j-lo+i}, sq[i] its square; ur[i],
// pr[i], gr[i] = u, norm^(-beta), g of channel j-lo-hi+i - register
// rings, indexed only at compile time. Each step loads x_{j+hi} and
// g_j; c = j - lo has x_c = xr[0], g_c = gr[hi], norm_c^(-beta) =
// pr[hi] and its reversed window [c-hi, c+lo] in ur.
template <int N>
struct Rings {
  float xr[N] = {}, sq[N] = {}, ur[N] = {}, pr[N] = {}, gr[N] = {};
};

// x_j and g_j of the j in hand in shared memory; x_{j+hi} is `ahead`
// elements on, x_c `behind` elements back
template <typename T>
struct Walk {
  T* x;
  const T* g;
  int ahead, behind;
  __device__ __forceinline__ void next(int step) {
    x += step;
    g += step;
  }
};

struct Coef {
  float alpha_over_n, knorm, coef;
  lrn::Power w;
  int channels;
};

// the steps before a chunk's first output (j may lie outside [0, C)),
// those that output (j in [0, C)), and those past the last channel
enum Mode { kWarm, kMain, kTail };

template <typename T, int N, Mode M>
__device__ __forceinline__ void walk_step(Rings<N>& r, int j,
                                          const Walk<T>& at,
                                          const Coef& c) {
#pragma unroll
  for (int i = 0; i + 1 < N; ++i) {
    r.xr[i] = r.xr[i + 1];
    r.sq[i] = r.sq[i + 1];
    r.ur[i] = r.ur[i + 1];
    r.pr[i] = r.pr[i + 1];
    r.gr[i] = r.gr[i + 1];
  }
  constexpr int HI = N - 1 - N / 2;
  const int hi = HI;
  r.xr[N - 1] = M != kTail && j + hi < c.channels ? lrn::ld(at.x + at.ahead)
                                                   : 0.f;
  r.sq[N - 1] = __fmul_rn(r.xr[N - 1], r.xr[N - 1]);
  float u = 0.f, pw = 0.f, gv = 0.f;
  if (M == kMain || (M == kWarm && j >= 0 && j < c.channels)) {
    float s = r.sq[0];
#pragma unroll
    for (int i = 1; i < N; ++i) s += r.sq[i];
    const float norm = c.knorm + __fmul_rn(c.alpha_over_n, s);
    gv = lrn::ld(at.g);
    pw = lrn::pow_f<T>(norm, c.w);
    u = __fmul_rn(gv, r.xr[N / 2]) * lrn::pow_m1<T>(norm, pw, c.w);
  }
  r.ur[N - 1] = u;
  r.pr[N - 1] = pw;
  r.gr[N - 1] = gv;
  if (M != kWarm) {
    float rs = r.ur[0];
#pragma unroll
    for (int i = 1; i < N; ++i) rs += r.ur[i];
    const float t1 = __fmul_rn(r.gr[HI], r.pr[HI]);
    const float t2 = __fmul_rn(__fmul_rn(c.coef, r.xr[0]), rs);
    lrn::st(at.x - at.behind, t1 - t2);  // no later step reads x_c
  }
}

// The second launch bound (one block an SM at least) lifts ptxas's
// register target: with the first alone some instances spilled.
template <typename T, int N>
__global__ void __launch_bounds__(lrn::kMaxThreads, 1)
    lrn_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                   T* __restrict__ gin, long long total, int channels,
                   long long hw, int n_rt, int chunk, int seg, int nsegs,
                   float alpha_over_n, float neg_beta, float coef,
                   float knorm) {
  extern __shared__ __align__(16) unsigned char smem[];
  const lrn::Block k = lrn::block_of(channels, hw, chunk, seg, nsegs);
  const int n = N > 0 ? N : n_rt;
  const int lo = n / 2, hi = n - lo - 1;
  const int jx0 = max(0, k.c0 - lo - hi);
  const int jx1 = min(channels, k.c1 + lo + hi);
  const int jg0 = max(0, k.c0 - hi), jg1 = min(channels, k.c1 + lo);
  const long long image = (long long)k.b * channels * hw;
  const Slab<T> sx = lrn::make_slab(smem, x + image, jx0, hw, seg, k.s0);
  unsigned char* gbase =
      smem + lrn::region_bytes(jx1 - jx0, hw, seg, sizeof(T));
  const Slab<T> sg = lrn::make_slab(gbase, g + image, jg0, hw, seg, k.s0);
  lrn::load_slab(sx, x + image, jx1, hw, k.s0, k.len, x, x + total);
  lrn::load_slab(sg, g + image, jg1, hw, k.s0, k.len, g, g + total);
  lrn::slab_ready();
  const lrn::Power w = lrn::power(neg_beta);
  const int step = sx.step();  // the same in both slabs
  for (int p = threadIdx.x; p < k.len; p += blockDim.x) {
    if constexpr (N > 0) {
      Rings<N> r;
#pragma unroll
      for (int i = 1; i < N; ++i) {
        const int j = k.c0 - hi - lo - 1 + i;
        r.xr[i] = j >= 0 && j < channels ? lrn::ld(sx.at(j, p)) : 0.f;
        r.sq[i] = __fmul_rn(r.xr[i], r.xr[i]);
      }
      // rows before jx0 / jg0 are only addressed, never read
      Walk<T> at{sx.at(k.c0 - hi, p), sg.at(k.c0 - hi, p), hi * step,
                 lo * step};
      const Coef c{alpha_over_n, knorm, coef, w, channels};
      // j in [c0 - hi, c0 + lo): u of the first reversed windows
#pragma unroll
      for (int i = 0; i + 1 < N; ++i, at.next(step))
        walk_step<T, N, kWarm>(r, k.c0 - hi + i, at, c);
      // j in [c0 + lo, c1 + lo): gin of c = j - lo, u_j while j < C
      const int jm = min(k.c1 + lo, channels);
      int j = k.c0 + lo;
#pragma unroll N
      for (; j < jm; ++j, at.next(step)) walk_step<T, N, kMain>(r, j, at, c);
      for (; j < k.c1 + lo; ++j, at.next(step))
        walk_step<T, N, kTail>(r, j, at, c);
    } else {
      // phase 1: u_j and norm_j^(-beta) of every j the chunk reaches
      float* us = reinterpret_cast<float*>(
          gbase + lrn::region_bytes(jg1 - jg0, hw, seg, sizeof(T)));
      float* ps = us + (long long)(jg1 - jg0) * seg;
      for (int j = jg0; j < jg1; ++j) {
        const int i1 = min(channels - 1, j + hi);
        float s = 0.f;
        for (int i = max(0, j - lo); i <= i1; ++i) {
          const float v = lrn::ld(sx.at(i, p));
          s += __fmul_rn(v, v);
        }
        const float norm = knorm + __fmul_rn(alpha_over_n, s);
        const float pw = lrn::pow_f<T>(norm, w);
        us[(j - jg0) * seg + p] =
            __fmul_rn(lrn::ld(sg.at(j, p)), lrn::ld(sx.at(j, p))) *
            lrn::pow_m1<T>(norm, pw, w);
        if (j >= k.c0 && j < k.c1) ps[(j - k.c0) * seg + p] = pw;
      }
      // phase 2: the reversed windows
      for (int c = k.c0; c < k.c1; ++c) {
        const int j1 = min(channels - 1, c + lo);
        float r = 0.f;
        for (int j = max(0, c - hi); j <= j1; ++j)
          r += us[(j - jg0) * seg + p];
        const float t1 =
            __fmul_rn(lrn::ld(sg.at(c, p)), ps[(c - k.c0) * seg + p]);
        const float t2 = __fmul_rn(__fmul_rn(coef, lrn::ld(sx.at(c, p))), r);
        lrn::st(sx.at(c, p), t1 - t2);
      }
    }
  }
  __syncthreads();
  lrn::store_slab(sx, gin + image, k.c0, k.c1, hw, k.s0, k.len);
}

// The plan without a slab (seg = 0, lrn_slab.cuh:check_direct): one
// thread an (image, position) column, a chunk of channels a grid row;
// norm_j and u_j recomputed from device memory, through 64-bit offsets,
// for every entry of a reversed window.
template <typename T>
__device__ __forceinline__ float norm_direct(const T* xc, long long hw,
                                             int j, int channels, int lo,
                                             int hi, float alpha_over_n,
                                             float knorm) {
  const int i1 = min(channels - 1, j + hi);
  float s = 0.f;
  for (int i = max(0, j - lo); i <= i1; ++i) {
    const float v = lrn::ld(xc + (long long)i * hw);
    s += __fmul_rn(v, v);
  }
  return knorm + __fmul_rn(alpha_over_n, s);
}

template <typename T>
__global__ void __launch_bounds__(lrn::kMaxThreads)
    lrn_bwd_direct(const T* __restrict__ x, const T* __restrict__ g,
                   T* __restrict__ gin, long long cols, int channels,
                   long long hw, int n, int chunk, float alpha_over_n,
                   float neg_beta, float coef, float knorm) {
  const long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= cols) return;
  const long long b = col / hw;
  const long long at = b * channels * hw + (col - b * hw);
  const T* xc = x + at;
  const T* gc = g + at;
  const int lo = n / 2, hi = n - lo - 1;
  const int c0 = blockIdx.y * chunk, c1 = min(c0 + chunk, channels);
  const lrn::Power w = lrn::power(neg_beta);
  for (int c = c0; c < c1; ++c) {
    const int j1 = min(channels - 1, c + lo);
    float r = 0.f;
    for (int j = max(0, c - hi); j <= j1; ++j) {
      const float nm =
          norm_direct(xc, hw, j, channels, lo, hi, alpha_over_n, knorm);
      const float pw = lrn::pow_f<T>(nm, w);
      // u_j rounded before the add (no fused multiply-add), as the
      // plain version and the slab instances round it
      r += __fmul_rn(__fmul_rn(lrn::ld(gc + (long long)j * hw),
                               lrn::ld(xc + (long long)j * hw)),
                     lrn::pow_m1<T>(nm, pw, w));
    }
    const float nc =
        norm_direct(xc, hw, c, channels, lo, hi, alpha_over_n, knorm);
    const float t1 =
        __fmul_rn(lrn::ld(gc + (long long)c * hw), lrn::pow_f<T>(nc, w));
    const float t2 =
        __fmul_rn(__fmul_rn(coef, lrn::ld(xc + (long long)c * hw)), r);
    lrn::st(gin + at + (long long)c * hw, t1 - t2);
  }
}

// Shared memory of a block's x and g slabs (and the generic instance's
// float32 u and norm^(-beta)).
long long smem_need(int dtype, int channels, long long hw, int n,
                    int chunk, int seg) {
  const int size = dtype == 0 ? 4 : 2;
  const long long ch = chunk < channels ? chunk : channels;
  const long long span = n - 1;
  const long long rx = ch + 2 * span < channels ? ch + 2 * span : channels;
  const long long rg = ch + span < channels ? ch + span : channels;
  long long need = lrn::region_bytes(rx, hw, seg, size) +
                   lrn::region_bytes(rg, hw, seg, size);
  if (n != lrn::kRingN) need += 4LL * seg * (rg + ch);
  return lrn::align16(need);
}

template <typename T, int N>
int launch_n(const void* x, const void* g, void* gin, long long batch,
             int channels, long long hw, int n, int chunk, int seg,
             int threads, int smem_bytes, long long blocks,
             float alpha_over_n, float neg_beta, float coef, float knorm,
             cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      lrn_bwd_kernel<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      lrn::kMaxSmem);
  if (attr != cudaSuccess) return (int)attr;
  const int nsegs = (int)((hw + seg - 1) / seg);
  lrn_bwd_kernel<T, N><<<(unsigned int)blocks, threads, smem_bytes,
                         stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<T*>(gin), batch * channels * hw, channels, hw, n, chunk,
      seg, nsegs, alpha_over_n, neg_beta, coef, knorm);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* g, void* gin, long long batch,
           int channels, long long hw, int n, int chunk, int seg,
           int threads, int smem_bytes, long long blocks, float alpha_over_n,
           float neg_beta, float coef, float knorm, cudaStream_t s) {
  if (n == lrn::kRingN)
    return launch_n<T, lrn::kRingN>(x, g, gin, batch, channels, hw, n,
                                    chunk, seg, threads, smem_bytes, blocks,
                                    alpha_over_n, neg_beta, coef, knorm, s);
  return launch_n<T, 0>(x, g, gin, batch, channels, hw, n, chunk, seg,
                        threads, smem_bytes, blocks, alpha_over_n, neg_beta,
                        coef, knorm, s);
}

template <typename T>
int launch_direct(const void* x, const void* g, void* gin, long long batch,
                  int channels, long long hw, int n, int chunk, int threads,
                  dim3 grid, float alpha_over_n, float neg_beta, float coef,
                  float knorm, cudaStream_t s) {
  lrn_bwd_direct<T><<<grid, threads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<T*>(gin), batch * hw, channels, hw, n, chunk,
      alpha_over_n, neg_beta, coef, knorm);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory (bytes) a block needs under the plan (chunk, seg): the
// same formula as ops/lrn.py:lrn_smem_bytes. dtype: 0 = float32,
// 1 = bfloat16.
extern "C" long long lrn_bwd_smem(int dtype, int channels, long long hw,
                                  int n, int chunk, int seg) {
  return smem_need(dtype, channels, hw, n, chunk, seg);
}

// Plain C entry point, bound with ctypes. dtype: 0 = float32,
// 1 = bfloat16 (x, g and gin all of it). two_alpha_beta_over_n is the
// coefficient 2*alpha*beta/n of the reversed-window term. (chunk, seg,
// threads, smem_bytes) is the plan of ops/lrn.py:lrn_plan (seg = 0: the
// direct instance, no slab); a plan that does not fit is refused.
// Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() (0 = launched).
extern "C" int lrn_bwd(const void* x, const void* g, void* gin, int dtype,
                       long long batch, int channels, long long hw, int n,
                       float alpha_over_n, float neg_beta,
                       float two_alpha_beta_over_n, float knorm, int chunk,
                       int seg, int threads, int smem_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch == 0 || channels == 0 || hw == 0) return (int)cudaGetLastError();
  if ((dtype != 0 && dtype != 1) || n < 1) return (int)cudaErrorInvalidValue;
  if (seg == 0) {
    dim3 grid;
    const int rc = lrn::check_direct(batch, channels, hw, chunk, threads,
                                     smem_bytes, &grid);
    if (rc != 0) return rc;
    if (dtype == 0)
      return launch_direct<float>(x, g, gin, batch, channels, hw, n, chunk,
                                  threads, grid, alpha_over_n, neg_beta,
                                  two_alpha_beta_over_n, knorm, s);
    return launch_direct<__nv_bfloat16>(
        x, g, gin, batch, channels, hw, n, chunk, threads, grid,
        alpha_over_n, neg_beta, two_alpha_beta_over_n, knorm, s);
  }
  long long blocks = 0;
  const int rc = lrn::check_plan(
      channels, hw, chunk, seg, threads,
      smem_need(dtype, channels, hw, n, chunk, seg), smem_bytes, batch,
      &blocks);
  if (rc != 0) return rc;
  if (dtype == 0)
    return launch<float>(x, g, gin, batch, channels, hw, n, chunk, seg,
                         threads, smem_bytes, blocks, alpha_over_n, neg_beta,
                         two_alpha_beta_over_n, knorm, s);
  return launch<__nv_bfloat16>(x, g, gin, batch, channels, hw, n, chunk,
                               seg, threads, smem_bytes, blocks, alpha_over_n,
                               neg_beta, two_alpha_beta_over_n, knorm, s);
}
