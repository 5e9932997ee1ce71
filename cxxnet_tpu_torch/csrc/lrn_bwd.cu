// Cross-channel LRN input gradient for Hopper (sm_90a), float32 and
// bfloat16.
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
// What bounds it: memory traffic. It reads x and g once and writes gin
// once, at about 4n + 12 flops per element - far below the card's
// flop-per-byte ridge. The layout is K1-fwd's (lrn_fwd.cu): one thread
// per (batch, spatial position) column, so the 32 threads of a warp read
// 32 neighbouring addresses of the contiguous H*W axis at every channel
// step, and a grid y over chunks of kChunk channels so that AlexNet's
// second LRN (64 x 169 columns per 64 images) still fills the card.
//
// For its chunk [c0, c1) a thread first computes norm_j and u_j once for
// every j in [c0-hi, c1+lo) - at most kChunk + n - 1 channels - and
// keeps them in two per-thread arrays (registers or local memory, both
// cached); the reversed-window sums then re-read that array. Each window
// sum is a fresh loop, never a subtracting running sum (which drifts in
// float32). Windows wider than kMaxN channels do not fit the arrays:
// those threads recompute norm_j and u_j inside the reversed-window loop
// instead (O(n^2) reads, all from cache) - any n the layer accepts works.
// knorm = 0 over an all-zero window gives 0 * inf = NaN, as in the JAX
// package; it is not guarded.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // columns per block
constexpr int kChunk = 8;      // channels per thread
constexpr int kMaxN = 16;      // widest window the per-thread arrays hold
constexpr int kSpan = kChunk + kMaxN - 1;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch casts
}

// norm_j of column `xc` (channel stride hw)
template <typename T>
__device__ __forceinline__ float norm_at(const T* xc, long long hw, int j,
                                         int channels, int lo, int hi,
                                         float alpha_over_n, float knorm) {
  int i0 = j - lo < 0 ? 0 : j - lo;
  int i1 = j + hi > channels - 1 ? channels - 1 : j + hi;
  float s = 0.f;
  for (int i = i0; i <= i1; ++i) {
    float v = load_f(xc + (long long)i * hw);
    s += v * v;
  }
  return knorm + alpha_over_n * s;
}

template <typename T>
__global__ void lrn_bwd_kernel(const T* __restrict__ x,
                               const T* __restrict__ g, T* __restrict__ gin,
                               long long cols, long long hw, int channels,
                               int lo, int hi, float alpha_over_n,
                               float neg_beta, float coef, float knorm) {
  long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= cols) return;
  long long b = col / hw;
  long long p = col - b * hw;
  const T* xc = x + b * channels * hw + p;
  const T* gc = g + b * channels * hw + p;
  T* oc = gin + b * channels * hw + p;
  int c0 = blockIdx.y * kChunk;
  int c1 = c0 + kChunk < channels ? c0 + kChunk : channels;
  float neg_beta_m1 = neg_beta - 1.f;

  if (lo + hi + 1 <= kMaxN) {
    // j in [a, e): every channel whose u_j a reversed window of the
    // chunk reads, and the chunk's own norms
    int a = c0 - hi < 0 ? 0 : c0 - hi;
    int e = c1 + lo < channels ? c1 + lo : channels;
    float nrm[kSpan];
    float u[kSpan];
    for (int j = a; j < e; ++j) {
      float nm = norm_at(xc, hw, j, channels, lo, hi, alpha_over_n, knorm);
      float xj = load_f(xc + (long long)j * hw);
      float gj = load_f(gc + (long long)j * hw);
      nrm[j - a] = nm;
      u[j - a] = gj * xj * powf(nm, neg_beta_m1);
    }
    for (int c = c0; c < c1; ++c) {
      int j0 = c - hi < 0 ? 0 : c - hi;
      int j1 = c + lo > channels - 1 ? channels - 1 : c + lo;
      float r = 0.f;
      for (int j = j0; j <= j1; ++j) r += u[j - a];
      float xv = load_f(xc + (long long)c * hw);
      float gv = load_f(gc + (long long)c * hw);
      store_f(oc + (long long)c * hw,
              gv * powf(nrm[c - a], neg_beta) - coef * xv * r);
    }
    return;
  }
  // wide windows: recompute norm_j and u_j per reversed-window entry
  for (int c = c0; c < c1; ++c) {
    int j0 = c - hi < 0 ? 0 : c - hi;
    int j1 = c + lo > channels - 1 ? channels - 1 : c + lo;
    float r = 0.f;
    for (int j = j0; j <= j1; ++j) {
      float nm = norm_at(xc, hw, j, channels, lo, hi, alpha_over_n, knorm);
      float xj = load_f(xc + (long long)j * hw);
      float gj = load_f(gc + (long long)j * hw);
      r += gj * xj * powf(nm, neg_beta_m1);
    }
    float nc = norm_at(xc, hw, c, channels, lo, hi, alpha_over_n, knorm);
    float xv = load_f(xc + (long long)c * hw);
    float gv = load_f(gc + (long long)c * hw);
    store_f(oc + (long long)c * hw, gv * powf(nc, neg_beta) - coef * xv * r);
  }
}

template <typename T>
int launch(const void* x, const void* g, void* gin, long long batch,
           int channels, long long hw, int n, float alpha_over_n,
           float neg_beta, float coef, float knorm, cudaStream_t stream) {
  long long cols = batch * hw;
  if (cols == 0 || channels == 0) return (int)cudaGetLastError();
  dim3 grid((unsigned int)((cols + kThreads - 1) / kThreads),
            (unsigned int)((channels + kChunk - 1) / kChunk));
  int lo = n / 2;
  int hi = n - lo - 1;
  lrn_bwd_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<T*>(gin), cols, hw, channels, lo, hi, alpha_over_n,
      neg_beta, coef, knorm);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. dtype: 0 = float32,
// 1 = bfloat16 (x, g and gin all of it). two_alpha_beta_over_n is the
// coefficient 2*alpha*beta/n of the reversed-window term. Launches on
// `stream`, does not synchronise, and returns cudaGetLastError()
// (0 = launched).
extern "C" int lrn_bwd(const void* x, const void* g, void* gin, int dtype,
                       long long batch, int channels, long long hw, int n,
                       float alpha_over_n, float neg_beta,
                       float two_alpha_beta_over_n, float knorm,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, g, gin, batch, channels, hw, n, alpha_over_n,
                         neg_beta, two_alpha_beta_over_n, knorm, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, g, gin, batch, channels, hw, n,
                                 alpha_over_n, neg_beta,
                                 two_alpha_beta_over_n, knorm, s);
  return (int)cudaErrorInvalidValue;
}
