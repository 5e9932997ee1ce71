// Cross-channel LRN forward for Hopper (sm_90a), float32 and bfloat16.
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
// What bounds it: memory traffic. Each element is read once and written
// once and costs about 2n + 6 flops including one powf - far below the
// card's flop-per-byte ridge. The TPU kernel kept a (1, C, 512) block in
// VMEM and shifted it along the sublane axis; here each thread owns one
// (batch, spatial position) column and walks a chunk of kChunk channels
// of it in a loop (grid x: columns, grid y: channel chunks, so even
// AlexNet's second LRN - 64 x 169 columns - fills the card). NCHW is
// contiguous along H*W, so at every channel step the 32 threads of a
// warp touch 32 neighbouring addresses (one coalesced transaction). The
// n-wide window is re-read from the cache for every channel rather than
// kept as a running sum that subtracts: a subtracting sum drifts in
// float32, and the re-reads hit L1/L2, not device memory. Any C and any
// H*W are legal; the grid masks the ragged tails.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // columns per block
constexpr int kChunk = 8;      // channels per thread

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch casts
}

template <typename T>
__global__ void lrn_fwd_kernel(const T* __restrict__ x, T* __restrict__ y,
                               long long cols, long long hw, int channels,
                               int lo, int hi, float alpha_over_n,
                               float neg_beta, float knorm) {
  long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= cols) return;
  long long b = col / hw;
  long long p = col - b * hw;
  const T* xc = x + b * channels * hw + p;
  T* yc = y + b * channels * hw + p;
  int c0 = blockIdx.y * kChunk;
  int c1 = c0 + kChunk < channels ? c0 + kChunk : channels;
  for (int c = c0; c < c1; ++c) {
    int j0 = c - lo < 0 ? 0 : c - lo;
    int j1 = c + hi > channels - 1 ? channels - 1 : c + hi;
    float s = 0.f;
    for (int j = j0; j <= j1; ++j) {
      float v = load_f(xc + (long long)j * hw);
      s += v * v;
    }
    float norm = knorm + alpha_over_n * s;
    float v = load_f(xc + (long long)c * hw);
    store_f(yc + (long long)c * hw, v * powf(norm, neg_beta));
  }
}

template <typename T>
int launch(const void* x, void* y, long long batch, int channels,
           long long hw, int n, float alpha_over_n, float neg_beta,
           float knorm, cudaStream_t stream) {
  long long cols = batch * hw;
  if (cols == 0 || channels == 0) return (int)cudaGetLastError();
  dim3 grid((unsigned int)((cols + kThreads - 1) / kThreads),
            (unsigned int)((channels + kChunk - 1) / kChunk));
  int lo = n / 2;
  int hi = n - lo - 1;
  lrn_fwd_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), cols, hw, channels, lo,
      hi, alpha_over_n, neg_beta, knorm);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. dtype: 0 = float32,
// 1 = bfloat16. Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() (0 = launched).
extern "C" int lrn_fwd(const void* x, void* y, int dtype, long long batch,
                       int channels, long long hw, int n, float alpha_over_n,
                       float neg_beta, float knorm, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, y, batch, channels, hw, n, alpha_over_n,
                         neg_beta, knorm, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, y, batch, channels, hw, n,
                                 alpha_over_n, neg_beta, knorm, s);
  return (int)cudaErrorInvalidValue;
}
