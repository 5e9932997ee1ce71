// Flash-attention query gradient (K2-dq) for Hopper (sm_90a), float32
// and bfloat16.
//
// Replaces the TPU kernel cxxnet_tpu/ops/pallas_attention.py:_dq_kernel
// (launched by _bwd_impl through pl.pallas_call, from the custom_vjp
// rule _vjp_bwd of flash_attention). For q, do (B, H, Sq, D), k, v
// (B, H, Sk, D), lse and delta = rowsum(do * o) (B, H, Sq) float32:
//
//   s  = q . k^T * scale;  p = exp(s - lse)  (0 where masked)
//   ds = p * (do . v^T - delta)
//   dq = scale * sum over key tiles of ds.to(T) . k      (stored in T)
//
// with the mask of attn_fwd.cu (key padding; causal in global
// coordinates) and its causal tile skipping.
//
// What bounds it: operations (6 B H Sq Sk D flops: q.k^T, do.v^T,
// ds.k). As the TPU kernel does, p is recomputed from lse: no Sq x Sk
// residual is saved. A block of 256 threads owns 64 query rows (its
// Q and dO tiles stay in shared memory, its dq rows in registers) and
// loops over the key tiles, so each dq row is summed by one block and
// needs no atomics. One staging buffer takes K, then V, then K again:
// with three 64 x (D + 1) tiles and the ds tile, head_dim 256 in
// float32 still fits in a block's shared memory (214 KB). Float32 pipes,
// not tensor cores, in this first version (see attn_fwd.cu).

#include "attn_common.cuh"

namespace {

using namespace attn;

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    attn_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dq,
                   int nqt, int sq, int sk, int d, int causal, float scale) {
  extern __shared__ float smem[];
  constexpr int ld = DP + 1;
  constexpr int NC = DP / 16;
  float* Qs = smem;
  float* dOs = Qs + kTile * ld;
  float* KVs = dOs + kTile * ld;
  float* Ds = KVs + kTile * ld;

  const long long bh = blockIdx.x / nqt;
  const int q0 = (int)(blockIdx.x - bh * nqt) * kTile;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const T* kb = k + bh * sk * d;
  const T* vb = v + bh * sk * d;

  load_tile<T, DP>(Qs, q + bh * sq * d, q0, sq, d);
  load_tile<T, DP>(dOs, dout + bh * sq * d, q0, sq, d);

  float row_lse[4], row_delta[4], acc[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = q0 + ty + 16 * r;
    row_lse[r] = qi < sq ? lse[bh * sq + qi] : 0.f;
    row_delta[r] = qi < sq ? delta[bh * sq + qi] : 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }

  int nkt = (sk + kTile - 1) / kTile;
  if (causal) {
    int last = (q0 + kTile - 1) / kTile + 1;
    nkt = nkt < last ? nkt : last;
  }
  for (int t = 0; t < nkt; ++t) {
    const int k0 = t * kTile;
    __syncthreads();  // the last tile's ds.k is done with KVs and Ds
    load_tile<T, DP>(KVs, kb, k0, sk, d);
    __syncthreads();
    float s[4][4];
    tile_dot<DP>(s, Qs, KVs, d, ty, tx);
    __syncthreads();
    load_tile<T, DP>(KVs, vb, k0, sk, d);
    __syncthreads();
    float dov[4][4];
    tile_dot<DP>(dov, dOs, KVs, d, ty, tx);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qi = q0 + ty + 16 * r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kj = k0 + tx + 16 * c;
        const bool masked = kj >= sk || (causal && kj > qi);
        const float p = masked ? 0.f : expf(s[r][c] * scale - row_lse[r]);
        Ds[(ty + 16 * r) * kPLd + tx + 16 * c] =
            round_t<T>(p * (dov[r][c] - row_delta[r]));
      }
    }
    __syncthreads();  // every thread is done reading V; Ds is written
    load_tile<T, DP>(KVs, kb, k0, sk, d);
    __syncthreads();
    const int n = sk - k0 < kTile ? sk - k0 : kTile;
    tile_acc<DP>(acc, Ds, KVs, n, ty, tx);
  }

  T* dqb = dq + bh * sq * d;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = q0 + ty + 16 * r;
    if (qi >= sq) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int dc = tx + 16 * c;
      if (dc < d) dqb[(long long)qi * d + dc] = from_f<T>(scale * acc[r][c]);
    }
  }
}

template <typename T>
int run(const void* q, const void* k, const void* v, const void* dout,
        const float* lse, const float* delta, void* dq, long long bh, int sq,
        int sk, int d, int causal, float scale, cudaStream_t stream) {
  const int nqt = (sq + kTile - 1) / kTile;
  ATTN_DISPATCH_DP(
      d, (launch<attn_dq_kernel<T, DP>>(
             bh * nqt, smem_bytes<DP>(3), stream, static_cast<const T*>(q),
             static_cast<const T*>(k), static_cast<const T*>(v),
             static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq),
             nqt, sq, sk, d, causal, scale)));
}

}  // namespace

// Plain C entry point, bound with ctypes. dtype: 0 = float32,
// 1 = bfloat16; bh = B * H; lse and delta are (B, H, Sq) float32.
// Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() (0 = launched).
extern "C" int attn_dq(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dq, int dtype, long long bh, int sq, int sk,
                       int d, int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lf = static_cast<const float*>(lse);
  const float* df = static_cast<const float*>(delta);
  if (dtype == 0)
    return run<float>(q, k, v, dout, lf, df, dq, bh, sq, sk, d, causal,
                      scale, s);
  if (dtype == 1)
    return run<__nv_bfloat16>(q, k, v, dout, lf, df, dq, bh, sq, sk, d,
                              causal, scale, s);
  return (int)cudaErrorInvalidValue;
}
