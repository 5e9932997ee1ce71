// Flash-attention forward (K2-fwd) for Hopper (sm_90a), float32 and
// bfloat16.
//
// Replaces the TPU kernel cxxnet_tpu/ops/pallas_attention.py:_fwd_kernel
// (launched by _fwd through pl.pallas_call, entry flash_attention). For
// q (B, H, Sq, D), k and v (B, H, Sk, D), row-major and contiguous:
//
//   s   = q . k^T * scale (float32); -1e30 where masked
//   m'  = max(m, rowmax s); p = exp(s - m') (0 where masked)
//   l   = l * exp(m - m') + rowsum p            (the float32 p)
//   acc = acc * exp(m - m') + p.to(T) . v      (float32 accumulation)
//   o   = acc / (l > 0 ? l : 1)  in T;  lse = m + log(l > 0 ? l : 1)
//
// masked = key position >= Sk (tile padding) or, under causal, key
// position > query position (global coordinates). Key tiles that lie
// wholly in the future of a causal query tile are skipped, as the TPU
// kernel's pl.when does.
//
// What bounds it: operations (4 B H Sq Sk D flops against 2-4 tensors
// read once). The TPU kernel ran (1024, 1024) tiles through the matrix
// unit with f32 scratch carried across the sequential KV grid axis;
// here a block of 256 threads owns 64 query rows, keeps its Q tile in
// shared memory and loops over the 64-row K/V tiles (attn_common.cuh),
// with m and l in registers and the row max and sum reduced across the
// 16 lanes of a half-warp by shuffles. This first version computes on
// the float32 pipes (CUDA cores), not the tensor cores: it is simple
// and right for every head_dim up to 256 and any length, and far from
// the bound; wgmma, TMA and a pipelined ring of tiles are later work.

#include "attn_common.cuh"

namespace {

using namespace attn;

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ o,
                    float* __restrict__ lse, int nqt, int sq, int sk, int d,
                    int causal, float scale) {
  extern __shared__ float smem[];
  constexpr int ld = DP + 1;
  constexpr int NC = DP / 16;
  float* Qs = smem;
  float* KVs = Qs + kTile * ld;
  float* Ps = KVs + kTile * ld;

  const long long bh = blockIdx.x / nqt;
  const int q0 = (int)(blockIdx.x - bh * nqt) * kTile;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const T* qb = q + bh * sq * d;
  const T* kb = k + bh * sk * d;
  const T* vb = v + bh * sk * d;

  load_tile<T, DP>(Qs, qb, q0, sq, d);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNeg;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }

  int nkt = (sk + kTile - 1) / kTile;
  if (causal) {
    // key tiles with k0 <= q0 + kTile - 1
    int last = (q0 + kTile - 1) / kTile + 1;
    nkt = nkt < last ? nkt : last;
  }
  for (int t = 0; t < nkt; ++t) {
    const int k0 = t * kTile;
    __syncthreads();  // the last tile's P.V is done with KVs and Ps
    load_tile<T, DP>(KVs, kb, k0, sk, d);
    __syncthreads();
    float s[4][4];
    tile_dot<DP>(s, Qs, KVs, d, ty, tx);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qi = q0 + ty + 16 * r;
      float mx = kNeg;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kj = k0 + tx + 16 * c;
        const bool masked = kj >= sk || (causal && kj > qi);
        s[r][c] = masked ? kNeg : s[r][c] * scale;
        mx = fmaxf(mx, s[r][c]);
      }
      // the row's 64 entries sit on the 16 lanes of one half-warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float corr = expf(m[r] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kj = k0 + tx + 16 * c;
        const bool masked = kj >= sk || (causal && kj > qi);
        const float p = masked ? 0.f : expf(s[r][c] - m_new);
        rs += p;
        Ps[(ty + 16 * r) * kPLd + tx + 16 * c] = round_t<T>(p);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[r] = l[r] * corr + rs;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= corr;
    }
    __syncthreads();  // every thread is done reading K; Ps is written
    load_tile<T, DP>(KVs, vb, k0, sk, d);
    __syncthreads();
    const int n = sk - k0 < kTile ? sk - k0 : kTile;
    tile_acc<DP>(acc, Ps, KVs, n, ty, tx);
  }

  T* ob = o + bh * sq * d;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = q0 + ty + 16 * r;
    if (qi >= sq) continue;  // padding rows are never stored
    const float safe = l[r] > 0.f ? l[r] : 1.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int dc = tx + 16 * c;
      if (dc < d) ob[(long long)qi * d + dc] = from_f<T>(acc[r][c] / safe);
    }
    if (tx == 0) lse[bh * sq + qi] = m[r] + logf(safe);
  }
}

template <typename T>
int run(const void* q, const void* k, const void* v, void* o, float* lse,
        long long bh, int sq, int sk, int d, int causal, float scale,
        cudaStream_t stream) {
  const int nqt = (sq + kTile - 1) / kTile;
  ATTN_DISPATCH_DP(
      d, (launch<attn_fwd_kernel<T, DP>>(
             bh * nqt, smem_bytes<DP>(2), stream, static_cast<const T*>(q),
             static_cast<const T*>(k), static_cast<const T*>(v),
             static_cast<T*>(o), lse, nqt, sq, sk, d, causal, scale)));
}

}  // namespace

// Plain C entry point, bound with ctypes. dtype: 0 = float32,
// 1 = bfloat16; bh = B * H; lse is (B, H, Sq) float32. Launches on
// `stream`, does not synchronise, and returns cudaGetLastError()
// (0 = launched).
extern "C" int attn_fwd(const void* q, const void* k, const void* v,
                        void* o, void* lse, int dtype, long long bh, int sq,
                        int sk, int d, int causal, float scale,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lf = static_cast<float*>(lse);
  if (dtype == 0)
    return run<float>(q, k, v, o, lf, bh, sq, sk, d, causal, scale, s);
  if (dtype == 1)
    return run<__nv_bfloat16>(q, k, v, o, lf, bh, sq, sk, d, causal, scale,
                              s);
  return (int)cudaErrorInvalidValue;
}
