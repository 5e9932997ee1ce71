// Flash-attention key and value gradients (K2-dkv) for Hopper (sm_90a),
// float32 and bfloat16.
//
// Replaces the TPU kernel cxxnet_tpu/ops/pallas_attention.py:_dkv_kernel
// (launched by _bwd_impl through pl.pallas_call over the swapped grid,
// KV outer and Q inner). With the arguments of attn_dq.cu:
//
//   p  = exp(q . k^T * scale - lse)  (0 where masked)
//   ds = p * (do . v^T - delta)
//   dv = sum over query tiles of p.to(T)^T . do          (stored in T)
//   dk = scale * sum over query tiles of ds.to(T)^T . q  (stored in T)
//
// masked = query position >= Sq or key position >= Sk (tile padding)
// or, under causal, key position > query position. Query tiles that lie
// wholly before a causal key tile are skipped.
//
// What bounds it: operations (8 B H Sq Sk D flops: q.k^T, do.v^T,
// p^T.do, ds^T.q). A block of 256 threads owns 64 key rows: their K and
// V tiles stay in shared memory and their dk and dv rows in registers,
// and it loops over the query tiles, so each dk/dv row is summed by one
// block and needs no atomics (the TPU kernel's sequential Q axis). The
// score tile is held transposed - thread (ty, tx) owns key rows
// ty + 16 r and query columns tx + 16 c - so that p^T and ds^T are
// written to shared memory as the row-major left operand of the two
// products. One staging buffer takes Q, then dO, then Q again (three
// tiles and the score tile: head_dim 256 in float32 fits in 214 KB).
// Float32 pipes, not tensor cores, in this first version (see
// attn_fwd.cu).

#include "attn_common.cuh"

namespace {

using namespace attn;

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    attn_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dk,
                    T* __restrict__ dv, int nkt, int sq, int sk, int d,
                    int causal, float scale) {
  extern __shared__ float smem[];
  constexpr int ld = DP + 1;
  constexpr int NC = DP / 16;
  float* Ks = smem;
  float* Vs = Ks + kTile * ld;
  float* Xs = Vs + kTile * ld;
  float* Ts = Xs + kTile * ld;

  const long long bh = blockIdx.x / nkt;
  const int k0 = (int)(blockIdx.x - bh * nkt) * kTile;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const T* qb = q + bh * sq * d;
  const T* db = dout + bh * sq * d;
  const float* lseb = lse + bh * sq;
  const float* deltab = delta + bh * sq;

  load_tile<T, DP>(Ks, k + bh * sk * d, k0, sk, d);
  load_tile<T, DP>(Vs, v + bh * sk * d, k0, sk, d);

  float acck[4][NC], accv[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) acck[r][c] = accv[r][c] = 0.f;

  const int nqt = (sq + kTile - 1) / kTile;
  // under causal, query tiles with q0 + kTile - 1 >= k0
  const int t0 = causal ? k0 / kTile : 0;
  for (int t = t0; t < nqt; ++t) {
    const int q0 = t * kTile;
    float col_lse[4], col_delta[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int qi = q0 + tx + 16 * c;
      col_lse[c] = qi < sq ? lseb[qi] : 0.f;
      col_delta[c] = qi < sq ? deltab[qi] : 0.f;
    }
    __syncthreads();  // the last tile's ds^T.q is done with Xs and Ts
    load_tile<T, DP>(Xs, qb, q0, sq, d);
    __syncthreads();
    float s[4][4];  // s[r][c] = k[ty + 16 r] . q[tx + 16 c]
    tile_dot<DP>(s, Ks, Xs, d, ty, tx);
    __syncthreads();
    load_tile<T, DP>(Xs, db, q0, sq, d);
    __syncthreads();
    float dov[4][4];  // (do . v^T) transposed
    tile_dot<DP>(dov, Vs, Xs, d, ty, tx);
    float ds[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int kj = k0 + ty + 16 * r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int qi = q0 + tx + 16 * c;
        const bool masked = qi >= sq || kj >= sk || (causal && kj > qi);
        const float p = masked ? 0.f : expf(s[r][c] * scale - col_lse[c]);
        ds[r][c] = p * (dov[r][c] - col_delta[c]);
        Ts[(ty + 16 * r) * kPLd + tx + 16 * c] = round_t<T>(p);
      }
    }
    __syncthreads();  // p^T is written
    const int n = sq - q0 < kTile ? sq - q0 : kTile;
    tile_acc<DP>(accv, Ts, Xs, n, ty, tx);  // dv += p^T . do
    __syncthreads();  // every thread is done reading p^T and dO
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        Ts[(ty + 16 * r) * kPLd + tx + 16 * c] = round_t<T>(ds[r][c]);
    load_tile<T, DP>(Xs, qb, q0, sq, d);
    __syncthreads();
    tile_acc<DP>(acck, Ts, Xs, n, ty, tx);  // dk += ds^T . q
  }

  T* dkb = dk + bh * sk * d;
  T* dvb = dv + bh * sk * d;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int kj = k0 + ty + 16 * r;
    if (kj >= sk) continue;  // padding rows are never stored
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int dc = tx + 16 * c;
      if (dc < d) {
        dkb[(long long)kj * d + dc] = from_f<T>(scale * acck[r][c]);
        dvb[(long long)kj * d + dc] = from_f<T>(accv[r][c]);
      }
    }
  }
}

template <typename T>
int run(const void* q, const void* k, const void* v, const void* dout,
        const float* lse, const float* delta, void* dk, void* dv,
        long long bh, int sq, int sk, int d, int causal, float scale,
        cudaStream_t stream) {
  const int nkt = (sk + kTile - 1) / kTile;
  ATTN_DISPATCH_DP(
      d, (launch<attn_dkv_kernel<T, DP>>(
             bh * nkt, smem_bytes<DP>(3), stream, static_cast<const T*>(q),
             static_cast<const T*>(k), static_cast<const T*>(v),
             static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk),
             static_cast<T*>(dv), nkt, sq, sk, d, causal, scale)));
}

}  // namespace

// Plain C entry point, bound with ctypes. dtype: 0 = float32,
// 1 = bfloat16; bh = B * H; lse and delta are (B, H, Sq) float32.
// Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() (0 = launched).
extern "C" int attn_dkv(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dk, void* dv, int dtype, long long bh, int sq,
                        int sk, int d, int causal, float scale,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lf = static_cast<const float*>(lse);
  const float* df = static_cast<const float*>(delta);
  if (dtype == 0)
    return run<float>(q, k, v, dout, lf, df, dk, dv, bh, sq, sk, d, causal,
                      scale, s);
  if (dtype == 1)
    return run<__nv_bfloat16>(q, k, v, dout, lf, df, dk, dv, bh, sq, sk, d,
                              causal, scale, s);
  return (int)cudaErrorInvalidValue;
}
