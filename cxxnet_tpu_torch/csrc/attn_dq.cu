// Flash-attention query gradient (K2-dq) for Hopper (sm_90a): a
// bfloat16 instance on the tensor cores and a float32 instance on the
// CUDA cores, picked by dtype.
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
// coordinates, also for Sq != Sk) and its causal tile skipping. ds rounds
// to T as the operand of its product and every sum is float32 - the TPU
// kernel's rounding points.
//
// What bounds it: operations, 6 B H Sq Sk D flops (q.k^T, do.v^T, ds.k;
// under causal about half). As the TPU kernel does, p is recomputed from
// lse: no Sq x Sk residual is saved. A block owns a range of query rows
// and loops over the key tiles, so each dq row is summed by one block and
// needs no atomics.
//
// bfloat16 (attn_dq_tc, machinery in attn_tc.cuh): wgmma on the tensor
// cores, one warpgroup per 64 query rows, two per block. It computes
// s = q . k^T and dp = do . v^T; ds, rounded to bf16 in registers, is the
// A operand of dq += ds . k (k read MN-major through the transpose flag).
// Q and dO stay resident in shared memory, each thread's lse and delta
// rows in registers; K and V stream through a 2-stage ring of
// asynchronous copies, shared by the block's warpgroups. A 64 x 64 score
// tile per warpgroup and streamed tile. Tile plan per DP bucket (head_dim
// rounded up to a power of two of at least 64; 256 threads a block):
//
//   head_dim  DP   query rows  stages  shared memory (swizzled 64 x DP
//                  a block             bf16 tiles, 1 KB alignment)
//   1-64      64   128         2        66,560 B  (3 blocks a multi-
//                                                   processor)
//   65-128    128  128         2       132,096 B
//   129-256   256  64          2       197,632 B  (the warpgroups split
//                                                   the dq columns and
//                                                   each recomputes the
//                                                   scores)
//
// float32 (attn_dq_kernel, attn_common.cuh): 256 threads on the CUDA
// cores with float32 tiles, as first written. Its bar against the plain
// version (rtol 1e-4, atol 1e-5) rules out TF32, and it serves the
// float32 agreement legs only. One staging buffer takes K, then V, then K
// again: with three 64 x (D + 1) tiles and the ds tile, head_dim 256 in
// float32 fits in a block's shared memory (214 KB).

#include "attn_common.cuh"
#include "attn_tc.cuh"

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

// bfloat16 on the tensor cores: see the header and attn_tc.cuh.
template <int DP, bool VEC>
__global__ void __launch_bounds__(attn_tc::kTcThreads)
    attn_dq_tc(const attn_tc::bf16* __restrict__ q,
               const attn_tc::bf16* __restrict__ k,
               const attn_tc::bf16* __restrict__ v,
               const attn_tc::bf16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               attn_tc::bf16* __restrict__ dq, int nblk, int sq, int sk, int d,
               int causal, float scale) {
  using namespace attn_tc;
  constexpr int NSPLIT = nsplit(DP), ROWG = rowg(DP);
  constexpr int OWN = kRows * ROWG;  // rows the block owns
  constexpr int NT = kTcThreads;
  constexpr int TE = tile_elems<DP>();
  constexpr int DC = DP / NSPLIT;  // accumulator columns of a warpgroup
  extern __shared__ unsigned char tc_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(align_smem(tc_smem));
  bf16* dOs = Qs + ROWG * TE;
  bf16* ring = dOs + ROWG * TE;  // stage s: K at 2 s TE, V at (2 s + 1) TE

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp & 3;            // the warp's 16 query rows
  const int rg = (warp >> 2) % ROWG;  // its warpgroup's 64 rows
  const int col0 = (warp >> 2) / ROWG * DC;  // and columns
  const int g = lane >> 2, t4 = lane & 3;
  const long long bh = blockIdx.x / nblk;
  const int q0 = (int)(blockIdx.x - bh * nblk) * OWN;
  const bf16* kb = k + bh * sk * d;
  const bf16* vb = v + bh * sk * d;

  if (VEC && d < DP) zero_cols<DP, NT>(Qs, 2 * ROWG + 2 * kStages, d);
  for (int r = 0; r < ROWG; ++r) {
    stage_tile<DP, NT, VEC>(Qs + r * TE, q + bh * sq * d, q0 + r * kRows,
                            sq, d);
    stage_tile<DP, NT, VEC>(dOs + r * TE, dout + bh * sq * d,
                            q0 + r * kRows, sq, d);
  }

  int nkt = (sk + kRows - 1) / kRows;
  if (causal) {
    const int last = (q0 + OWN - 1) / kRows + 1;
    nkt = nkt < last ? nkt : last;
  }
  auto load_stage = [&](int t, int st) {
    stage_tile<DP, NT, VEC>(ring + 2 * st * TE, kb, t * kRows, sk, d);
    stage_tile<DP, NT, VEC>(ring + (2 * st + 1) * TE, vb, t * kRows, sk,
                            d);
  };
  if (nkt > 0) load_stage(0, 0);
  cp_async_commit();

  // the fragment rows' query positions, lse and delta (rows g, g + 8)
  int qrow[2];
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    qrow[h] = q0 + rg * kRows + wr * 16 + g + 8 * h;
    const bool ok = qrow[h] < sq;
    row_lse[h] = ok ? lse[bh * sq + qrow[h]] * kLog2e : 0.f;
    row_delta[h] = ok ? delta[bh * sq + qrow[h]] : 0.f;
  }
  float acc[DC / 8][4];
#pragma unroll
  for (int j = 0; j < DC / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  const float sl2 = scale * kLog2e;
  for (int t = 0; t < nkt; ++t) {
    const int st = t & 1;
    if (t + 1 < nkt) load_stage(t + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();   // tile t has landed (this thread's copies)
    fence_proxy_async();  // ... visible to the tensor cores
    __syncthreads();      // ... and every other thread's
    const int k0 = t * kRows;
    const bf16* Kt = ring + 2 * st * TE;
    const bf16* Vt = Kt + TE;
    const bool edge = q0 + OWN > sq || k0 + kRows > sk ||
                      (causal && k0 + kRows - 1 > q0);
    float s[kRows / 8][4], dp[kRows / 8][4];
    wg_score<DP>(s, Qs + rg * TE, Kt);
    wg_score<DP>(dp, dOs + rg * TE, Vt);
    wg_commit();
    wg_wait<0>();
    keep(s);
    keep(dp);
#pragma unroll
    for (int j = 0; j < kRows / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        float p = ex2(fmaf(s[j][e], sl2, -row_lse[h]));
        if (edge) {
          const int kj = k0 + 8 * j + 2 * t4 + (e & 1);
          if (qrow[h] >= sq || kj >= sk || (causal && kj > qrow[h]))
            p = 0.f;
        }
        dp[j][e] = p * (dp[j][e] - row_delta[h]);
      }
    }
    uint32_t a[kRows / 16][4];
    pack_a(a, dp);
    wg_fence();
    wg_acc<DC>(acc, a, Kt, col0);  // dq += ds . k
    wg_commit();
    wg_wait<0>();
    keep(acc);
    keep(a);
    __syncthreads();  // every warp is done with stage st before refill
  }
  cp_async_wait<0>();  // no copy outlives the block

  store_rows<DC, VEC>(dq + bh * sq * d, acc, q0 + rg * kRows + wr * 16, sq,
                      d, col0, scale, lane);
}

// Dynamic shared memory of the tensor-core instance at DP.
template <int DP>
constexpr size_t kSmemTc = attn_tc::smem_bytes<DP>(0);

int run_tc(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dq, long long bh,
           int sq, int sk, int d, int causal, float scale,
           cudaStream_t stream) {
  using attn_tc::bf16;
  const bool vec = attn_tc::vec_ok(d, {q, k, v, dout, dq});
  ATTN_TC_DISPATCH(
      d, vec,
      (attn_tc::launch<attn_dq_tc<DP, VEC>>(
          bh * attn_tc::own_tiles(sq, DP), attn_tc::kTcThreads,
          kSmemTc<DP>, stream, static_cast<const bf16*>(q),
          static_cast<const bf16*>(k), static_cast<const bf16*>(v),
          static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dq),
          attn_tc::own_tiles(sq, DP), sq, sk, d, causal, scale)));
}

int plan_tc(int d, int* plan) {
  // the plan does not depend on the load path
  ATTN_TC_DISPATCH(
      d, true,
      (plan[0] = DP, plan[1] = attn_tc::kTcThreads,
       plan[2] = (int)kSmemTc<DP>, (void)VEC, 0));
}

}  // namespace

// Plain C entry point, bound with ctypes. dtype: 0 = float32 (CUDA
// cores), 1 = bfloat16 (tensor cores; the load path is picked from d and
// the pointers' alignment); bh = B * H; lse and delta are (B, H, Sq)
// float32.
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
    return run_tc(q, k, v, dout, lf, df, dq, bh, sq, sk, d, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}

// The bfloat16 instance's tile plan for head_dim d: plan[0..2] = DP,
// threads per block, dynamic shared memory bytes. Returns 0, or
// cudaErrorInvalidValue for d > 256.
extern "C" int attn_dq_plan(int d, int* plan) {
  return plan_tc(d, plan);
}
