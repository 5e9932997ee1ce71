// Flash-attention key and value gradients (K2-dkv) for Hopper (sm_90a):
// a bfloat16 instance on the tensor cores and a float32 instance on the
// CUDA cores, picked by dtype.
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
// or, under causal, key position > query position (global coordinates,
// also for Sq != Sk). Query tiles that lie wholly before a causal key
// tile are skipped. p and ds round to T as the operands of their
// products and every sum is float32 - the TPU kernel's rounding points.
//
// What bounds it: operations, 8 B H Sq Sk D flops (k.q^T, v.do^T,
// p^T.do, ds^T.q; under causal about half). A block owns a range of key
// rows, so each dk/dv row is summed by one block, with no atomics (the
// TPU kernel's sequential Q axis becomes the block's loop over query
// tiles).
//
// bfloat16 (attn_dkv_tc, machinery in attn_tc.cuh): wgmma on the tensor
// cores, one warpgroup per 64 key rows, two per block. It computes the
// transposed scores s^T = k . q^T and dp^T = v . do^T directly, so that
// p^T and ds^T, rounded to bf16 in registers, are already the A operand
// of dv += p^T . do and dk += ds^T . q (whose B operands, do and q, are
// read MN-major through the transpose flag). K and V stay resident in
// shared memory; Q, dO and their lse / delta rows stream through a
// 2-stage ring of asynchronous copies, shared by the block's
// warpgroups. A 64 x 64 score tile per warpgroup and streamed tile. Tile
// plan per DP bucket (head_dim rounded up to a power of two of at least
// 64; 256 threads a block):
//
//   head_dim  DP   key rows  stages  shared memory (swizzled 64 x DP bf16
//                  a block           tiles, lse/delta stages, 1 KB
//                                    alignment)
//   1-64      64   128       2        67,584 B  (3 blocks a multi-
//                                                 processor)
//   65-128    128  128       2       133,120 B
//   129-256   256  64        2       198,656 B  (the warpgroups split the
//                                                 dk/dv columns and each
//                                                 recomputes the scores:
//                                                 2 x 64 accumulator
//                                                 floats a thread)
//
// float32 (attn_dkv_kernel, attn_common.cuh): 256 threads on the CUDA
// cores with float32 tiles, as first written. Its bar against the plain
// version (rtol 1e-4, atol 1e-5) rules out TF32, and it serves the
// float32 agreement legs only. The score tile is held transposed so that
// p^T and ds^T are written to shared memory as the row-major left
// operand of the two products; one staging buffer takes Q, then dO, then
// Q again (head_dim 256 in float32 fits in 214 KB).

#include "attn_common.cuh"
#include "attn_tc.cuh"

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

// bfloat16 on the tensor cores: see the header and attn_tc.cuh.
template <int DP, bool VEC>
__global__ void __launch_bounds__(attn_tc::kTcThreads)
    attn_dkv_tc(const attn_tc::bf16* __restrict__ q,
                const attn_tc::bf16* __restrict__ k,
                const attn_tc::bf16* __restrict__ v,
                const attn_tc::bf16* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, attn_tc::bf16* __restrict__ dk,
                attn_tc::bf16* __restrict__ dv, int nblk, int sq, int sk, int d,
                int causal, float scale) {
  using namespace attn_tc;
  constexpr int NSPLIT = nsplit(DP), ROWG = rowg(DP);
  constexpr int OWN = kRows * ROWG;  // rows the block owns
  constexpr int NT = kTcThreads;
  constexpr int TE = tile_elems<DP>();
  constexpr int DC = DP / NSPLIT;  // accumulator columns of a warpgroup
  extern __shared__ unsigned char tc_smem[];
  bf16* Ks = reinterpret_cast<bf16*>(align_smem(tc_smem));
  bf16* Vs = Ks + ROWG * TE;
  bf16* ring = Vs + ROWG * TE;  // stage s: Q at 2 s TE, dO at (2 s + 1) TE
  float* stats = reinterpret_cast<float*>(ring + 2 * kStages * TE);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp & 3;            // the warp's 16 key rows
  const int rg = (warp >> 2) % ROWG;  // its warpgroup's 64 rows
  const int col0 = (warp >> 2) / ROWG * DC;  // and columns
  const int g = lane >> 2, t4 = lane & 3;
  const long long bh = blockIdx.x / nblk;
  const int k0 = (int)(blockIdx.x - bh * nblk) * OWN;
  const bf16* qb = q + bh * sq * d;
  const bf16* db = dout + bh * sq * d;
  const float* lseb = lse + bh * sq;
  const float* deltab = delta + bh * sq;

  if (VEC && d < DP) zero_cols<DP, NT>(Ks, 2 * ROWG + 2 * kStages, d);
  for (int r = 0; r < ROWG; ++r) {
    stage_tile<DP, NT, VEC>(Ks + r * TE, k + bh * sk * d, k0 + r * kRows,
                            sk, d);
    stage_tile<DP, NT, VEC>(Vs + r * TE, v + bh * sk * d, k0 + r * kRows,
                            sk, d);
  }

  const int nqt = (sq + kRows - 1) / kRows;
  // under causal, query tiles with q0 + kRows - 1 >= k0
  const int t0 = causal ? k0 / kRows : 0;
  auto load_stage = [&](int t, int st) {
    stage_tile<DP, NT, VEC>(ring + 2 * st * TE, qb, t * kRows, sq, d);
    stage_tile<DP, NT, VEC>(ring + (2 * st + 1) * TE, db, t * kRows, sq,
                            d);
    load_stats<NT>(stats + 2 * st * kRows, lseb, t * kRows, sq);
    load_stats<NT>(stats + (2 * st + 1) * kRows, deltab, t * kRows, sq);
  };
  if (t0 < nqt) load_stage(t0, 0);
  cp_async_commit();

  float acck[DC / 8][4], accv[DC / 8][4];
#pragma unroll
  for (int j = 0; j < DC / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acck[j][e] = accv[j][e] = 0.f;

  const float sl2 = scale * kLog2e;
  // the key position of fragment rows e < 2
  const int kw = k0 + rg * kRows + wr * 16 + g;
  for (int t = t0; t < nqt; ++t) {
    const int st = (t - t0) & 1;
    if (t + 1 < nqt) load_stage(t + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();   // tile t has landed (this thread's copies)
    fence_proxy_async();  // ... visible to the tensor cores
    __syncthreads();      // ... and every other thread's
    const int q0 = t * kRows;
    const bf16* Qs = ring + 2 * st * TE;
    const bf16* dOs = Qs + TE;
    const float* lse_s = stats + 2 * st * kRows;
    const float* delta_s = lse_s + kRows;
    const bool edge = q0 + kRows > sq || k0 + OWN > sk ||
                      (causal && k0 + OWN - 1 > q0);
    float s[kRows / 8][4], dp[kRows / 8][4];
    wg_score<DP>(s, Ks + rg * TE, Qs);
    wg_score<DP>(dp, Vs + rg * TE, dOs);
    wg_commit();
    wg_wait<0>();
    keep(s);
    keep(dp);
#pragma unroll
    for (int j = 0; j < kRows / 8; ++j) {
      const int ql = 8 * j + 2 * t4;  // local query column, e even
      const float2 L = *reinterpret_cast<const float2*>(lse_s + ql);
      const float2 Dl = *reinterpret_cast<const float2*>(delta_s + ql);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lv = (e & 1) ? L.y : L.x;
        const float dv_ = (e & 1) ? Dl.y : Dl.x;
        float p = ex2(fmaf(s[j][e], sl2, -lv * kLog2e));
        if (edge) {
          const int qi = q0 + ql + (e & 1);
          const int kj = kw + 8 * (e >> 1);
          if (qi >= sq || kj >= sk || (causal && kj > qi)) p = 0.f;
        }
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - dv_);
      }
    }
    uint32_t ap[kRows / 16][4], ads[kRows / 16][4];
    pack_a(ap, s);
    pack_a(ads, dp);
    wg_fence();
    wg_acc<DC>(accv, ap, dOs, col0);  // dv += p^T . do
    wg_acc<DC>(acck, ads, Qs, col0);  // dk += ds^T . q
    wg_commit();
    wg_wait<0>();
    keep(accv);
    keep(acck);
    keep(ap);
    keep(ads);
    __syncthreads();  // every warp is done with stage st before refill
  }
  cp_async_wait<0>();  // no copy outlives the block (none left if t0 >= nqt)

  const long long ob = bh * sk * d;
  const int r0 = k0 + rg * kRows + wr * 16;
  store_rows<DC, VEC>(dk + ob, acck, r0, sk, d, col0, scale, lane);
  store_rows<DC, VEC>(dv + ob, accv, r0, sk, d, col0, 1.f, lane);
}

// Dynamic shared memory of the tensor-core instance at DP.
template <int DP>
constexpr size_t kSmemTc =
    attn_tc::smem_bytes<DP>(2 * attn_tc::kStages * attn_tc::kRows);

int run_tc(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dk, void* dv,
           long long bh, int sq, int sk, int d, int causal, float scale,
           cudaStream_t stream) {
  using attn_tc::bf16;
  const bool vec = attn_tc::vec_ok(d, {q, k, v, dout, dk, dv});
  ATTN_TC_DISPATCH(
      d, vec,
      (attn_tc::launch<attn_dkv_tc<DP, VEC>>(
          bh * attn_tc::own_tiles(sk, DP), attn_tc::kTcThreads,
          kSmemTc<DP>, stream, static_cast<const bf16*>(q),
          static_cast<const bf16*>(k), static_cast<const bf16*>(v),
          static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dk),
          static_cast<bf16*>(dv), attn_tc::own_tiles(sk, DP), sq, sk, d,
          causal, scale)));
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
    return run_tc(q, k, v, dout, lf, df, dk, dv, bh, sq, sk, d, causal, scale,
                  s);
  return (int)cudaErrorInvalidValue;
}

// The bfloat16 instance's tile plan for head_dim d: plan[0..2] = DP,
// threads per block, dynamic shared memory bytes. Returns 0, or
// cudaErrorInvalidValue for d > 256.
extern "C" int attn_dkv_plan(int d, int* plan) {
  return plan_tc(d, plan);
}
