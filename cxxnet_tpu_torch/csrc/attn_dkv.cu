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
//
// head_dim > 256, the wide route (attn_dkv_wide_tc in bfloat16,
// attn_dkv_wide in float32; the chunking is described in attn_tc.cuh and
// attn_common.cuh): a block owns 64 key rows and 128 columns of both dk
// and dv, one of d / 128 column blocks. For every query tile it sums
// s^T = k . q^T and dp^T = v . do^T over the 128-column chunks, forms
// p^T and ds^T, and adds p^T . do and ds^T . q over its own 128 columns
// of do and q (both staged in the last step's stage). Each column block
// recomputes both score products: (4 d / 128 + 4) B H Sq Sk 128 flops
// in place of 8 B H Sq Sk d (1.5x at d 512). lse and delta are read by
// each thread for its 16 query columns. bfloat16: one warpgroup a
// block, 2 x 64 accumulator floats a thread; p^T waits out the dp^T
// steps in shared memory (32 floats a thread), which keeps the
// accumulators, dp^T and the copies in flight within 255 registers with
// no spill: 82,944 B of shared memory. float32: 256 threads, 82,688 B.

#include "attn_common.cuh"
#include "attn_tc.cuh"

namespace {

using namespace attn;

template <int DP>
__global__ void __launch_bounds__(kThreads)
    attn_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dk,
                    float* __restrict__ dv, int nkt, int sq, int sk, int d,
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
  const float* qb = q + bh * sq * d;
  const float* db = dout + bh * sq * d;
  const float* lseb = lse + bh * sq;
  const float* deltab = delta + bh * sq;

  load_tile<DP>(Ks, k + bh * sk * d, k0, sk, d);
  load_tile<DP>(Vs, v + bh * sk * d, k0, sk, d);

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
    load_tile<DP>(Xs, qb, q0, sq, d);
    __syncthreads();
    float s[4][4];  // s[r][c] = k[ty + 16 r] . q[tx + 16 c]
    tile_dot<DP>(s, Ks, Xs, d, ty, tx);
    __syncthreads();
    load_tile<DP>(Xs, db, q0, sq, d);
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
        Ts[(ty + 16 * r) * kPLd + tx + 16 * c] = p;
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
        Ts[(ty + 16 * r) * kPLd + tx + 16 * c] = ds[r][c];
    load_tile<DP>(Xs, qb, q0, sq, d);
    __syncthreads();
    tile_acc<DP>(acck, Ts, Xs, n, ty, tx);  // dk += ds^T . q
  }

  float* dkb = dk + bh * sk * d;
  float* dvb = dv + bh * sk * d;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int kj = k0 + ty + 16 * r;
    if (kj >= sk) continue;  // padding rows are never stored
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int dc = tx + 16 * c;
      if (dc < d) {
        dkb[(long long)kj * d + dc] = scale * acck[r][c];
        dvb[(long long)kj * d + dc] = accv[r][c];
      }
    }
  }
}

// float32, head_dim > 256 (the wide route; see the header): block
// (bh, key tile, column chunk cc), the chunk index fastest.
__global__ void __launch_bounds__(kThreads)
    attn_dkv_wide(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, float* __restrict__ dk,
                  float* __restrict__ dv, int nkt, int nch, int sq, int sk,
                  int d, int causal, float scale) {
  extern __shared__ float smem[];
  constexpr int ld = kWide + 1;
  constexpr int NC = kWide / 16;
  float* As = smem;
  float* Bs = As + kTile * ld;
  float* Ts = Bs + kTile * ld;

  const int cc = (int)(blockIdx.x % nch);
  const long long kt = blockIdx.x / nch;
  const long long bh = kt / nkt;
  const int k0 = (int)(kt - bh * nkt) * kTile;
  const int c0 = cc * kWide;
  const int w0 = d - c0 < kWide ? d - c0 : kWide;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const float* qb = q + bh * sq * d;
  const float* db = dout + bh * sq * d;
  const float* kb = k + bh * sk * d;
  const float* vb = v + bh * sk * d;
  const float* lseb = lse + bh * sq;
  const float* deltab = delta + bh * sq;

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
    float s[4][4], dov[4][4];  // k . q^T and (do . v^T) transposed
    wide_dot(s, As, Bs, kb, k0, sk, qb, q0, sq, d, ty, tx);
    wide_dot(dov, As, Bs, vb, k0, sk, db, q0, sq, d, ty, tx);
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
        Ts[(ty + 16 * r) * kPLd + tx + 16 * c] = p;
      }
    }
    __syncthreads();  // p^T is written; every thread is done with Bs
    load_cols<kWide>(Bs, db, q0, sq, d, c0, w0);
    __syncthreads();
    const int n = sq - q0 < kTile ? sq - q0 : kTile;
    tile_acc<kWide>(accv, Ts, Bs, n, ty, tx);  // dv += p^T . do
    __syncthreads();  // every thread is done reading p^T and dO
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        Ts[(ty + 16 * r) * kPLd + tx + 16 * c] = ds[r][c];
    load_cols<kWide>(Bs, qb, q0, sq, d, c0, w0);
    __syncthreads();
    tile_acc<kWide>(acck, Ts, Bs, n, ty, tx);  // dk += ds^T . q
  }

  float* dkb = dk + bh * sk * d;
  float* dvb = dv + bh * sk * d;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int kj = k0 + ty + 16 * r;
    if (kj >= sk) continue;  // padding rows are never stored
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int dc = c0 + tx + 16 * c;
      if (dc < d) {
        dkb[(long long)kj * d + dc] = scale * acck[r][c];
        dvb[(long long)kj * d + dc] = accv[r][c];
      }
    }
  }
}

int run(const float* q, const float* k, const float* v, const float* dout,
        const float* lse, const float* delta, float* dk, float* dv,
        long long bh, int sq, int sk, int d, int causal, float scale,
        cudaStream_t stream) {
  const int nkt = (sk + kTile - 1) / kTile;
  const int nch = wide_chunks(d);
  ATTN_DISPATCH_DP(
      d, (launch<attn_dkv_kernel<DP>>(bh * nkt, smem_bytes<DP>(3), stream, q,
                                      k, v, dout, lse, delta, dk, dv, nkt,
                                      sq, sk, d, causal, scale)),
      (launch<attn_dkv_wide>(bh * nkt * nch, kWideSmem, stream, q, k, v,
                             dout, lse, delta, dk, dv, nkt, nch, sq, sk, d,
                             causal, scale)));
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

// bfloat16, head_dim > 256 (the wide route; see the header and
// attn_tc.cuh): one warpgroup a block, block (bh, key tile, column chunk
// cc) with the chunk index fastest. The steps of a query tile: nch
// chunks of s^T (k and q chunk e), nch chunks of dp^T (v and do chunk
// e), then do's and q's columns [c0, c0 + 128) for dv += p^T . do and
// dk += ds^T . q.
template <bool VEC>
__global__ void __launch_bounds__(attn_tc::kWideThreads, 2)
    attn_dkv_wide_tc(const attn_tc::bf16* __restrict__ q,
                     const attn_tc::bf16* __restrict__ k,
                     const attn_tc::bf16* __restrict__ v,
                     const attn_tc::bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     attn_tc::bf16* __restrict__ dk,
                     attn_tc::bf16* __restrict__ dv, int nkt, int nch, int sq,
                     int sk, int d, int causal, float scale) {
  using namespace attn_tc;
  constexpr int TE = kWideTE;
  constexpr int NJ = kWideCols / 8;
  extern __shared__ unsigned char tc_smem[];
  bf16* ring = reinterpret_cast<bf16*>(align_smem(tc_smem));  // 2 TE a stage
  // p^T during the dp^T steps: element (jj, e) of thread x at
  // (4 jj + e) * kWideThreads + x
  float* park = reinterpret_cast<float*>(ring + 2 * kStages * TE);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int cc = (int)(blockIdx.x % nch);
  const long long kt = blockIdx.x / nch;
  const long long bh = kt / nkt;
  const int k0 = (int)(kt - bh * nkt) * kRows;
  const int c0 = cc * kWideCols;
  const bf16* qp = q + bh * sq * d;
  const bf16* dop = dout + bh * sq * d;
  const bf16* kp = k + bh * sk * d;
  const bf16* vp = v + bh * sk * d;
  const float* lseb = lse + bh * sq;
  const float* deltab = delta + bh * sq;

  const int nqt = (sq + kRows - 1) / kRows;
  // under causal, query tiles with q0 + kRows - 1 >= k0
  const int t0 = causal ? k0 / kRows : 0;
  const int per = 2 * nch + 1;  // steps a query tile
  const int total = t0 < nqt ? (nqt - t0) * per : 0;
  auto load_step = [&](int i, int st) {
    const int ti = i / per, j = i - ti * per;
    const int q0 = (t0 + ti) * kRows;
    bf16* dst = ring + 2 * st * TE;
    if (j < nch) {
      stage_chunk<VEC>(dst, kp, k0, sk, d, j * kWideCols);
      stage_chunk<VEC>(dst + TE, qp, q0, sq, d, j * kWideCols);
    } else if (j < 2 * nch) {
      stage_chunk<VEC>(dst, vp, k0, sk, d, (j - nch) * kWideCols);
      stage_chunk<VEC>(dst + TE, dop, q0, sq, d, (j - nch) * kWideCols);
    } else {
      stage_chunk<VEC>(dst, dop, q0, sq, d, c0);
      stage_chunk<VEC>(dst + TE, qp, q0, sq, d, c0);
    }
  };
  if (total > 0) load_step(0, 0);
  cp_async_commit();

  float acck[NJ][4], accv[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acck[j][e] = accv[j][e] = 0.f;
  float s[kRows / 8][4], dp[kRows / 8][4];
  uint32_t ap[kRows / 16][4], ads[kRows / 16][4];

  const float sl2 = scale * kLog2e;
  // the key position of fragment rows e < 2
  const int kw = k0 + warp * 16 + g;
  for (int i = 0; i < total; ++i) {
    const int st = i & 1;
    if (i + 1 < total) load_step(i + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();   // step i has landed (this thread's copies)
    fence_proxy_async();  // ... visible to the tensor cores
    __syncthreads();      // ... and every other thread's
    const int ti = i / per, j = i - ti * per;
    const int q0 = (t0 + ti) * kRows;
    const bf16* A = ring + 2 * st * TE;
    const bool edge = q0 + kRows > sq || k0 + kRows > sk ||
                      (causal && k0 + kRows - 1 > q0);
    if (j < nch) {
      wg_score_chunk(s, opaque(desc_k(A)), opaque(desc_k(A + TE)), j == 0);
      wg_commit();
      wg_wait<0>();
      keep(s);
      if (j == nch - 1) {  // s^T -> p^T = exp(s^T - lse)
#pragma unroll
        for (int jj = 0; jj < kRows / 8; ++jj) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = q0 + 8 * jj + 2 * t4 + (e & 1);
            const float lv = qi < sq ? lseb[qi] : 0.f;
            float p = ex2(fmaf(s[jj][e], sl2, -lv * kLog2e));
            if (edge) {
              const int kj = kw + 8 * (e >> 1);
              if (qi >= sq || kj >= sk || (causal && kj > qi)) p = 0.f;
            }
            park[(4 * jj + e) * kWideThreads + threadIdx.x] = p;
            // a constant until the next query tile's first chunk: the
            // wgmma operand constraints would otherwise keep s^T live
            // through every dp^T step
            s[jj][e] = 0.f;
          }
        }
      }
    } else if (j < 2 * nch) {
      wg_score_chunk(dp, opaque(desc_k(A)), opaque(desc_k(A + TE)),
                     j == nch);
      wg_commit();
      wg_wait<0>();
      keep(dp);
      if (j == 2 * nch - 1) {  // ds^T = p^T * (dp^T - delta)
        auto pk = [&](int jj, int e) {
          return park[(4 * jj + e) * kWideThreads + threadIdx.x];
        };
#pragma unroll
        for (int jj = 0; jj < kRows / 8; ++jj) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = q0 + 8 * jj + 2 * t4 + (e & 1);
            const float dl = qi < sq ? deltab[qi] : 0.f;
            dp[jj][e] = pk(jj, e) * (dp[jj][e] - dl);
          }
        }
        // p^T as pack_a lays out a score fragment, from its park
#pragma unroll
        for (int ks = 0; ks < kRows / 16; ++ks) {
          ap[ks][0] = pack_bf16(pk(2 * ks, 0), pk(2 * ks, 1));
          ap[ks][1] = pack_bf16(pk(2 * ks, 2), pk(2 * ks, 3));
          ap[ks][2] = pack_bf16(pk(2 * ks + 1, 0), pk(2 * ks + 1, 1));
          ap[ks][3] = pack_bf16(pk(2 * ks + 1, 2), pk(2 * ks + 1, 3));
        }
        pack_a(ads, dp);
#pragma unroll
        for (int jj = 0; jj < kRows / 8; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) dp[jj][e] = 0.f;  // as s^T above
      }
    } else {
      wg_fence();
      wg_acc<kWideCols>(accv, ap, opaque(desc_mn(A, 0)));  // dv += p^T . do
      wg_acc<kWideCols>(acck, ads, opaque(desc_mn(A + TE, 0)));  // dk
      wg_commit();
      wg_wait<0>();
      keep(accv);
      keep(acck);
      keep(ap);
      keep(ads);
    }
    __syncthreads();  // every warp is done with stage st before refill
  }
  cp_async_wait<0>();  // no copy outlives the block

  const long long ob = bh * sk * d;
  const int r0 = k0 + warp * 16;
  store_rows<kWideCols, VEC>(dk + ob, acck, r0, sk, d, c0, scale, lane);
  store_rows<kWideCols, VEC>(dv + ob, accv, r0, sk, d, c0, 1.f, lane);
}

// Dynamic shared memory of the wide instance: the ring and p^T's park.
constexpr size_t kSmemWide =
    attn_tc::kWideTcSmem + (size_t)attn_tc::kRows * attn_tc::kRows * 4;

int run_tc(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dk, void* dv,
           long long bh, int sq, int sk, int d, int causal, float scale,
           cudaStream_t stream) {
  using attn_tc::bf16;
  const bool vec = attn_tc::vec_ok(d, {q, k, v, dout, dk, dv});
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  const bf16* db = static_cast<const bf16*>(dout);
  bf16* dkb = static_cast<bf16*>(dk);
  bf16* dvb = static_cast<bf16*>(dv);
  const int nkt = (sk + attn_tc::kRows - 1) / attn_tc::kRows;
  const int nch = attn_tc::wide_chunks(d);
  ATTN_TC_DISPATCH(
      d, vec,
      (attn_tc::launch<attn_dkv_tc<DP, VEC>>(
          bh * attn_tc::own_tiles(sk, DP), attn_tc::kTcThreads,
          kSmemTc<DP>, stream, qb, kb, vb, db, lse, delta, dkb, dvb,
          attn_tc::own_tiles(sk, DP), sq, sk, d, causal, scale)),
      (attn_tc::launch<attn_dkv_wide_tc<VEC>>(
          bh * nkt * nch, attn_tc::kWideThreads, kSmemWide,
          stream, qb, kb, vb, db, lse, delta, dkb, dvb, nkt, nch, sq, sk, d,
          causal, scale)));
}

int plan_tc(int d, int* plan) {
  // the plan does not depend on the load path
  ATTN_TC_DISPATCH(
      d, true,
      (plan[0] = DP, plan[1] = attn_tc::kTcThreads,
       plan[2] = (int)kSmemTc<DP>, plan[3] = DP, (void)VEC, 0),
      (plan[0] = attn_tc::wide_chunks(d) * attn_tc::kWideCols,
       plan[1] = attn_tc::kWideThreads, plan[2] = (int)kSmemWide,
       plan[3] = attn_tc::kWideCols, (void)VEC, 0));
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
    return run(static_cast<const float*>(q), static_cast<const float*>(k),
               static_cast<const float*>(v),
               static_cast<const float*>(dout), lf, df,
               static_cast<float*>(dk), static_cast<float*>(dv), bh, sq, sk,
               d, causal, scale, s);
  if (dtype == 1)
    return run_tc(q, k, v, dout, lf, df, dk, dv, bh, sq, sk, d, causal, scale,
                  s);
  return (int)cudaErrorInvalidValue;
}

// The bfloat16 instance's tile plan for head_dim d: plan[0..3] as for
// attn_dq_plan. Returns 0.
extern "C" int attn_dkv_plan(int d, int* plan) {
  return plan_tc(d, plan);
}
