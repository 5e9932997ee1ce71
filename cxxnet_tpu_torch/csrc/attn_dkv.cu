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
// head_dim > 256, the wide route (both routes are described in
// attn_tc.cuh, the float32 chunking in attn_common.cuh):
//
// bfloat16 up to 512, the whole-head route (attn_dkv_head_tc): dk and
// dv of 64 key rows take 2 x 64 x 512 float32 accumulators, the whole
// register file of a multiprocessor, so a cluster of two blocks owns
// them, block r the columns [256 r, 256 r + 256). Each keeps its half
// of k and v resident and streams its half of q and do in tiles of 32
// queries (a 3-stage ring, with their lse and delta). Its warpgroup 0
// sums its half of s^T = k . q^T and dp^T = v . do^T, the two blocks
// exchange these 64 x 32 float32 shares through distributed shared
// memory and each adds the other's (float addition commutes: both hold
// the same s^T and dp^T), forms p^T and ds^T and writes them (bf16) to
// shared memory while its next share products run; warpgroups 1 and 2
// stage the tiles, own 128 of the block's columns each and add p^T . do
// and ds^T . q, taking p^T and ds^T as their A operand from shared
// memory. One cluster barrier a step. It executes the 8 B H Sq Sk d
// useful flops once (at d 512) and stages q and do once per 64 key rows:
// 384 threads and 206,592 B of shared memory a block, one block a
// multiprocessor.
//
// bfloat16 past 512, the chunked route (attn_dkv_wide_tc), and float32
// (attn_dkv_wide): a block owns 64 key rows and 128 columns of both dk
// and dv, one of d / 128 column blocks. For every query tile it sums
// s^T = k . q^T and dp^T = v . do^T over the 128-column chunks, forms
// p^T and ds^T, and adds p^T . do and ds^T . q over its own 128 columns
// of do and q (both staged in the last step's stage). Each column block
// recomputes both score products: (d / 128) (4 d + 512) B H Sq Sk flops
// in place of 8 B H Sq Sk d (2.5x at d 512, 4.5x at 1024). lse and
// delta are read by each thread for its 16 query columns. bfloat16: one
// warpgroup a block, 2 x 64 accumulator floats a thread; p^T waits out
// the dp^T steps in shared memory (32 floats a thread), which keeps the
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

// bfloat16, head_dim > 512 (the chunked route; see the header and
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

// The cluster of the whole-head route: this block's rank, a barrier of
// every thread of both blocks (release / acquire at cluster scope, from
// any code path), and 16-byte reads of the other block's shared memory.
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive;\nbarrier.cluster.wait;\n" :::
                   "memory");
}
__device__ __forceinline__ uint32_t peer_addr(const void* p, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(attn_tc::smem_u32(p)), "r"(rank));
  return r;
}
__device__ __forceinline__ float4 peer_load4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}

// bfloat16, 256 < head_dim <= 512: the whole-head route (see the header
// and attn_tc.cuh). A cluster of two blocks owns 64 key rows; block r
// owns the columns [256 r, 256 r + 256) of d (those past d are zero and
// never stored): its half of k and v stays resident, and its half of q and do
// streams in tiles of kHeadRows queries through a ring of 3 stages (with
// their lse and delta), staged by warpgroups 1 and 2. Warpgroup 0 sums
// the block's share of s^T = k . q^T and dp^T = v . do^T and leaves it
// in shared memory for the other block; warpgroups 1 and 2 own 128 of
// the block's columns of dk and dv each and add p^T . do and ds^T . q
// over them. Step i opens with a cluster barrier (tile i has landed;
// both blocks' shares of tile i - 1 are written): warpgroup 0 issues the
// share products of tile i, and while they run adds the other block's
// share of tile i - 1 to its own (distributed shared memory; the same
// sum in both blocks, since float addition commutes), writes p^T and
// ds^T (bf16) and hands them to warpgroups 1 and 2 (a named barrier),
// which add the products of tile i - 1; the copies of tile i + 1 are in
// flight. A last cluster barrier keeps each block's shared memory alive
// until the other block's last reads of it have ended.
constexpr int kDkvHeadThreads = 384;
constexpr int kBarPds = 1;  // p^T and ds^T of the step are written

constexpr size_t kSmemHead =
    (2 * (size_t)attn_tc::kRows * attn_tc::kHalf +
     3 * 2 * (size_t)attn_tc::kHeadRows * attn_tc::kHalf +
     (size_t)attn_tc::kRows * 64) *
        sizeof(attn_tc::bf16) +
    (3 * 2 * attn_tc::kHeadRows + 4 * attn_tc::kRows * attn_tc::kHeadRows) *
        sizeof(float) +
    1024;

template <bool VEC>
__global__ void __cluster_dims__(2, 1, 1)
    __launch_bounds__(kDkvHeadThreads, 1)
    attn_dkv_head_tc(const attn_tc::bf16* __restrict__ q,
                     const attn_tc::bf16* __restrict__ k,
                     const attn_tc::bf16* __restrict__ v,
                     const attn_tc::bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     attn_tc::bf16* __restrict__ dk,
                     attn_tc::bf16* __restrict__ dv, int nkt, int sq, int sk,
                     int d, int causal, float scale) {
  using namespace attn_tc;
  constexpr int NT = kDkvHeadThreads;
  constexpr int NO = NT - 128;     // threads that stage: warpgroups 1-2
  constexpr int BM = kHeadRows;    // queries of a streamed tile
  constexpr int HW = kHalf;        // columns of a block
  constexpr int KE = kRows * HW;   // elements of the k or v half
  constexpr int SE = BM * HW;      // of a streamed q or do half
  constexpr int NS = 3;            // stages of the ring
  constexpr int NJ = BM / 8;       // fragment columns of a score tile
  extern __shared__ unsigned char tc_smem[];
  bf16* Ks = reinterpret_cast<bf16*>(align_smem(tc_smem));
  bf16* Vs = Ks + KE;
  bf16* ring = Vs + KE;  // stage s: q at 2 s SE, do at (2 s + 1) SE
  bf16* PDs = ring + NS * 2 * SE;  // p^T in columns [0, BM), ds^T [BM, 2 BM)
  float* stats = reinterpret_cast<float*>(PDs + kRows * 64);  // lse, delta
  // two buffers of the shares of s^T and dp^T: fragment column j of
  // thread t at float4 X + b XB + j * 128 + t (s^T), + (NJ + j) * 128 + t
  // (dp^T)
  constexpr int XB = 2 * NJ * 128;
  float4* X = reinterpret_cast<float4*>(stats + NS * 2 * BM);

  const uint32_t rank = cluster_rank();
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = warp * 16 + g;  // the fragment's key rows r0, r0 + 8
  const long long kt = blockIdx.x >> 1;
  const long long bh = kt / nkt;
  const int k0 = (int)(kt - bh * nkt) * kRows;
  const int c0 = (int)rank * HW;
  const bf16* qp = q + bh * sq * d;
  const bf16* dop = dout + bh * sq * d;
  const float* lseb = lse + bh * sq;
  const float* deltab = delta + bh * sq;

  const int nqt = (sq + BM - 1) / BM;
  // under causal, query tiles with q0 + BM - 1 >= k0
  const int t0 = causal ? k0 / BM : 0;
  const int n = t0 < nqt ? nqt - t0 : 0;  // tiles: the same in both blocks
  const int tid = threadIdx.x - 128;      // of the staging threads
  auto load_tile = [&](int j, int st) {
    const int r = (t0 + j) * BM;
    stage_rows<BM, HW, NO, VEC>(ring + 2 * st * SE, qp, r, sq, d, c0, tid);
    stage_rows<BM, HW, NO, VEC>(ring + (2 * st + 1) * SE, dop, r, sq, d, c0,
                                tid);
    load_stats32<NO>(stats + 2 * st * BM, lseb, r, sq, tid);
    load_stats32<NO>(stats + (2 * st + 1) * BM, deltab, r, sq, tid);
  };
  if (wg > 0) {
    stage_rows<kRows, HW, NO, VEC>(Ks, k + bh * sk * d, k0, sk, d, c0, tid);
    stage_rows<kRows, HW, NO, VEC>(Vs, v + bh * sk * d, k0, sk, d, c0, tid);
    if (n > 0) load_tile(0, 0);
    cp_async_commit();
  }

  if (wg == 0) {  // the shares of s^T, dp^T; then p^T, ds^T
    const uint32_t xpeer = peer_addr(X, rank ^ 1u);
    const float sl2 = scale * kLog2e;
    const int kw = k0 + r0;  // the key position of fragment rows e < 2
    const uint64_t kd = desc_k(Ks), vd = desc_k(Vs);
    for (int i = 0; i <= n && n > 0; ++i) {
      cluster_sync();  // tile i has landed; the shares of i - 1 are written
      float s[NJ][4], dp[NJ][4];
      if (i < n) {  // issued here, waited on after p^T and ds^T of i - 1
        const bf16* Qt = ring + 2 * (i % NS) * SE;
        const uint64_t qd = opaque(desc_k(Qt)), dd = opaque(desc_k(Qt + SE));
        wg_score32<HW / 16>(s, opaque(kd), qd);
        wg_score32<HW / 16>(dp, opaque(vd), dd);
        wg_commit();
      }
      if (i > 0) {  // p^T and ds^T of tile i - 1
        const int b = (i - 1) & 1;
        const float4* own = X + b * XB + threadIdx.x;
        float4 xs[NJ], xd[NJ];  // both blocks' shares, all loads in flight
        float4 ys[NJ], yd[NJ];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          xs[j] = peer_load4(xpeer + ((b * XB + j * 128 + threadIdx.x) << 4));
          xd[j] = peer_load4(
              xpeer + ((b * XB + (NJ + j) * 128 + threadIdx.x) << 4));
          ys[j] = own[j * 128];
          yd[j] = own[(NJ + j) * 128];
        }
        const int st = (i - 1) % NS;
        const int q0 = (t0 + i - 1) * BM;
        const float* L = stats + 2 * st * BM;
        const float* Dl = L + BM;
        const bool edge = q0 + BM > sq || k0 + kRows > sk ||
                          (causal && k0 + kRows - 1 > q0);
        float pt[NJ][4], dst[NJ][4];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int ql = 8 * j + 2 * t4;  // local query column, e even
          const float2 Lv = *reinterpret_cast<const float2*>(L + ql);
          const float2 Dv = *reinterpret_cast<const float2*>(Dl + ql);
          const float ss[4] = {ys[j].x + xs[j].x, ys[j].y + xs[j].y,
                               ys[j].z + xs[j].z, ys[j].w + xs[j].w};
          const float sd[4] = {yd[j].x + xd[j].x, yd[j].y + xd[j].y,
                               yd[j].z + xd[j].z, yd[j].w + xd[j].w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float lv = (e & 1) ? Lv.y : Lv.x;
            const float dl = (e & 1) ? Dv.y : Dv.x;
            float p = ex2(fmaf(ss[e], sl2, -lv * kLog2e));
            if (edge) {
              const int qi = q0 + ql + (e & 1);
              const int kj = kw + 8 * (e >> 1);
              if (qi >= sq || kj >= sk || (causal && kj > qi)) p = 0.f;
            }
            pt[j][e] = p;
            dst[j][e] = p * (sd[e] - dl);
          }
        }
        put_a32(PDs, pt, r0, 0, t4);    // p.astype(do.dtype)^T
        put_a32(PDs, dst, r0, BM, t4);  // ds.astype(q.dtype)^T
        fence_proxy_async();  // ... for the output side's tensor cores
        bar_arrive(kBarPds, NT);
      }
      if (i < n) {  // this block's shares of tile i, for step i + 1
        wg_wait<0>();
        keep(s);
        keep(dp);
        float4* mine = X + (i & 1) * XB + threadIdx.x;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          mine[j * 128] = make_float4(s[j][0], s[j][1], s[j][2], s[j][3]);
          mine[(NJ + j) * 128] =
              make_float4(dp[j][0], dp[j][1], dp[j][2], dp[j][3]);
        }
      }
    }
  } else {  // the copies; dv += p^T . do, dk += ds^T . q over 128 columns
    const int cw = (wg - 1) * 128;  // within the block's half
    float acck[16][4], accv[16][4];
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acck[j][e] = accv[j][e] = 0.f;
    for (int i = 0; i <= n && n > 0; ++i) {
      cp_async_wait<0>();   // tile i (at i = 0 also k and v) has landed
      fence_proxy_async();  // ... visible to the tensor cores
      cluster_sync();
      // stage (i + 1) % NS last held tile i - 2, whose products ended in
      // step i - 1
      if (i + 1 < n) load_tile(i + 1, (i + 1) % NS);
      cp_async_commit();
      if (i == 0) continue;
      bar_sync(kBarPds, NT);  // p^T and ds^T of tile i - 1
      const bf16* Qt = ring + 2 * ((i - 1) % NS) * SE;
      const uint64_t pd = opaque(desc_k(PDs));
      wg_fence();
      wg_acc32<128>(accv, pd, opaque(desc_mn32(Qt + SE, cw)));
      wg_acc32<128>(acck, pd + (BM * 2 >> 4), opaque(desc_mn32(Qt, cw)));
      wg_commit();
      wg_wait<0>();
      keep(accv);
      keep(acck);
    }
    const long long ob = bh * sk * d;
    store_rows<128, VEC>(dk + ob, acck, k0 + warp * 16, sk, d, c0 + cw,
                         scale, lane);
    store_rows<128, VEC>(dv + ob, accv, k0 + warp * 16, sk, d, c0 + cw, 1.f,
                         lane);
  }
  cp_async_wait<0>();  // no copy outlives the block
  // every thread of both blocks: the other block's last reads of this
  // block's shares (step n) end before either block exits
  cluster_sync();
}

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
  if (d > 256 && d <= attn_tc::kHeadMax) {
    ATTN_TC_VEC(vec, (attn_tc::launch<attn_dkv_head_tc<VEC>>(
                         bh * nkt * 2, kDkvHeadThreads, kSmemHead, stream, qb,
                         kb, vb, db, lse, delta, dkb, dvb, nkt, sq, sk, d,
                         causal, scale)));
  }
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
  if (d > 256 && d <= attn_tc::kHeadMax) {
    plan[0] = attn_tc::kHeadMax;
    plan[1] = kDkvHeadThreads;
    plan[2] = (int)kSmemHead;
    plan[3] = attn_tc::kHalf;
    plan[4] = 2;
    return 0;
  }
  plan[4] = 1;  // no cluster
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
// attn_dq_plan (on the whole-head route, 257-512: DP 512 and the 256
// columns of a block's half), plan[4] the blocks a cluster (2 on the
// whole-head route, else 1). Returns 0.
extern "C" int attn_dkv_plan(int d, int* plan) {
  return plan_tc(d, plan);
}
