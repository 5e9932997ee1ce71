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
//
// head_dim > 256, the wide route (attn_dq_wide_tc in bfloat16,
// attn_dq_wide in float32; the chunking is described in attn_tc.cuh and
// attn_common.cuh): a block owns 64 query rows and 128 dq columns, one
// of d / 128 column blocks. For every key tile it sums s over the
// 128-column chunks of q and k, turns it into p, sums do . v^T over the
// chunks of do and v, forms ds and adds ds . k over its own 128 columns
// of k. Each column block recomputes both score products: (d / 128)
// (4 d + 256) B H Sq Sk flops in place of 6 B H Sq Sk d (3.0x at d 512,
// 5.7x at 1024; K2-fwd and K2-dkv compute each score tile once up to
// 512, the whole-head route of attn_tc.cuh).
// bfloat16: one warpgroup a block, 66,560 B of shared memory; float32:
// 256 threads, 82,688 B.

#include "attn_common.cuh"
#include "attn_tc.cuh"

namespace {

using namespace attn;

template <int DP>
__global__ void __launch_bounds__(kThreads)
    attn_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v,
                   const float* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dq,
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
  const float* kb = k + bh * sk * d;
  const float* vb = v + bh * sk * d;

  load_tile<DP>(Qs, q + bh * sq * d, q0, sq, d);
  load_tile<DP>(dOs, dout + bh * sq * d, q0, sq, d);

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
    load_tile<DP>(KVs, kb, k0, sk, d);
    __syncthreads();
    float s[4][4];
    tile_dot<DP>(s, Qs, KVs, d, ty, tx);
    __syncthreads();
    load_tile<DP>(KVs, vb, k0, sk, d);
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
            p * (dov[r][c] - row_delta[r]);
      }
    }
    __syncthreads();  // every thread is done reading V; Ds is written
    load_tile<DP>(KVs, kb, k0, sk, d);
    __syncthreads();
    const int n = sk - k0 < kTile ? sk - k0 : kTile;
    tile_acc<DP>(acc, Ds, KVs, n, ty, tx);
  }

  float* dqb = dq + bh * sq * d;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = q0 + ty + 16 * r;
    if (qi >= sq) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int dc = tx + 16 * c;
      if (dc < d) dqb[(long long)qi * d + dc] = scale * acc[r][c];
    }
  }
}

// float32, head_dim > 256 (the wide route; see the header): block
// (bh, query tile, column chunk cc), the chunk index fastest.
__global__ void __launch_bounds__(kThreads)
    attn_dq_wide(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dq,
                 int nqt, int nch, int sq, int sk, int d, int causal,
                 float scale) {
  extern __shared__ float smem[];
  constexpr int ld = kWide + 1;
  constexpr int NC = kWide / 16;
  float* As = smem;
  float* Bs = As + kTile * ld;
  float* Ds = Bs + kTile * ld;

  const int cc = (int)(blockIdx.x % nch);
  const long long qt = blockIdx.x / nch;
  const long long bh = qt / nqt;
  const int q0 = (int)(qt - bh * nqt) * kTile;
  const int c0 = cc * kWide;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const float* qb = q + bh * sq * d;
  const float* db = dout + bh * sq * d;
  const float* kb = k + bh * sk * d;
  const float* vb = v + bh * sk * d;

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
    float s[4][4], dov[4][4];
    wide_dot(s, As, Bs, qb, q0, sq, kb, k0, sk, d, ty, tx);
    wide_dot(dov, As, Bs, db, q0, sq, vb, k0, sk, d, ty, tx);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qi = q0 + ty + 16 * r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kj = k0 + tx + 16 * c;
        const bool masked = kj >= sk || (causal && kj > qi);
        const float p = masked ? 0.f : expf(s[r][c] * scale - row_lse[r]);
        Ds[(ty + 16 * r) * kPLd + tx + 16 * c] =
            p * (dov[r][c] - row_delta[r]);
      }
    }
    __syncthreads();  // every thread is done reading V; Ds is written
    load_cols<kWide>(Bs, kb, k0, sk, d, c0,
                     d - c0 < kWide ? d - c0 : kWide);
    __syncthreads();
    const int n = sk - k0 < kTile ? sk - k0 : kTile;
    tile_acc<kWide>(acc, Ds, Bs, n, ty, tx);
  }

  float* dqb = dq + bh * sq * d;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = q0 + ty + 16 * r;
    if (qi >= sq) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int dc = c0 + tx + 16 * c;
      if (dc < d) dqb[(long long)qi * d + dc] = scale * acc[r][c];
    }
  }
}

int run(const float* q, const float* k, const float* v, const float* dout,
        const float* lse, const float* delta, float* dq, long long bh,
        int sq, int sk, int d, int causal, float scale,
        cudaStream_t stream) {
  const int nqt = (sq + kTile - 1) / kTile;
  const int nch = wide_chunks(d);
  ATTN_DISPATCH_DP(
      d, (launch<attn_dq_kernel<DP>>(bh * nqt, smem_bytes<DP>(3), stream, q,
                                     k, v, dout, lse, delta, dq, nqt, sq,
                                     sk, d, causal, scale)),
      (launch<attn_dq_wide>(bh * nqt * nch, kWideSmem, stream, q, k, v, dout,
                            lse, delta, dq, nqt, nch, sq, sk, d, causal,
                            scale)));
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

// bfloat16, head_dim > 256 (the wide route; see the header and
// attn_tc.cuh): one warpgroup a block, block (bh, query tile, column
// chunk cc) with the chunk index fastest. The steps of a key tile: nch
// chunks of s (q and k chunk e), nch chunks of do . v^T (do and v chunk
// e), then k's columns [c0, c0 + 128) for dq += ds . k.
template <bool VEC>
__global__ void __launch_bounds__(attn_tc::kWideThreads, 2)
    attn_dq_wide_tc(const attn_tc::bf16* __restrict__ q,
                    const attn_tc::bf16* __restrict__ k,
                    const attn_tc::bf16* __restrict__ v,
                    const attn_tc::bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    attn_tc::bf16* __restrict__ dq, int nqt, int nch, int sq,
                    int sk, int d, int causal, float scale) {
  using namespace attn_tc;
  constexpr int TE = kWideTE;
  constexpr int NJ = kWideCols / 8;
  extern __shared__ unsigned char tc_smem[];
  bf16* ring = reinterpret_cast<bf16*>(align_smem(tc_smem));  // 2 TE a stage

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int cc = (int)(blockIdx.x % nch);
  const long long qt = blockIdx.x / nch;
  const long long bh = qt / nqt;
  const int q0 = (int)(qt - bh * nqt) * kRows;
  const int c0 = cc * kWideCols;
  const bf16* qp = q + bh * sq * d;
  const bf16* dop = dout + bh * sq * d;
  const bf16* kp = k + bh * sk * d;
  const bf16* vp = v + bh * sk * d;

  int nkt = (sk + kRows - 1) / kRows;
  if (causal) {
    const int last = (q0 + kRows - 1) / kRows + 1;
    nkt = nkt < last ? nkt : last;
  }
  const int per = 2 * nch + 1;  // steps a key tile
  const int total = nkt * per;
  auto load_step = [&](int i, int st) {
    const int t = i / per, j = i - t * per;
    bf16* dst = ring + 2 * st * TE;
    if (j < nch) {
      stage_chunk<VEC>(dst, qp, q0, sq, d, j * kWideCols);
      stage_chunk<VEC>(dst + TE, kp, t * kRows, sk, d, j * kWideCols);
    } else if (j < 2 * nch) {
      stage_chunk<VEC>(dst, dop, q0, sq, d, (j - nch) * kWideCols);
      stage_chunk<VEC>(dst + TE, vp, t * kRows, sk, d, (j - nch) * kWideCols);
    } else {
      stage_chunk<VEC>(dst, kp, t * kRows, sk, d, c0);
    }
  };
  if (total > 0) load_step(0, 0);
  cp_async_commit();

  // the fragment rows' query positions, lse and delta (rows g, g + 8)
  int qrow[2];
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    qrow[h] = q0 + warp * 16 + g + 8 * h;
    const bool ok = qrow[h] < sq;
    row_lse[h] = ok ? lse[bh * sq + qrow[h]] * kLog2e : 0.f;
    row_delta[h] = ok ? delta[bh * sq + qrow[h]] : 0.f;
  }
  float acc[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float s[kRows / 8][4], dp[kRows / 8][4];
  uint32_t a[kRows / 16][4];

  const float sl2 = scale * kLog2e;
  for (int i = 0; i < total; ++i) {
    const int st = i & 1;
    if (i + 1 < total) load_step(i + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();   // step i has landed (this thread's copies)
    fence_proxy_async();  // ... visible to the tensor cores
    __syncthreads();      // ... and every other thread's
    const int t = i / per, j = i - t * per;
    const int k0 = t * kRows;
    const bf16* A = ring + 2 * st * TE;
    const bool edge = q0 + kRows > sq || k0 + kRows > sk ||
                      (causal && k0 + kRows - 1 > q0);
    if (j < nch) {
      wg_score_chunk(s, opaque(desc_k(A)), opaque(desc_k(A + TE)), j == 0);
      wg_commit();
      wg_wait<0>();
      keep(s);
      if (j == nch - 1) {  // s -> p = exp(s - lse)
#pragma unroll
        for (int jj = 0; jj < kRows / 8; ++jj) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = e >> 1;
            float p = ex2(fmaf(s[jj][e], sl2, -row_lse[h]));
            if (edge) {
              const int kj = k0 + 8 * jj + 2 * t4 + (e & 1);
              if (qrow[h] >= sq || kj >= sk || (causal && kj > qrow[h]))
                p = 0.f;
            }
            s[jj][e] = p;
          }
        }
      }
    } else if (j < 2 * nch) {
      wg_score_chunk(dp, opaque(desc_k(A)), opaque(desc_k(A + TE)),
                     j == nch);
      wg_commit();
      wg_wait<0>();
      keep(dp);
      if (j == 2 * nch - 1) {  // ds = p * (do . v^T - delta)
#pragma unroll
        for (int jj = 0; jj < kRows / 8; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dp[jj][e] = s[jj][e] * (dp[jj][e] - row_delta[e >> 1]);
        pack_a(a, dp);
      }
    } else {
      wg_fence();
      wg_acc<kWideCols>(acc, a, opaque(desc_mn(A, 0)));  // dq += ds . k
      wg_commit();
      wg_wait<0>();
      keep(acc);
      keep(a);
    }
    __syncthreads();  // every warp is done with stage st before refill
  }
  cp_async_wait<0>();  // no copy outlives the block

  store_rows<kWideCols, VEC>(dq + bh * sq * d, acc, q0 + warp * 16, sq, d,
                             c0, scale, lane);
}

int run_tc(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dq, long long bh,
           int sq, int sk, int d, int causal, float scale,
           cudaStream_t stream) {
  using attn_tc::bf16;
  const bool vec = attn_tc::vec_ok(d, {q, k, v, dout, dq});
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  const bf16* db = static_cast<const bf16*>(dout);
  bf16* dqb = static_cast<bf16*>(dq);
  const int nqt = (sq + attn_tc::kRows - 1) / attn_tc::kRows;
  const int nch = attn_tc::wide_chunks(d);
  ATTN_TC_DISPATCH(
      d, vec,
      (attn_tc::launch<attn_dq_tc<DP, VEC>>(
          bh * attn_tc::own_tiles(sq, DP), attn_tc::kTcThreads,
          kSmemTc<DP>, stream, qb, kb, vb, db, lse, delta, dqb,
          attn_tc::own_tiles(sq, DP), sq, sk, d, causal, scale)),
      (attn_tc::launch<attn_dq_wide_tc<VEC>>(
          bh * nqt * nch, attn_tc::kWideThreads, attn_tc::kWideTcSmem,
          stream, qb, kb, vb, db, lse, delta, dqb, nqt, nch, sq, sk, d,
          causal, scale)));
}

int plan_tc(int d, int* plan) {
  // the plan does not depend on the load path
  ATTN_TC_DISPATCH(
      d, true,
      (plan[0] = DP, plan[1] = attn_tc::kTcThreads,
       plan[2] = (int)kSmemTc<DP>, plan[3] = DP, (void)VEC, 0),
      (plan[0] = attn_tc::wide_chunks(d) * attn_tc::kWideCols,
       plan[1] = attn_tc::kWideThreads, plan[2] = (int)attn_tc::kWideTcSmem,
       plan[3] = attn_tc::kWideCols, (void)VEC, 0));
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
    return run(static_cast<const float*>(q), static_cast<const float*>(k),
               static_cast<const float*>(v),
               static_cast<const float*>(dout), lf, df,
               static_cast<float*>(dq), bh, sq, sk, d, causal, scale, s);
  if (dtype == 1)
    return run_tc(q, k, v, dout, lf, df, dq, bh, sq, sk, d, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}

// The bfloat16 instance's tile plan for head_dim d: plan[0..3] = DP
// (past 256: d rounded up to whole 128-column chunks), threads per
// block, dynamic shared memory bytes, the head_dim columns a staged tile
// holds (DP, or 128 on the wide route). Returns 0.
extern "C" int attn_dq_plan(int d, int* plan) {
  return plan_tc(d, plan);
}
