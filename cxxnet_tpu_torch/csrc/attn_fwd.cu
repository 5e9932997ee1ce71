// Flash-attention forward (K2-fwd) for Hopper (sm_90a): a bfloat16
// instance on the tensor cores and a float32 instance on the CUDA cores,
// picked by dtype.
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
// position > query position (global coordinates, also for Sq != Sk). Key
// tiles that lie wholly in the future of a causal query block are
// skipped, as the TPU kernel's pl.when does. p rounds to T as the A
// operand of p . v, and every sum is float32 - the TPU kernel's rounding
// points (p.astype(v_ref.dtype)).
//
// What bounds it: operations, 4 B H Sq Sk D flops (q.k^T and p.v; under
// causal about half) against 4 tensors read or written once. The TPU
// kernel ran (1024, 1024) tiles through the matrix unit with f32 scratch
// carried across the sequential KV grid axis; here a block owns a range
// of query rows and loops over the key tiles, keeping m, l and the
// output accumulator in registers.
//
// bfloat16 (attn_fwd_tc, machinery in attn_tc.cuh): wgmma on the tensor
// cores. s = q . k^T is a 64 x 64 score tile per warpgroup (both operands
// K-major from the 128-byte-swizzled tiles); m and l sit on the
// accumulator fragment's rows, reduced across the 4 lanes of a quad by
// shuffles; p, rounded to bf16 in registers, is the A operand of
// acc += p . v (v read MN-major through the transpose flag). Q stays
// resident in shared memory; K and V stream through a 2-stage ring of
// asynchronous copies, shared by the block's warpgroups. Tile plan per
// DP bucket (head_dim rounded up to a power of two of at least 64):
//
//   head_dim  DP   Sq     query rows  threads  shared memory (swizzled
//                         a block              64 x DP bf16 tiles, 1 KB
//                                              alignment)
//   1-64      64   > 64   128         256       50,176 B
//                  <= 64  64          128       41,984 B
//   65-128    128  > 64   128         256       99,328 B
//                  <= 64  64          128       82,944 B
//   129-256   256  any    64          256      164,864 B  (the warpgroups
//                                                split the output columns
//                                                and each recomputes the
//                                                scores: 64 accumulator
//                                                floats a thread)
//
// A sequence of at most 64 queries (seq_mnist's 28) takes one warpgroup
// and a 64-row block, so that no warpgroup of the block idles. The
// instances are built for two blocks a multiprocessor up to DP 128 (128
// registers a thread; four blocks of one warpgroup at DP 64): each
// warpgroup waits on its own products, so the second block's products
// fill the tensor cores while the first one's exp and row sums run.
//
// float32 (attn_fwd_kernel, attn_common.cuh): 256 threads on the CUDA
// cores with float32 tiles, 64 query rows a block, as first written. Its
// bar against the plain version (rtol 1e-5) rules out TF32, and it serves
// the float32 agreement legs only.

#include "attn_common.cuh"
#include "attn_tc.cuh"

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

// bfloat16 on the tensor cores: see the header and attn_tc.cuh. WG
// warpgroups a block: WG = 2 owns 128 query rows (64 at DP 256, where the
// warpgroups split the output columns), WG = 1 owns 64.
template <int DP, int WG>
__host__ __device__ constexpr int fwd_rowg() {
  return WG / attn_tc::nsplit(DP);
}

template <int DP, int WG>
constexpr size_t kSmemFwd = (size_t)(fwd_rowg<DP, WG>() +
                                     2 * attn_tc::kStages) *
                                attn_tc::tile_elems<DP>() *
                                sizeof(attn_tc::bf16) +
                            1024;

// Blocks a multiprocessor should hold, for the register budget: two of
// 2 warpgroups (128 registers a thread) up to DP 128, so that one block's
// softmax overlaps the other's products - but one for the element-load
// path at DP 128, whose loads need more registers than that; four of one
// warpgroup at DP 64; at DP 256 shared memory allows one.
template <int DP, int WG, bool VEC>
__host__ __device__ constexpr int fwd_min_blocks() {
  if (DP == 256) return 1;
  if (WG == 2) return DP == 128 && !VEC ? 1 : 2;
  return DP == 64 ? 4 : 2;
}

template <int DP, bool VEC, int WG>
__global__ void __launch_bounds__(WG * 128,
                                  (fwd_min_blocks<DP, WG, VEC>()))
    attn_fwd_tc(const attn_tc::bf16* __restrict__ q,
                const attn_tc::bf16* __restrict__ k,
                const attn_tc::bf16* __restrict__ v,
                attn_tc::bf16* __restrict__ o, float* __restrict__ lse,
                int nblk, int sq, int sk, int d, int causal, float scale) {
  using namespace attn_tc;
  constexpr int NSPLIT = nsplit(DP), ROWG = fwd_rowg<DP, WG>();
  static_assert(ROWG >= 1, "DP 256 needs 2 warpgroups");
  constexpr int OWN = kRows * ROWG;  // query rows the block owns
  constexpr int NT = WG * 128;
  constexpr int TE = tile_elems<DP>();
  constexpr int DC = DP / NSPLIT;  // output columns of a warpgroup
  extern __shared__ unsigned char tc_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(align_smem(tc_smem));
  bf16* ring = Qs + ROWG * TE;  // stage s: K at 2 s TE, V at (2 s + 1) TE

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp & 3;            // the warp's 16 query rows
  const int rg = (warp >> 2) % ROWG;  // its warpgroup's 64 rows
  const int col0 = (warp >> 2) / ROWG * DC;  // and output columns
  const int g = lane >> 2, t4 = lane & 3;
  const long long bh = blockIdx.x / nblk;
  // under causal the last query blocks have the most key tiles: they
  // start first, so that the short ones fill the tail of the grid
  const int qb = (int)(blockIdx.x - bh * nblk);
  const int q0 = (causal ? nblk - 1 - qb : qb) * OWN;
  const bf16* kb = k + bh * sk * d;
  const bf16* vb = v + bh * sk * d;

  if (VEC && d < DP) zero_cols<DP, NT>(Qs, ROWG + 2 * kStages, d);
  for (int r = 0; r < ROWG; ++r)
    stage_tile<DP, NT, VEC>(Qs + r * TE, q + bh * sq * d, q0 + r * kRows,
                            sq, d);

  int nkt = (sk + kRows - 1) / kRows;
  if (causal) {  // key tiles with k0 <= q0 + OWN - 1
    const int last = (q0 + OWN - 1) / kRows + 1;
    nkt = nkt < last ? nkt : last;
  }
  auto load_stage = [&](int t, int st) {
    stage_tile<DP, NT, VEC>(ring + 2 * st * TE, kb, t * kRows, sk, d);
    stage_tile<DP, NT, VEC>(ring + (2 * st + 1) * TE, vb, t * kRows, sk,
                            d);
  };
  load_stage(0, 0);
  cp_async_commit();

  // the fragment rows' query positions (rows g, g + 8 of the warp) and
  // their running max (of s * scale) and sum
  const int wrow = q0 + rg * kRows + wr * 16;
  int qrow[2];
  float m[2], l[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    qrow[h] = wrow + g + 8 * h;
    m[h] = attn::kNeg;
    l[h] = 0.f;
  }
  float acc[DC / 8][4];
#pragma unroll
  for (int j = 0; j < DC / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

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
    // the warp's 16 rows need a mask only on the key padding or the
    // causal diagonal
    const bool edge = k0 + kRows > sk || (causal && k0 + kRows - 1 > wrow);
    float s[kRows / 8][4];
    wg_score<DP>(s, opaque(desc_k(Qs + rg * TE)),
                 opaque(desc_k(Kt)));
    wg_commit();
    wg_wait<0>();
    keep(s);
    float mx[2] = {attn::kNeg, attn::kNeg};
#pragma unroll
    for (int j = 0; j < kRows / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale;
        if (edge) {
          const int kj = k0 + 8 * j + 2 * t4 + (e & 1);
          if (kj >= sk || (causal && kj > qrow[e >> 1])) x = attn::kNeg;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    // a row's 64 scores sit on the 4 lanes of a quad
    float corr[2], ml2[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float mn = fmaxf(m[h], mx[h]);
      corr[h] = ex2((m[h] - mn) * kLog2e);
      ml2[h] = mn * kLog2e;
      m[h] = mn;
    }
#pragma unroll
    for (int j = 0; j < kRows / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        float p = ex2(fmaf(s[j][e], kLog2e, -ml2[h]));
        if (edge && s[j][e] <= 0.5f * attn::kNeg) p = 0.f;
        s[j][e] = p;
        rs[h] += p;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 1);
      rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 2);
      l[h] = l[h] * corr[h] + rs[h];
    }
#pragma unroll
    for (int j = 0; j < DC / 8; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      acc[j][2] *= corr[1];
      acc[j][3] *= corr[1];
    }
    uint32_t a[kRows / 16][4];
    pack_a(a, s);  // p.astype(v.dtype)
    wg_fence();
    wg_acc<DC>(acc, a, opaque(desc_mn(Vt, col0)));  // acc += p . v
    wg_commit();
    wg_wait<0>();
    keep(acc);
    keep(a);
    __syncthreads();  // every warp is done with stage st before refill
  }
  cp_async_wait<0>();  // no copy outlives the block

  float safe[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) safe[h] = l[h] > 0.f ? l[h] : 1.f;
  bf16* ob = o + bh * sq * d;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = qrow[h];
    if (r >= sq) continue;  // padding rows are never stored
    bf16* orow = ob + (long long)r * d;
#pragma unroll
    for (int j = 0; j < DC / 8; ++j) {
      const int c = col0 + 8 * j + 2 * t4;
      const float v0 = acc[j][2 * h] / safe[h];
      const float v1 = acc[j][2 * h + 1] / safe[h];
      if constexpr (VEC) {
        if (c < d)
          *reinterpret_cast<__nv_bfloat162*>(orow + c) =
              __floats2bfloat162_rn(v0, v1);
      } else {
        if (c < d) orow[c] = __float2bfloat16(v0);
        if (c + 1 < d) orow[c + 1] = __float2bfloat16(v1);
      }
    }
    if (t4 == 0 && col0 == 0) lse[bh * sq + r] = m[h] + logf(safe[h]);
  }
}

// The instance for (DP, VEC) at Sq: one warpgroup and 64 query rows a
// block for a sequence of at most 64 (DP <= 128), else two.
template <int DP, bool VEC>
int run_tc_dp(const attn_tc::bf16* q, const attn_tc::bf16* k,
              const attn_tc::bf16* v, attn_tc::bf16* o, float* lse,
              long long bh, int sq, int sk, int d, int causal, float scale,
              cudaStream_t stream) {
  if constexpr (DP <= 128) {
    if (sq <= attn_tc::kRows) {
      return attn_tc::launch<attn_fwd_tc<DP, VEC, 1>>(
          bh, 128, kSmemFwd<DP, 1>, stream, q, k, v, o, lse, 1, sq, sk, d,
          causal, scale);
    }
  }
  const int own = attn_tc::kRows * fwd_rowg<DP, 2>();
  const int nblk = (sq + own - 1) / own;
  return attn_tc::launch<attn_fwd_tc<DP, VEC, 2>>(
      bh * nblk, 256, kSmemFwd<DP, 2>, stream, q, k, v, o, lse, nblk, sq, sk,
      d, causal, scale);
}

int run_tc(const void* q, const void* k, const void* v, void* o, float* lse,
           long long bh, int sq, int sk, int d, int causal, float scale,
           cudaStream_t stream) {
  using attn_tc::bf16;
  const bool vec = attn_tc::vec_ok(d, {q, k, v, o});
  ATTN_TC_DISPATCH(
      d, vec,
      (run_tc_dp<DP, VEC>(static_cast<const bf16*>(q),
                          static_cast<const bf16*>(k),
                          static_cast<const bf16*>(v), static_cast<bf16*>(o),
                          lse, bh, sq, sk, d, causal, scale, stream)));
}

int plan_tc(int d, int sq, int* plan) {
  // the plan does not depend on the load path
  ATTN_TC_DISPATCH(
      d, true,
      (plan[0] = DP, (void)VEC,
       (DP <= 128 && sq <= attn_tc::kRows)
           ? (plan[1] = 128, plan[2] = (int)kSmemFwd<DP, 1>,
              plan[3] = attn_tc::kRows)
           : (plan[1] = 256, plan[2] = (int)kSmemFwd<DP, 2>,
              plan[3] = attn_tc::kRows * fwd_rowg<DP, 2>()),
       0));
}

}  // namespace

// Plain C entry point, bound with ctypes. dtype: 0 = float32 (CUDA
// cores), 1 = bfloat16 (tensor cores; the load path is picked from d and
// the pointers' alignment); bh = B * H; lse is (B, H, Sq) float32.
// Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() (0 = launched).
extern "C" int attn_fwd(const void* q, const void* k, const void* v,
                        void* o, void* lse, int dtype, long long bh, int sq,
                        int sk, int d, int causal, float scale,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lf = static_cast<float*>(lse);
  if (dtype == 0)
    return run<float>(q, k, v, o, lf, bh, sq, sk, d, causal, scale, s);
  if (dtype == 1)
    return run_tc(q, k, v, o, lf, bh, sq, sk, d, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}

// The bfloat16 instance's tile plan for head_dim d and Sq query rows:
// plan[0..3] = DP, threads per block, dynamic shared memory bytes, query
// rows a block. Returns 0, or cudaErrorInvalidValue for d > 256.
extern "C" int attn_fwd_plan(int d, int sq, int* plan) {
  return plan_tc(d, sq, plan);
}
