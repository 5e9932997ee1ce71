// The channel slab shared by K1-fwd (lrn_fwd.cu) and K1-bwd (lrn_bwd.cu).
//
// A block of either kernel takes one image b, one chunk of channels
// [c0, c1) and one segment [s0, s1) of the flattened H*W axis. The rows
// of its channel range (the chunk and its halo) x positions [s0, s1)
// are copied into shared memory, the block computes from there, and
// the results go back through shared memory. Two layouts:
//
// - whole (the segment is all of H*W, as at AlexNet's and GoogLeNet's
//   shapes): in NCHW the slab is ONE contiguous range of the tensor.
//   It is rounded outward to the 16-byte-aligned pieces that cover it,
//   each copied with one 16-byte cp.async; only a piece that sticks out
//   of the tensor itself (at its first or last element) is copied
//   element by element, its bytes inside the range alone, so nothing
//   outside the tensor is read. Shared memory keeps the pieces'
//   alignment: the slab starts (global address mod 16) bytes into its
//   region. A channel row of 729 or 169 bfloat16 values is never
//   16-byte aligned, yet every piece is a 16-byte copy.
// - rows (H*W too large for a row and its halo to fit): each channel
//   row's segment is one range, copied as above into its own row of
//   the region (row_stride()).
//
// Offsets inside a slab are 32-bit (a slab is at most 227 KB); the
// offset of a block's image, channel and segment in the tensor is
// 64-bit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tc_common.cuh"

namespace lrn {

// a block's dynamic shared memory limit on sm_90
constexpr int kMaxSmem = 232448;
// the window of AlexNet's and GoogLeNet's LRN layers: the one n with
// an instance that knows it at compile time (register rings); every
// other n takes the generic instance
constexpr int kRingN = 5;
// the plan (ops/lrn.py:lrn_plan) asks for at most this many threads
constexpr int kMaxThreads = 256;

// The raw storage of one element, for copies that do not convert.
template <int S>
struct Raw;
template <>
struct Raw<2> {
  using type = unsigned short;
};
template <>
struct Raw<4> {
  using type = unsigned int;
};

// norm^e in float32, e uniform across the launch. bfloat16 instances
// take exp2(e * log2|norm|) on the fast intrinsics, without a branch:
// __log2f (absolute error 2^-22 near 1, denormal norms handled) and
// ex2.approx.ftz (2 ulp; a power below 2^-126 flushes to 0, which needs
// norm > 2^(126/beta): beyond float32 for beta < 0.99) - about 4e-7 of
// the result at |e| <= 1, far inside one bfloat16 ulp. The special
// cases follow torch.pow: e = 0 gives 1; a negative base gives NaN, or
// +-|norm|^e for an integer e; 0 and inf follow from log2. float32
// instances keep powf: with the intrinsics, K1-bwd's float32 bar (1e-6
// of the two terms of a gradient that is their difference) failed at a
// few of the 18 M elements of an AlexNet b256 input.
struct Power {
  float e;
  float neg;  // what a negative base's |norm|^e is multiplied by
};

__device__ __forceinline__ Power power(float e) {
  Power w;
  w.e = e;
  w.neg = __int_as_float(0x7fffffff);  // NaN: a non-integer power
  if (e == truncf(e)) w.neg = fmodf(fabsf(e), 2.f) == 1.f ? -1.f : 1.f;
  return w;
}

__device__ __forceinline__ float ex2_ftz(float t) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(t));
  return r;
}

__device__ __forceinline__ float rcp_ftz(float v) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

template <typename T>
__device__ __forceinline__ float pow_f(float norm, const Power& w) {
  if constexpr (sizeof(T) == 2) {
    const float t = w.e == 0.f ? 0.f : w.e * __log2f(fabsf(norm));
    const float r = ex2_ftz(t);
    return norm < 0.f ? r * w.neg : r;
  } else {
    return powf(norm, w.e);
  }
}

// norm^(-beta-1) given pw = norm^(-beta): in bfloat16 pw / norm (one
// power an element; rcp.approx.ftz, 1 ulp - a norm below 2^-126, which
// needs knorm below it, counts as 0). float32 takes a second powf, as
// the plain version does: K1-bwd's reversed-window sum of u cancels,
// and its float32 bar held only with u rounded as the plain version
// rounds it.
template <typename T>
__device__ __forceinline__ float pow_m1(float norm, float pw,
                                        const Power& w) {
  if constexpr (sizeof(T) == 2) return pw * rcp_ftz(norm);
  return powf(norm, w.e - 1.f);
}

__host__ __device__ inline long long align16(long long v) {
  return (v + 15) & ~15LL;
}

// Bytes from one channel row of a slab to the next in shared memory: a
// whole-layout slab is the tensor's own range (hw * size); a row-by-row
// one takes room for a segment's 16-byte pieces (at most seg * size +
// 30 bytes) and keeps the tensor's row step mod 16, so that every row
// sits at its global alignment and a row's offset is affine in its
// channel.
__host__ __device__ inline long long row_stride(long long hw, int seg,
                                                int size) {
  if (seg == hw) return hw * size;
  return align16((long long)seg * size + 30) + ((hw * size) & 15);
}

// Bytes of the region that holds `rows` channel rows of a slab: they
// start up to 16 - size bytes past a 16-byte boundary.
__host__ __device__ inline long long region_bytes(long long rows,
                                                  long long hw, int seg,
                                                  int size) {
  if (seg == hw) return align16(rows * hw * size + 16 - size);
  return align16(rows * row_stride(hw, seg, size));
}

// What a block reads: image b, channels [c0, c1), positions [s0, s1).
struct Block {
  int b, c0, c1, len;  // len = s1 - s0
  long long s0;
};

// blockIdx.x -> (image, chunk, segment), segments fastest; 32-bit
// divisions (the grid has fewer than 2^31 blocks): a 64-bit one is a
// called subroutine
__device__ __forceinline__ Block block_of(int channels, long long hw,
                                          int chunk, int seg, int nsegs) {
  const unsigned nchunks = (channels + chunk - 1) / chunk;
  unsigned id = blockIdx.x;
  Block k;
  const unsigned si = id % (unsigned)nsegs;
  id /= (unsigned)nsegs;
  k.c0 = (int)(id % nchunks) * chunk;
  k.b = (int)(id / nchunks);
  k.c1 = min(k.c0 + chunk, channels);
  k.s0 = (long long)si * seg;
  k.len = (int)min((long long)seg, hw - k.s0);
  return k;
}

// Channel rows from j0 of one image, positions [s0, s0 + len), in the
// region at `base`: row j at byte lead + (j - j0) * stride.
template <typename T>
struct Slab {
  unsigned char* base;
  int j0;
  int lead;    // the global address of (j0, s0) mod 16
  int stride;  // row_stride(): bytes from a row to the next
  int whole;   // seg == hw: the rows are one range

  __device__ __forceinline__ int row(int j) const {
    return lead + (j - j0) * stride;
  }
  __device__ __forceinline__ T* at(int j, int p) const {
    return reinterpret_cast<T*>(base + row(j)) + p;
  }
  // elements from a row to the next
  __device__ __forceinline__ int step() const {
    return stride / (int)sizeof(T);
  }
};

template <typename T>
__device__ __forceinline__ Slab<T> make_slab(unsigned char* base,
                                             const T* image, int j0,
                                             long long hw, int seg,
                                             long long s0) {
  Slab<T> s;
  s.base = base;
  s.j0 = j0;
  s.lead = (int)(reinterpret_cast<uintptr_t>(image + (long long)j0 * hw +
                                             s0) & 15);
  s.stride = (int)row_stride(hw, seg, sizeof(T));
  s.whole = seg == hw;
  return s;
}

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch casts
}

// Copy the elements [gs, ge) of a tensor that spans [lo, hi) into
// shared memory at `dst`, which stands for the 16-byte-aligned address
// at or below gs: the range rounded outward to 16-byte pieces, each one
// 16-byte cp.async, clipped at the tensor's ends - a piece that sticks
// out of the tensor is copied element by element, its bytes inside
// [gs, ge) only. All threads of the block take part.
template <typename T>
__device__ __forceinline__ void load_range(unsigned char* dst, const T* gs,
                                           const T* ge, const T* lo,
                                           const T* hi) {
  using R = typename Raw<sizeof(T)>::type;
  const uintptr_t s = reinterpret_cast<uintptr_t>(gs);
  const uintptr_t e = reinterpret_cast<uintptr_t>(ge);
  const uintptr_t tlo = reinterpret_cast<uintptr_t>(lo);
  const uintptr_t thi = reinterpret_cast<uintptr_t>(hi);
  const uintptr_t a = s & ~uintptr_t(15);
  const int nbytes = (int)(((e + 15) & ~uintptr_t(15)) - a);
  for (int i = threadIdx.x * 16; i < nbytes; i += blockDim.x * 16) {
    const uintptr_t src = a + i;
    if (src >= tlo && src + 16 <= thi) {
      tc::cp_async16(dst + i, reinterpret_cast<const void*>(src), true);
    } else {
      for (int q = 0; q < 16; q += (int)sizeof(T))
        if (src + q >= s && src + q < e)
          *reinterpret_cast<R*>(dst + i + q) =
              *reinterpret_cast<const R*>(src + q);
    }
  }
}

// Copy rows [s.j0, j1) x positions [s0, s0 + len) of `image` (in a
// tensor spanning [lo, hi)) into slab s: one range in the whole layout,
// else row by row.
template <typename T>
__device__ __forceinline__ void load_slab(const Slab<T>& s, const T* image,
                                          int j1, long long hw,
                                          long long s0, int len,
                                          const T* lo, const T* hi) {
  const T* first = image + (long long)s.j0 * hw + s0;
  if (s.whole) {
    load_range(s.base, first, image + (long long)j1 * hw, lo, hi);
    return;
  }
  for (int j = s.j0; j < j1; ++j) {
    const T* r = first + (long long)(j - s.j0) * hw;
    load_range(s.base + (s.row(j) & ~15), r, r + len, lo, hi);
  }
}

// Write the elements [gs, ge) of the output from shared memory, where
// `src` holds the element *gs: every full 16-byte-aligned piece of the
// output with one 16-byte store (gathered from shared memory element by
// element when the two sides' alignments differ), the ragged first and
// last piece element by element.
template <typename T>
__device__ __forceinline__ void store_range(T* gs, T* ge,
                                            const unsigned char* src) {
  using R = typename Raw<sizeof(T)>::type;
  constexpr int kPer = 16 / (int)sizeof(T);
  const uintptr_t s = reinterpret_cast<uintptr_t>(gs);
  const uintptr_t e = reinterpret_cast<uintptr_t>(ge);
  const uintptr_t a = s & ~uintptr_t(15);
  const int nbytes = (int)(((e + 15) & ~uintptr_t(15)) - a);
  const unsigned char* sa = src - (s - a);  // stands for address a
  const bool vec = (reinterpret_cast<uintptr_t>(sa) & 15) == 0;
  for (int i = threadIdx.x * 16; i < nbytes; i += blockDim.x * 16) {
    const uintptr_t dst = a + i;
    if (dst >= s && dst + 16 <= e) {
      union {
        uint4 v;
        R e[kPer];
      } u;
      if (vec) {
        u.v = *reinterpret_cast<const uint4*>(sa + i);
      } else {
#pragma unroll
        for (int q = 0; q < kPer; ++q)
          u.e[q] = reinterpret_cast<const R*>(sa + i)[q];
      }
      *reinterpret_cast<uint4*>(dst) = u.v;
    } else {
      for (int q = 0; q < 16; q += (int)sizeof(T))
        if (dst + q >= s && dst + q < e)
          *reinterpret_cast<R*>(dst + q) =
              *reinterpret_cast<const R*>(sa + i + q);
    }
  }
}

// Write channels [c0, c1) x positions [s0, s0 + len) of slab s to
// `image` (the output's image).
template <typename T>
__device__ __forceinline__ void store_slab(const Slab<T>& s, T* image,
                                           int c0, int c1, long long hw,
                                           long long s0, int len) {
  if (s.whole) {
    store_range(image + (long long)c0 * hw, image + (long long)c1 * hw,
                s.base + s.row(c0));
    return;
  }
  for (int c = c0; c < c1; ++c) {
    T* r = image + (long long)c * hw + s0;
    store_range(r, r + len, s.base + s.row(c));
  }
}

// Make the cp.async copies and the element copies of every thread
// visible to the block.
__device__ __forceinline__ void slab_ready() {
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();
}

// Check a slab plan the wrapper passes (ops/lrn.py:lrn_plan) against
// the shared memory its slab needs; 0 when it can launch, with one
// block a unit of work.
inline int check_plan(int channels, long long hw, int chunk, int seg,
                      int threads, long long need, int smem_bytes,
                      long long batch, long long* blocks) {
  if (chunk < 1 || seg < 1 || seg > hw || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0 || smem_bytes < need ||
      smem_bytes > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  *blocks = batch * ((channels + chunk - 1) / chunk) * ((hw + seg - 1) / seg);
  if (*blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  return 0;
}

// The grid of a plan with seg = 0, where even one channel at one
// position of a slab does not fit shared memory (a window over
// thousands of channels): no slab, every value read from device memory
// (the direct instances). Columns (image, position) over x, chunks of
// channels over y; 0 when it can launch.
inline int check_direct(long long batch, int channels, long long hw,
                        int chunk, int threads, int smem_bytes,
                        dim3* grid) {
  const long long cols = batch * hw;
  const long long chunks = (channels + (long long)chunk - 1) / chunk;
  if (chunk < 1 || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0 || smem_bytes != 0 || chunks > 65535 ||
      (cols + threads - 1) / threads > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  *grid = dim3((unsigned)((cols + threads - 1) / threads), (unsigned)chunks);
  return 0;
}

}  // namespace lrn
