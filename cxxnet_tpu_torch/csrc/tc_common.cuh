// Hopper (sm_90a) primitives shared by the tensor-core kernels of
// csrc/: asynchronous global -> shared copies (cp.async), warpgroup
// matrix products (wgmma) and their shared-memory descriptors in the
// 128-byte swizzle, and the launch helper. Used by attn_tc.cuh (the
// bfloat16 flash-attention kernels K2-fwd, K2-dq, K2-dkv) and int8_mm.cu
// (K3).
//
// The 128-byte swizzle: a tile is stored as rows of 128 bytes, 16-byte
// piece p of row r at piece p ^ (r % 8); 8 rows form a 1,024-byte atom,
// and a tile starts on a 1,024-byte boundary. A K-major operand is read
// 32 bytes of each row a k-step (16 bf16 or 32 int8 values), 8-row groups
// 1,024 bytes apart.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The dynamic shared memory base rounded up to 1,024 bytes.
__device__ __forceinline__ unsigned char* align_smem(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + ((1024 - (a & 1023)) & 1023);
}

// 16 bytes global -> shared, asynchronous; zero-filled when !valid (no
// byte of src is read then).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, asynchronous; zero-filled when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Make this thread's shared-memory writes (stores, cp.async) visible to
// the tensor cores' asynchronous proxy; a barrier follows.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Registers an asynchronous wgmma reads or writes: pinned so that the
// compiler neither reuses them nor reads them before wg_wait returns.
template <int R>
__device__ __forceinline__ void keep(float (&x)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(x[i][e])::"memory");
}
template <int R>
__device__ __forceinline__ void keep(uint32_t (&x)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(x[i][e])::"memory");
}

template <int R>
__device__ __forceinline__ void keep(int (&x)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(x[i][e])::"memory");
}

// A shared-memory matrix descriptor with the 128-byte swizzle: start
// address, leading and stride byte offsets (16-byte units).
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         (1ull << 62);
}

// Launch `kernel` on `blocks` blocks of `threads` with `smem` bytes of
// dynamic shared memory, raising the instance's limit at its first
// launch. Returns cudaGetLastError() (0 = launched).
template <auto kernel, typename... Args>
int launch(long long blocks, int threads, size_t smem, cudaStream_t stream,
           Args... args) {
  if (blocks <= 0) return (int)cudaGetLastError();
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  kernel<<<(unsigned int)blocks, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace tc
