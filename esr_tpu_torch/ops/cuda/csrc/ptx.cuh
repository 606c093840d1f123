// sm_80+ PTX pieces (run here on sm_90a): ldmatrix to load the bf16 kernels'
// wgmma A fragments (the mma.sync m16n8k16 A layout) from shared memory, bf16
// packing, and cp.async, the f32 kernel's asynchronous copies from global to
// shared memory.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace esr {

// Four 8x8 b16 matrices; lane l gives the shared-memory address of row l % 8
// of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t saddr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(saddr));
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem_row) {
  ldmatrix_x4(r, static_cast<uint32_t>(__cvta_generic_to_shared(smem_row)));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 4 bytes from global src to shared dst, asynchronously; src_bytes 0 writes
// zeros and reads nothing (src must still be a valid address).
__device__ __forceinline__ void cp_async4_zfill(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 8 bytes from global src to shared dst (both 8-byte aligned),
// asynchronously; src_bytes 0 writes zeros and reads nothing (src must still
// be a valid address).
__device__ __forceinline__ void cp_async8_zfill(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 16 bytes (both addresses 16-byte aligned), asynchronously, through L2 only.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// Close this thread's group of cp.async copies issued since the last commit.
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Wait until at most N of this thread's committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace esr
