// Warp-level instructions used by the bf16 kernels (sm_80+ PTX, run here on
// sm_90a): ldmatrix to load wgmma A fragments (the mma.sync m16n8k16 A
// layout) from shared memory, and bf16 packing.
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

}  // namespace esr
