// Pieces shared by the hand-written convolution kernels (rdb5c.cuh,
// conv3x3.cuh, conv_f32.cuh). All are implicit-GEMM convolutions over a
// feature window kept in shared memory, accumulating in f32:
//  - bf16: tensor cores, wgmma (hopper.cuh), windows in the swizzled layout
//    of the second half of this file;
//  - f32 (conv_f32.cuh): FMAs on the FP32 units, windows and weights staged by
//    cp.async.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "ptx.cuh"

namespace esr {

constexpr int kThreads = 256;  // threads per block

__device__ __forceinline__ float lrelu(float v) { return v >= 0.f ? v : 0.2f * v; }

// ---------------------------------------------------------------------------
// The bf16 tensor-core path. Feature windows live in shared memory pixel-major
// (HWC, channels contiguous) in 16-byte chunks of 8 channels; chunk q of pixel
// p is stored at chunk swz(p, q) so that the 8 rows an ldmatrix reads (8
// neighbouring pixels, same chunk) fall into the 8 different 16-byte bank
// groups. An output pixel's A row for tap (ty, tx) is simply the window pixel
// shifted by ty * row + tx, so the implicit GEMM needs no im2col copy.
// ---------------------------------------------------------------------------

// Element offset of channel chunk q of pixel p, ch = 16-byte chunks per pixel
// (2, 4 or a multiple of 8). For ch = 8 it is TMA's 128-byte swizzle of a
// 1024-byte aligned buffer (hopper.cuh).
__device__ __forceinline__ int swz(int p, int q, int ch) {
  const int s = ch >= 8 ? (p & 7) : ((p * ch) >> 3) & (ch - 1);
  return (p * ch + (q ^ s)) * 8;
}

}  // namespace esr
