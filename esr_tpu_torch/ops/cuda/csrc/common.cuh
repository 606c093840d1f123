// Pieces shared by the hand-written convolution kernels (rdb5c.cuh,
// conv3x3.cuh, conv_f32.cuh). All are implicit-GEMM convolutions over a
// feature window kept in shared memory, accumulating in f32:
//  - bf16 (the main path): tensor cores, wgmma (hopper.cuh), windows in the
//    swizzled layout of the second half of this file;
//  - the bf16 SIMT RDB (rdb5c_kernel, the widths the tensor-core one does not
//    take): FMAs over a planar [channel][row][col] window, so that the 32
//    lanes of a warp, which own 32 neighbouring output pixels, read 32
//    neighbouring addresses. Weights are [tap][cin][cout]; all lanes of a warp
//    own the same kCO output channels, so a weight load is one 16-byte
//    broadcast;
//  - f32 (conv_f32.cuh): FMAs on the FP32 units, windows and weights staged by
//    cp.async.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "ptx.cuh"

namespace esr {

constexpr int kThreads = 256;  // threads per block
// SIMT RDB: each thread owns kPX output pixels (32 apart) x kCO channels
constexpr int kPX = 4;
constexpr int kCO = 8;
constexpr int kPixBlock = 32 * kPX;

// kCO consecutive bf16 weights (16-byte aligned) -> f32 registers.
__device__ __forceinline__ void load_w(const __nv_bfloat16* p, float (&w)[kCO]) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // a bf16 is the high half of an f32
    w[2 * i] = __uint_as_float(u[i] << 16);
    w[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ float lrelu(float v) { return v >= 0.f ? v : 0.2f * v; }

// acc[p][c] += sum over ty < kh, tx < kw, ci < cin of
//   feat[ci * plane + base[p] + ty * row + tx] * w[(ty * kw + tx) * w_tap + ci * w_ci + c]
// feat: planar shared-memory window; base[p]: the window offset of pixel p's
// first tap; w: already offset to this thread's first output channel.
__device__ __forceinline__ void accumulate(float (&acc)[kPX][kCO], const __nv_bfloat16* feat,
                                           int plane, int row, const int (&base)[kPX], int cin,
                                           int kh, int kw, const __nv_bfloat16* __restrict__ w,
                                           int w_tap, int w_ci) {
  for (int ty = 0; ty < kh; ++ty) {
    for (int tx = 0; tx < kw; ++tx) {
      const __nv_bfloat16* f = feat + ty * row + tx;
      const __nv_bfloat16* wt = w + (ty * kw + tx) * w_tap;
#pragma unroll 4
      for (int ci = 0; ci < cin; ++ci) {
        float fv[kPX];
#pragma unroll
        for (int p = 0; p < kPX; ++p) fv[p] = __bfloat162float(f[ci * plane + base[p]]);
        float wv[kCO];
        load_w(wt + ci * w_ci, wv);
#pragma unroll
        for (int p = 0; p < kPX; ++p) {
#pragma unroll
          for (int c = 0; c < kCO; ++c) acc[p][c] = fmaf(fv[p], wv[c], acc[p][c]);
        }
      }
    }
  }
}

// Copy the NHWC image window with top-left corner (gy0, gx0) and size wh x ww
// into planar shared memory, zero outside the image.
__device__ __forceinline__ void load_window(__nv_bfloat16* dst,
                                            const __nv_bfloat16* __restrict__ img, int n, int h,
                                            int w, int c, int gy0, int gx0, int wh, int ww) {
  const int npx = wh * ww;
  for (int i = threadIdx.x; i < npx * c; i += blockDim.x) {
    const int ch = i % c, p = i / c;
    const int gy = gy0 + p / ww, gx = gx0 + p % ww;
    __nv_bfloat16 v = __float2bfloat16(0.f);
    if (gy >= 0 && gy < h && gx >= 0 && gx < w) v = img[(((size_t)n * h + gy) * w + gx) * c + ch];
    dst[ch * npx + p] = v;
  }
}

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
