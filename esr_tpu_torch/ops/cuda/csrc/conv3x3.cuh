// SAME 3x3 convolution (and the 2x2 parity convs of a fused nearest-2x
// upsample + 3x3 conv) as an implicit GEMM, with a bias + LeakyReLU epilogue.
//
// Replaces: esr_tpu/ops/pallas/kpack_conv.py:kpack_conv3x3 (SAME 3x3 conv,
// NHWC x HWIO, one K = 9 * Cin contraction, f32 accumulation). The 2x2 mode
// runs the four parity convs of esr_tpu/ops/fused.py:upsample2x_conv3x3 in one
// launch and writes each parity straight into its interleaved place in the
// (n, 2h, 2w, cout) output, so the upsampled input never exists.
//
//   3x3:  out[n, i, j, o]           = b[o] + sum_{ty,tx,c} x[n, i+ty-1, j+tx-1, c] w[ty*3+tx, c, o]
//   2x2:  out[n, 2i+a, 2j+b', o]    = b[o] + sum_{ty,tx,c} x[n, i+ty-1+a, j+tx-1+b', c] w[q, ty*2+tx, c, o]
//         with parity q = 2a + b' and zero outside the image; optional lrelu_0.2
//         (lrelu_0.01 as well where Cin is above 128).
//
// What bounds it, by width: a conv does 2 * 9 * Cin FLOP per output channel
// and pixel (2 * 4 * Cin per parity in the 2x2 mode) against 2 * (Cin + Cout)
// bytes per pixel in bf16. At Cin 64 -> Cout 64 (the flagship's trunk, HR and
// upsample convs) that is ~290 FLOP per byte, the card's balance point;
// conv_first (Cin 4) and conv_last (Cout 3) are bound by bytes; 64 -> 256
// (SRResNet's upconvs, pixel-shuffled after) and 128 -> 128 do 460 and 580
// FLOP per byte, bound by the tensor cores; so are SwinIR's 180 -> 180 (~900).
//
// This file holds the bf16 kernel, conv_tc_kernel (design below), on the
// Hopper tensor cores: every bf16 conv with Cin up to 128 and Cout up to 1024,
// and 3x3 convs with Cin 129 to 192 and Cout a multiple of 64.
// The f32 convs run conv_f32_kernel (conv_f32.cuh), on the FP32 units.
#pragma once

#include "common.cuh"
#include "gelu.cuh"
#include "hopper.cuh"

namespace esr {

constexpr int kTile = 16;

// Output pixel of tile pixel (gy, gx): its own place, or its interleaved place
// (2 gy + a, 2 gx + b) of parity q = 2a + b in the 2x2 mode.
__device__ __forceinline__ size_t conv_out_pixel(int n, int h, int w, int gy, int gx, bool up,
                                                 int pa, int pb) {
  return up ? ((size_t)n * 2 * h + 2 * gy + pa) * (2 * w) + 2 * gx + pb
            : ((size_t)n * h + gy) * w + gx;
}

// ---------------------------------------------------------------------------
// The bf16 kernel, conv_tc_kernel: Hopper tensor cores, persistent, one
// producer warp and two consumer warpgroups.
//
// - Weights resident in shared memory: each block copies the weights it needs
//   once (bulk async copies on an mbarrier): per K chunk, parity and tap, one
//   64-row Cout slice (or Cout <= 8: 8 rows) of 64 K values, 128B-swizzled
//   (hopper.cuh), the K-major wgmma operand; conv_kernel_weights builds the
//   image with each block's bytes contiguous. No k-loop reads global memory.
// - Persistent blocks walk the 16 x 16 tiles (t, t + grid, ...). The producer
//   warp brings each tile's 18 x 18 x 64 input window (one 64-channel K
//   chunk) into a ring of window stages, a stage once the 8 consumer warps
//   have released it (mbarriers): by one TMA box load
//   (CU_TENSOR_MAP_SWIZZLE_128B, which is swz(p, q, 8)), whose zero fill
//   outside the tensor is the SAME padding and the ragged edges; or, for an
//   input whose Cin is not a multiple of 64 (conv_first's 4: an 8-byte pixel
//   stride, which TMA cannot take), by plain loads of the chunk's channels.
// - Cout a multiple of 64: out^T = W^T x^T. wgmma m64n144k16 with both
//   operands in shared memory: A = the tap's weights (64 output channels x
//   K), B = 144 consecutive window pixels shifted by the tap. A window row is
//   18 pixels, so a warpgroup computes 8 rows x 18 "virtual" pixels and drops
//   columns 16 and 17 (12.5% more MMA work); in exchange the pixels form one
//   evenly strided operand that one descriptor addresses (at any 128-byte
//   row: see wgmma_desc_sw128), and no A fragment passes through registers.
//   The epilogue transposes the accumulators into pixels with stmatrix.trans
//   and stores each warpgroup's 8 x 16 pixels x 64 channels with one TMA
//   store, which also clips the ragged edges.
// - Cout <= 8 (conv_last's 3, a 6-byte pixel stride): pixels as M, wgmma
//   m64n8k16 with A from registers (ldmatrix from the window shifted by the
//   tap: per warp the mma.sync A fragment) and B from the weights; masked
//   stores.
// - 2x2 mode: a block takes the two parities (a, 0) and (a, 1) of its tiles,
//   so their weights fit beside the ring (64 KB per slice and K chunk); one
//   window serves both (a parity moves the tap origin by (a, b)).
//
// Wider convs, and what bounds them in shared memory (232,448 bytes a block):
// - Cout above 64: S = Cout_pad / 64 slices of 64 output channels. Block b
//   takes slice b % S (2x2 mode: parity row and slice from b % 2S) and the
//   tiles b / S, b / S + grid / S, ...; its TMA stores write at channel 64 j
//   of a tensor map whose channel dimension is Cout_pad. The S blocks of one
//   tile run side by side, so its window comes from L2 once HBM has sent it:
//   at SRResNet's upconv2 (B16 x 256^2 x 64 in, 134 MB) the input does not
//   fit the 50 MB L2, and S = 4 reads from HBM would add 0.4 GB. A slice's
//   budget is the 64 -> 64 kernel's: 73,728 bytes of 3x3 weights, 2 window
//   stages, 33 KB of staging: 191,784 bytes.
// - Cin above 64: K chunks of 64 channels, KC = 2 up to Cin 128, each with
//   its own window and weight sub-image, accumulated in the same registers.
//   A 3x3 slice then holds 147,456 bytes of weights and one window stage
//   fits beside them, not two (223,528 bytes; 2x2: 131,072 and 207,144).
//   So a KC = 2 kernel with one stage loads a chunk while nothing computes:
//   its two warpgroups issue each chunk together (no turns) and release it,
//   and the 2x2 mode loads a tile's chunks once per parity.
// - Cin 129 to 192 (SwinIR's 180-channel convs; 3x3, Cout a multiple of 64):
//   three chunks of 3x3 weights alone would take 221,184 bytes, so they are
//   streamed, not held: a ring of two weight slots of one chunk (73,728
//   bytes each) beside one window stage (223,560 bytes in all). The producer
//   sends chunk c's weights (one bulk copy into slot w % 2 for the w-th
//   window) ahead of its window, so a slot fills while the other's chunk
//   computes; the consumers release a slot with its window. The weights
//   come from L2 (every block of a slice reads the same 221 KB). A Cin that
//   is not a multiple of 64 (180: a 360-byte pixel stride, which TMA cannot
//   take) loads its windows with 8-byte cp.async copies that zero-fill
//   outside the image and beyond Cin (Cin a multiple of 4). These instances
//   also take lrelu_0.01 (act 2: SwinIR's conv_before_upsample), which the
//   others do not, so that their code stays as it was; and, as
//   conv_tc_kernel_gelu<64, 4, false, 3, false>, GELU with erf (act 3: HAT's
//   CAB conv 180 -> 60, its Cout padded to 64), a kernel of its own for the
//   same reason.
// Slices, K chunks and the stage count are template parameters: the 64 -> 64
// instances (S = 1, one chunk, two stages) are the kernel without them.
// ---------------------------------------------------------------------------

constexpr int kWin = kTile + 2;                                    // window edge: 18
constexpr uint32_t kWinBytes = kWin * kWin * 128;                  // 64 bf16 per pixel
constexpr uint32_t kWinStride = (kWinBytes + 1023) / 1024 * 1024;  // stages 1024-aligned
constexpr int kVirt = kTile / 2 * kWin;    // Cout 64: virtual pixels per warpgroup, 144
constexpr uint32_t kOutStg = kTile / 2 * kTile * 128;  // Cout 64: a warpgroup's 8 x 16 pixels
constexpr int kStgPix = 8;                 // Cout <= 8: pixels per warp and store pass
constexpr int kTcThreads = kThreads + 32;  // two consumer warpgroups + one producer warp
constexpr uint32_t kSmemMax = 232448;      // dynamic shared memory a block can use
constexpr int kTcMaxChunks = 3;            // Cin up to 192
constexpr int kTcResidentChunks = 2;       // above this, the weights are streamed
constexpr int kTcMaxSlices = 16;           // Cout up to 1024

struct ConvTcArgs {
  const __nv_bfloat16* x;   // (n, h, w, cin) NHWC
  const __nv_bfloat16* wt;  // weight image [parity row][slice][K chunk][parity][tap][64 or 8][64]
  const float* bias;        // [cout] or nullptr
  __nv_bfloat16* out;       // (n, h, w, cout), or (n, 2h, 2w, cout) in 2x2 mode
  int n, h, w, cin, cout, act;
  int slices;   // Cout / 64 (Cout a multiple of 64), else 1
  int use_tma;  // cin a multiple of 64: windows by TMA; otherwise plain loads
  int tiles_x, tiles_y, n_tiles;
};

// Shared memory of conv_tc_kernel<N, *, UP, KC, *>: 1024 bytes of alignment
// slack, the block's weights (N = 64: one slice; KC = 3: a ring of two
// chunks), the window stages (two where they fit, else one), the epilogue
// staging (N = 64: two 8 x 16-pixel tiles and a 128-byte dump row each; N =
// 8: 8 pixels per warp), five mbarriers (KC = 3: nine).
__host__ __device__ constexpr bool conv_tc_streams(int kc) { return kc > kTcResidentChunks; }
__host__ __device__ constexpr uint32_t conv_tc_chunk_wbytes(int n_pad, bool up) {
  return (up ? 2 * 4 : 9) * n_pad * 128;
}
__host__ __device__ constexpr uint32_t conv_tc_wbytes(int n_pad, bool up, int kc) {
  return (conv_tc_streams(kc) ? 2 : kc) * conv_tc_chunk_wbytes(n_pad, up);
}
__host__ __device__ constexpr uint32_t conv_tc_stg_bytes(int n_pad) {
  return n_pad == 64 ? 2 * (kOutStg + 128) : (kThreads / 32) * kStgPix * n_pad * 2;
}
__host__ __device__ constexpr uint32_t conv_tc_smem_with(int n_pad, bool up, int kc, int stages) {
  return 1024 + conv_tc_wbytes(n_pad, up, kc) + stages * kWinStride + conv_tc_stg_bytes(n_pad) +
         (conv_tc_streams(kc) ? 9 : 5) * 8;
}
__host__ __device__ constexpr int conv_tc_stages(int n_pad, bool up, int kc) {
  return conv_tc_smem_with(n_pad, up, kc, 2) <= kSmemMax ? 2 : 1;
}
// K chunks of a Cin
__host__ __device__ constexpr int conv_tc_kchunks(int cin) { return cin <= 64 ? 1 : (cin + 63) / 64; }
inline size_t conv_tc_smem_bytes(int n_pad, int ksize, int kc) {
  return conv_tc_smem_with(n_pad, ksize == 2, kc, conv_tc_stages(n_pad, ksize == 2, kc));
}

// ---- Cout 64: pixels as N ----------------------------------------------------

// Issue (no wait) acc = W^T x^T (acc += when acc_in) of this warpgroup's 144
// virtual pixels (first at window pixel v0) for parity (pa, pb): taps (ty,
// tx) < KH, KS K steps; the parity's tap weights start at w_s.
template <int KS, int KH>
__device__ __forceinline__ void conv_tn_issue(float (&acc)[kVirt / 2], uint32_t win_s, uint32_t w_s,
                                              int v0, int pa, int pb, bool acc_in) {
  wgmma_fence();
#pragma unroll
  for (int tap = 0; tap < KH * KH; ++tap) {
    const uint32_t b_s = win_s + (v0 + (tap / KH + pa) * kWin + tap % KH + pb) * 128;
#pragma unroll
    for (int kb = 0; kb < KS; ++kb)
      WgmmaSS<kVirt>::mma(acc, wgmma_desc_sw128(w_s + tap * 64 * 128 + kb * 32),
                          wgmma_desc_sw128(b_s + kb * 32), acc_in || tap + kb > 0);
  }
  wgmma_commit();
}

// Bias, lrelu (of slope `slope`) and bf16 of the warpgroup's 144 virtual
// pixels into its staging tile stg_s (8 rows x 16 pixels x 128 bytes, 16-byte
// chunks swizzled by pixel as TMA reads them): the warp holds output channels
// 16 (warp % 4) .. + 15 of every pixel, and stmatrix.trans writes them as
// pixel rows. Columns 16 and 17 go to the dump row dump_s.
__device__ __forceinline__ void conv_tn_stage(const float (&acc)[kVirt / 2], const float (&bv)[2],
                                              bool act, float slope, uint32_t stg_s, uint32_t dump_s) {
  const int lane = threadIdx.x & 31, w4 = (threadIdx.x >> 5) & 3;
  const int m = lane >> 3;  // this lane addresses row lane % 8 of matrix m
#pragma unroll
  for (int jj = 0; jj < kVirt / 8; jj += 2) {
    uint32_t r[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // matrix i: pixels 8 (jj + i / 2) .., channel half i % 2
      const int j = jj + i / 2, hh = i % 2;
      float v0 = acc[4 * j + 2 * hh] + bv[hh], v1 = acc[4 * j + 2 * hh + 1] + bv[hh];
      if (act) {
        v0 = lrelu(v0, slope);
        v1 = lrelu(v1, slope);
      }
      r[i] = pack_bf16x2(v0, v1);
    }
    const int v = 8 * (jj + m / 2) + (lane & 7), row = v / kWin, col = v - row * kWin;
    const int slot = row * kTile + col, chunk = 2 * w4 + m % 2;
    stmatrix_x4_trans(col < kTile ? stg_s + slot * 128 + ((chunk ^ (slot & 7)) << 4)
                                  : dump_s + (chunk << 4),
                      r[0], r[1], r[2], r[3]);
  }
}

// GELU with erf, in place, of a warpgroup's staged 8 x 16 pixels x 64
// channels (bf16, the bias already added): each of its 128 threads takes 8
// of the tile's 16-byte chunks, in f32. Applied to the staged tile and not
// to the accumulators, whose 72 registers a thread leave no room for GELU's
// chains beside them under the kernel's 168-register budget (ptxas spilled
// 172 bytes when it ran in conv_tn_stage); the value is rounded to bf16
// before GELU and again after, as a bf16 conv followed by a bf16 GELU is.
__device__ __forceinline__ void conv_tn_gelu(unsigned char* stg) {
  const int t = threadIdx.x & 127;
#pragma unroll 1
  for (uint32_t k = 0; k < kOutStg / 16 / 128; ++k) {
    uint4* p = reinterpret_cast<uint4*>(stg + (k * 128 + t) * 16);
    uint4 w = *p;
    uint32_t u[4] = {w.x, w.y, w.z, w.w};
    float v[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u[i]));
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
    gelu_erf(v);
    *p = make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]), pack_bf16x2(v[4], v[5]),
                    pack_bf16x2(v[6], v[7]));
  }
}

// ---- Cout <= 8: pixels as M ----------------------------------------------------

// acc[mt] += sum over taps (ty, tx) < KH and KS K steps of A * B, where this
// warp's A rows of m64 tile mt are window pixels base[mt] + (ty + pa) * kWin +
// tx + pb and the tap's B operand starts at shared address w_s + tap * N * 128.
// A is double-buffered in registers by K step, so a step's ldmatrix runs
// while the previous step's wgmma is on the tensor cores.
template <int N, int KS, int KH>
__device__ __forceinline__ void conv_tile_mma(float (&acc)[2][N / 2], const unsigned char* win,
                                              uint32_t w_s, int pa, int pb, const int (&base)[2]) {
  const int half = (threadIdx.x & 31) >> 4;
  uint32_t af[2][2][4] = {};
#pragma unroll
  for (int tap = 0; tap < KH * KH; ++tap) {
    const int off = (tap / KH + pa) * kWin + tap % KH + pb;
#pragma unroll
    for (int kb = 0; kb < KS; ++kb) {
      const int buf = (tap * KS + kb) & 1;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int p = base[mt] + off, q = kb * 2 + half;
        ldmatrix_x4(af[buf][mt], win + (p * 8 + (q ^ (p & 7))) * 16);
      }
      wgmma_fence();
      const uint64_t desc = wgmma_desc_sw128(w_s + tap * N * 128 + kb * 32);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) Wgmma<N>::mma(acc[mt], af[buf][mt], desc);
      wgmma_commit();
      wgmma_wait<1>();  // the previous step's wgmma is done with af[buf ^ 1]
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int r = 0; r < 4; ++r) reg_fence(af[buf ^ 1][mt][r]);
      }
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) reg_fence(acc[mt][i]);
  }
}

// Bias, lrelu and the store of this warp's 16 accumulator rows (pixels gx0 ..
// gx0 + 15 of tile row gy, parity (pa, pb)), through its staging buffer stg.
template <int N, bool UP>
__device__ __forceinline__ void conv_tile_store(const ConvTcArgs& a, const float (&acc)[N / 2],
                                                const float (&bv)[N / 4], __nv_bfloat16* stg,
                                                int n, int gy, int gx0, int pa, int pb) {
  const int lane = threadIdx.x & 31, pr = lane >> 2;
  constexpr int kMask = N / 8 - 1;  // staging rows swizzle their 16-byte chunks
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      float v0 = acc[4 * j + 2 * hf] + bv[2 * j], v1 = acc[4 * j + 2 * hf + 1] + bv[2 * j + 1];
      if (a.act) {
        v0 = lrelu(v0);
        v1 = lrelu(v1);
      }
      *reinterpret_cast<uint32_t*>(stg + pr * N + (j ^ (pr & kMask)) * 8 + (lane & 3) * 2) =
          pack_bf16x2(v0, v1);
    }
    __syncwarp();
    for (int e = lane; e < kStgPix * a.cout; e += 32) {
      const int pp = e / a.cout, c = e % a.cout, gx = gx0 + kStgPix * hf + pp;
      if (gy < a.h && gx < a.w)
        a.out[conv_out_pixel(n, a.h, a.w, gy, gx, UP, pa, pb) * a.cout + c] =
            stg[pp * N + ((c >> 3) ^ (pp & kMask)) * 8 + (c & 7)];
    }
    __syncwarp();
  }
}

// ---- the kernel ----------------------------------------------------------------

// Channel chunks q < live (8 channels each) of K chunk c0 / 64 of tile (n,
// y0, x0)'s window (input channels c0 + 8 q ..), loaded by the 32 lanes of a
// warp into swizzled HWC shared memory, zero outside the image and beyond
// Cin, for an input whose Cin TMA cannot take. With one K chunk, live is
// ceil(Cin / 8) and the other chunks stay as they were zeroed at kernel
// start; with more, a stage holds each chunk in turn and live is 8.
__device__ __forceinline__ void conv_tc_load_window(unsigned char* dst, const ConvTcArgs& a, int n,
                                                    int y0, int x0, int lane, int c0, int live) {
  for (int i = lane; i < kWin * kWin * live; i += 32) {
    const int q = i % live, p = i / live, ch = c0 + q * 8;
    const int gy = y0 - 1 + p / kWin, gx = x0 - 1 + p % kWin;
    uint32_t u[4] = {0, 0, 0, 0};
    if (gy >= 0 && gy < a.h && gx >= 0 && gx < a.w) {
      const unsigned short* src = reinterpret_cast<const unsigned short*>(
          a.x + (((size_t)n * a.h + gy) * a.w + gx) * a.cin + ch);
      for (int e = 0; e < 8 && ch + e < a.cin; ++e) u[e / 2] |= uint32_t(src[e]) << (16 * (e % 2));
    }
    *reinterpret_cast<uint4*>(dst + swz(p, q, 8) * 2) = make_uint4(u[0], u[1], u[2], u[3]);
  }
}

// The same window for Cin 129-192 that TMA cannot take (Cin a multiple of
// 4): each 16-byte chunk as two 8-byte cp.async copies that zero-fill
// outside the image and beyond Cin; the warp waits for its copies, so the
// stage is complete when it signals it.
__device__ __forceinline__ void conv_tc_load_window_async(unsigned char* dst, const ConvTcArgs& a, int n,
                                                          int y0, int x0, int lane, int c0) {
  for (int i = lane; i < kWin * kWin * 16; i += 32) {
    const int h = i & 1, q = (i >> 1) & 7, p = i >> 4, ch = c0 + q * 8 + h * 4;
    const int gy = y0 - 1 + p / kWin, gx = x0 - 1 + p % kWin;
    const bool live = gy >= 0 && gy < a.h && gx >= 0 && gx < a.w && ch < a.cin;
    const __nv_bfloat16* src = live ? a.x + (((size_t)n * a.h + gy) * a.w + gx) * a.cin + ch : a.x;
    cp_async8_zfill(dst + swz(p, q, 8) * 2 + h * 8, src, live ? 8 : 0);
  }
  cp_async_commit();
  cp_async_wait<0>();
}

// Window w, counted in the order the producer loads them, sits in ring stage
// ring_stage(w), whose full and empty mbarriers it passes in phase parity
// ring_phase(w).
template <int STAGES>
__device__ __forceinline__ int ring_stage(int w) { return STAGES == 1 ? 0 : w & 1; }
template <int STAGES>
__device__ __forceinline__ uint32_t ring_phase(int w) { return (STAGES == 1 ? w : w >> 1) & 1; }

// N: output channels per block (64: pixels as N, a slice of Cout_pad; 8:
// Cout <= 8, pixels as M); KS: 16-deep K steps per tap and K chunk (Cin
// padded to 16 or 64 a chunk); UP: 2x2 parity mode; KC: K chunks of 64 input
// channels; SLICED: Cout_pad = 64 a.slices with a.slices > 1 (N = 64).
// omap: the output's tensor map (N = 64): 5-D (channels, x, parity row, y,
// image), boxes of 64 channels x 16 x 1 x 8 x 1.
// GELU: the epilogue is GELU with erf (conv_tc_kernel_gelu), else bias and
// the act a.act names (conv_tc_kernel).
template <int N, int KS, bool UP, int KC, bool SLICED, bool GELU>
__device__ __forceinline__ void conv_tc_body(const CUtensorMap* xmap, const CUtensorMap* omap, const ConvTcArgs& a) {
  constexpr int kKH = UP ? 2 : 3, kPar = UP ? 2 : 1;  // parities per block: (pa, 0), (pa, 1)
  constexpr int kTaps = kKH * kKH;
  constexpr uint32_t kWBytes = conv_tc_wbytes(N, UP, KC);
  constexpr int kStages = conv_tc_stages(N, UP, KC);
  constexpr bool kStream = conv_tc_streams(KC);  // weights through a ring of two chunk slots
  constexpr uint32_t kChunkW = conv_tc_chunk_wbytes(N, UP);
  static_assert(!kStream || (N == 64 && !UP), "streamed weights: 3x3, Cout a multiple of 64");
  // one window per tile serves its parities (KC = 1), else one per parity
  // and K chunk
  constexpr int kWinPerTile = KC == 1 ? 1 : kPar * KC;
  extern __shared__ __align__(1024) unsigned char tc_smem[];
  unsigned char* wsm = tc_smem + ((1024 - (smem_addr(tc_smem) & 1023)) & 1023);
  unsigned char* win = wsm + kWBytes;
  unsigned char* stg_all = win + kStages * kWinStride;
  uint64_t* bars = reinterpret_cast<uint64_t*>(stg_all + conv_tc_stg_bytes(N));
  // bars[0]: weights; bars[1 + s]: window stage s is full; bars[1 + kStages
  // + s]: the 8 consumer warps have read window stage s (their last wgmma or
  // ldmatrix); streamed weights: bars[5 + j] weight slot j is full, bars[7 +
  // j] the 8 consumer warps are done with it
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kStages;
  uint64_t* wfull = bars + 5;
  uint64_t* wempty = bars + 7;

  // the warp index through a shuffle, so that the compiler knows it is the
  // same for the whole warp: wgmma in a path it thinks divergent is serialized
  const int tid = threadIdx.x, lane = tid & 31, warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int g = warp >> 2, tiles_img = a.tiles_x * a.tiles_y;
  // block b's role: parity row pa (2x2 mode) and Cout slice; it takes tiles
  // b / roles, b / roles + grid / roles, ..., roles = 2 x slices (2x2 mode)
  int pa = 0, slice = 0, t0 = blockIdx.x, t_step = gridDim.x;
  if constexpr (SLICED) {
    const int roles = kPar * a.slices, role = blockIdx.x % roles;
    pa = UP ? role & 1 : 0;
    slice = UP ? role >> 1 : role;
    t0 = blockIdx.x / roles;
    t_step = gridDim.x / roles;
  } else if constexpr (UP) {
    pa = blockIdx.x & 1;
    t0 = blockIdx.x >> 1;
    t_step = gridDim.x >> 1;
  }
  const int n_slices = SLICED ? a.slices : 1;
  if (tid == 0) {
    mbar_init(&bars[0], 1);
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kThreads / 32);
    }
    if constexpr (kStream) {
      for (int i = 0; i < 2; ++i) {
        mbar_init(&wfull[i], 1);
        mbar_init(&wempty[i], kThreads / 32);
      }
    }
    mbar_fence_init();
  }
  if (!a.use_tma) {  // channels the loads never write stay zero
    for (uint32_t i = tid * 16; i < kStages * kWinStride; i += kTcThreads * 16)
      *reinterpret_cast<uint4*>(win + i) = make_uint4(0, 0, 0, 0);
    fence_proxy_async();
  }
  __syncthreads();

  if (warp == kThreads / 32) {  // the producer warp
    if (lane == 0) {
      if constexpr (!kStream) {
        mbar_expect_tx(&bars[0], kWBytes);
        const unsigned char* src =
            reinterpret_cast<const unsigned char*>(a.wt) + (size_t)(pa * n_slices + slice) * kWBytes;
        for (uint32_t off = 0; off < kWBytes; off += 16384)
          bulk_copy_g2s(wsm + off, src + off, min(16384u, kWBytes - off), &bars[0]);
      }
      if (a.use_tma) prefetch_tensor_map(xmap);
    }
    const int live = KC == 1 ? (a.cin + 7) / 8 : 8;
    int wi = 0;
    for (int t = t0; t < a.n_tiles; t += t_step) {
      const int n = t / tiles_img, r = t % tiles_img;
      const int y0 = (r / a.tiles_x) * kTile, x0 = (r % a.tiles_x) * kTile;
#pragma unroll
      for (int k = 0; k < kWinPerTile; ++k, ++wi) {
        const int s = ring_stage<kStages>(wi), c0 = 64 * (k % KC);
        if constexpr (kStream) {  // chunk k's weights into slot wi % 2, once its last reader is done
          const int j = wi & 1;
          if (wi >= 2) mbar_wait(&wempty[j], ((wi - 2) >> 1) & 1);
          if (lane == 0) {
            mbar_expect_tx(&wfull[j], kChunkW);
            const unsigned char* src =
                reinterpret_cast<const unsigned char*>(a.wt) + ((size_t)slice * KC + k) * kChunkW;
            for (uint32_t off = 0; off < kChunkW; off += 16384)
              bulk_copy_g2s(wsm + j * kChunkW + off, src + off, min(16384u, kChunkW - off), &wfull[j]);
          }
        }
        if (wi >= kStages) mbar_wait(&empty[s], ring_phase<kStages>(wi - kStages));
        if (a.use_tma) {
          if (lane == 0) {
            mbar_expect_tx(&full[s], kWinBytes);
            tma_load_4d(win + s * kWinStride, xmap, c0, x0 - 1, y0 - 1, n, &full[s]);
          }
        } else {
          if constexpr (kStream)
            conv_tc_load_window_async(win + s * kWinStride, a, n, y0, x0, lane, c0);
          else
            conv_tc_load_window(win + s * kWinStride, a, n, y0, x0, lane, c0, live);
          fence_proxy_async();  // the wgmmas read the window through the async proxy
          __syncwarp();
          if (lane == 0) mbar_arrive(&full[s]);
        }
      }
    }
    return;
  }

  // unit u: tile it = u / kPar of this block (global tile t0 + it * t_step),
  // parity (pa, u % kPar); its K chunk c is window KC == 1 ? it : u * KC + c
  const int n_units = (a.n_tiles - t0 + t_step - 1) / t_step * kPar;
  const uint32_t w_s = smem_addr(wsm), win_s = smem_addr(win);
  if constexpr (!kStream) mbar_wait(&bars[0], 0);

  if constexpr (N == 64) {
    // this thread's accumulator rows: output channels 64 slice + 16 (warp % 4)
    // + lane / 4 (+ 8)
    float bv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int co = 64 * slice + 16 * (warp & 3) + lane / 4 + 8 * i;
      bv[i] = a.bias != nullptr ? a.bias[co] : 0.f;
    }
    const bool issuer = (tid & 127) == 0;  // the warpgroup's thread for its TMA stores
    const uint32_t stg_s = smem_addr(stg_all) + g * kOutStg;
    const uint32_t dump_s = smem_addr(stg_all) + 2 * kOutStg + g * 128;
    float acc[kVirt / 2];
    // One K chunk: the two warpgroups take turns issuing to the tensor cores,
    // unit by unit (0, 1, 0, 1, ...: named barriers 3 and 4): a group's
    // wgmmas queue behind the other's, and each stores its unit while the
    // other's run. More chunks: both issue each chunk as it arrives.
    for (int u = 0; u < n_units; ++u) {
      const int it = u / kPar, pb = u % kPar, t = t0 + it * t_step, r = t % tiles_img;
      if (KC == 1 && (g == 1 || u > 0)) named_barrier(3 + g, 2 * 128);  // the other group's turn is over
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        const int wi = KC == 1 ? it : u * KC + c, s = ring_stage<kStages>(wi);
        if (KC > 1 || pb == 0) mbar_wait(&full[s], ring_phase<kStages>(wi));
        uint32_t w_c = w_s + (c * kPar + pb) * kTaps * 64 * 128;
        if constexpr (kStream) {
          mbar_wait(&wfull[wi & 1], (wi >> 1) & 1);
          w_c = w_s + (wi & 1) * kChunkW;
        }
        conv_tn_issue<KS, kKH>(acc, win_s + s * kWinStride, w_c, g * kVirt, pa, pb, c > 0);
        if (KC == 1 && (g == 0 || u + 1 < n_units)) named_barrier_arrive(4 - g, 2 * 128);
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < kVirt / 2; ++i) reg_fence(acc[i]);
        if (KC > 1 || pb == kPar - 1) {  // the warp is done with the window
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[s]);
          if constexpr (kStream) {
            if (lane == 0) mbar_arrive(&wempty[wi & 1]);
          }
        }
      }
      if (issuer) bulk_wait_read<0>();  // the previous TMA store has read the staging tile
      named_barrier(1 + g, 128);
      conv_tn_stage(acc, bv, GELU ? 0 : a.act, kStream && a.act == 2 ? 0.01f : 0.2f, stg_s, dump_s);
      if constexpr (GELU) {
        named_barrier(1 + g, 128);  // the warpgroup's tile is staged
        conv_tn_gelu(stg_all + g * kOutStg);
      }
      fence_proxy_async();  // the TMA store reads the staging tile through the async proxy
      named_barrier(1 + g, 128);
      if (issuer) {
        tma_store_5d(omap, stg_s, (UP ? pb * 64 * n_slices : 0) + 64 * slice, (r % a.tiles_x) * kTile,
                     UP ? pa : 0, (r / a.tiles_x) * kTile + g * (kTile / 2), t / tiles_img);
        bulk_commit();
      }
    }
    if (issuer) bulk_wait<0>();
  } else {
    // this thread's accumulator columns: output channels 2 (lane % 4) + {0, 1}
    float bv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int co = 2 * (lane & 3) + i;
      bv[i] = (a.bias != nullptr && co < a.cout) ? a.bias[co] : 0.f;
    }
    // warpgroup g takes tile rows 8 g .. 8 g + 7: m64 tile mt, warp w of the
    // group: row rows[mt]; lane l addresses A row (pixel) l % 16 of it
    const int rows[2] = {g * 8 + (warp & 3), g * 8 + 4 + (warp & 3)};
    const int base[2] = {rows[0] * kWin + (lane & 15), rows[1] * kWin + (lane & 15)};
    __nv_bfloat16* stg = reinterpret_cast<__nv_bfloat16*>(stg_all) + warp * kStgPix * N;
    for (int u = 0; u < n_units; ++u) {
      const int it = u / kPar, pb = u % kPar, t = t0 + it * t_step, r = t % tiles_img;
      float acc[2][N / 2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int i = 0; i < N / 2; ++i) acc[mt][i] = 0.f;
      }
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        const int wi = KC == 1 ? it : u * KC + c, s = ring_stage<kStages>(wi);
        if (KC > 1 || pb == 0) mbar_wait(&full[s], ring_phase<kStages>(wi));
        conv_tile_mma<N, KS, kKH>(acc, win + s * kWinStride, w_s + (c * kPar + pb) * kTaps * N * 128,
                                  pa, pb, base);
        if (KC > 1 || pb == kPar - 1) {  // the warp is done with the window
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[s]);
        }
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        conv_tile_store<N, UP>(a, acc[mt], bv, stg, t / tiles_img, (r / a.tiles_x) * kTile + rows[mt],
                               (r % a.tiles_x) * kTile, pa, pb);
    }
  }
}

template <int N, int KS, bool UP, int KC, bool SLICED>
__global__ void __launch_bounds__(kTcThreads, N == 64 ? 1 : 2)
    conv_tc_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap omap,
                   const ConvTcArgs a) {
  conv_tc_body<N, KS, UP, KC, SLICED, false>(&xmap, &omap, a);
}

// The GELU epilogue (HAT's CAB conv 180 -> 60, Cout padded to 64: the
// <64, 4, false, 3, false> instance alone), beside conv_tc_kernel so that
// the latter's instances stay as they were.
template <int N, int KS, bool UP, int KC, bool SLICED>
__global__ void __launch_bounds__(kTcThreads, N == 64 ? 1 : 2)
    conv_tc_kernel_gelu(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap omap,
                        const ConvTcArgs a) {
  static_assert(N == 64, "the GELU epilogue is the Cout-slice path's");
  conv_tc_body<N, KS, UP, KC, SLICED, true>(&xmap, &omap, a);
}

}  // namespace esr
