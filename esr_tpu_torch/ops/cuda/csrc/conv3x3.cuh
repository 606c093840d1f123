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
//         with parity q = 2a + b' and zero outside the image; optional lrelu_0.2.
//
// What bounds it: on the main path (Cin 64 -> Cout 64 at B16 x 128^2 to
// 512^2) each conv does 2 * 576 FLOP per output channel and pixel against
// 2 * 128 bytes of activation per pixel in bf16: ~290 FLOP per byte, at the
// card's balance point; conv_first (Cin 4) and conv_last (Cout 3) are bound
// by bytes.
//
// Two kernels: bf16 (conv_tc_kernel, the main path, Cin and Cout up to 64;
// design below) on the Hopper tensor cores, and conv_kernel<T> on the SIMT
// units, T = float (exact comparisons) or bf16 (the convs wider than 64
// channels that conv_tc_kernel does not take; window in bf16, f32
// accumulation; at Cin = Cout = 128 about 64 FLOP per byte of activation,
// bound by operations on the SIMT units): one block per 16 x 16 output tile
// (and parity) loads its window
// planar into shared memory, weights from L2, 128 pixels x 8 channels per
// warp item. Cout is padded in the weight layout only and the stores mask
// the ragged channel edge (conv_last's 3).
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace esr {

constexpr int kTile = 16;

template <typename T>
struct ConvArgs {
  const T* x;         // (n, h, w, cin) NHWC
  const T* wt;        // [parities][k*k][cin][cout_pad]
  const float* bias;  // [cout] or nullptr
  T* out;             // (n, h, w, cout), or (n, 2h, 2w, cout) in 2x2 mode
  int n, h, w, cin, cout, cout_pad;
  int ksize;  // 3: SAME 3x3 conv; 2: the four parity convs of upsample2x + conv3x3
  int act;    // apply lrelu_0.2
};

inline size_t conv_smem_bytes(int cin, int ksize, size_t elem) {
  return (size_t)cin * (kTile + ksize - 1) * (kTile + ksize - 1) * elem;
}

// Output pixel of tile pixel (gy, gx): its own place, or its interleaved place
// (2 gy + a, 2 gx + b) of parity q = 2a + b in the 2x2 mode.
__device__ __forceinline__ size_t conv_out_pixel(int n, int h, int w, int gy, int gx, bool up,
                                                 int pa, int pb) {
  return up ? ((size_t)n * 2 * h + 2 * gy + pa) * (2 * w) + 2 * gx + pb
            : ((size_t)n * h + gy) * w + gx;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) conv_kernel(const ConvArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* win = reinterpret_cast<T*>(smem_raw);
  const int ks = a.ksize, ww = kTile + ks - 1, plane = ww * ww;
  const bool up = ks == 2;
  const int nq = up ? 4 : 1;
  const int n = blockIdx.z / nq, q = blockIdx.z % nq, pa = q >> 1, pb = q & 1;
  const int y0 = blockIdx.y * kTile, x0 = blockIdx.x * kTile;
  // the window of output (i, j) starts at input (i - 1 + a, j - 1 + b')
  load_window(win, a.x, n, a.h, a.w, a.cin, y0 - 1 + pa, x0 - 1 + pb, ww, ww);
  __syncthreads();

  const T* wq = a.wt + (size_t)q * ks * ks * a.cin * a.cout_pad;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int n_pb = kTile * kTile / kPixBlock, n_cg = a.cout_pad / kCO;
  for (int item = warp; item < n_pb * n_cg; item += nwarps) {
    const int ib = item % n_pb, cg = item / n_pb;
    int pr[kPX], pc[kPX], base[kPX];
#pragma unroll
    for (int p = 0; p < kPX; ++p) {
      const int qq = ib * kPixBlock + lane + 32 * p;
      pr[p] = qq / kTile;
      pc[p] = qq % kTile;
      base[p] = pr[p] * ww + pc[p];
    }
    float acc[kPX][kCO];
#pragma unroll
    for (int c = 0; c < kCO; ++c) {
      const int co = cg * kCO + c;
      const float bv = (a.bias != nullptr && co < a.cout) ? a.bias[co] : 0.f;
#pragma unroll
      for (int p = 0; p < kPX; ++p) acc[p][c] = bv;
    }
    accumulate<T>(acc, win, plane, ww, base, a.cin, ks, ks, wq + cg * kCO, a.cin * a.cout_pad,
                  a.cout_pad);
#pragma unroll
    for (int p = 0; p < kPX; ++p) {
      const int gy = y0 + pr[p], gx = x0 + pc[p];
      if (gy >= a.h || gx >= a.w) continue;
      T* o = a.out + conv_out_pixel(n, a.h, a.w, gy, gx, up, pa, pb) * a.cout;
#pragma unroll
      for (int c = 0; c < kCO; ++c) {
        const int co = cg * kCO + c;
        if (co < a.cout) o[co] = from_float<T>(a.act ? lrelu(acc[p][c]) : acc[p][c]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The bf16 main-path kernel, conv_tc_kernel: Hopper tensor cores, persistent,
// one producer warp and two consumer warpgroups.
//
// - Weights resident in shared memory: each block copies the weights it needs
//   once (bulk async copies on an mbarrier): per tap (and parity) Cout_pad
//   rows of 64 K values, 128B-swizzled (hopper.cuh), the K-major wgmma
//   operand; conv_kernel_weights builds the image. No k-loop reads global
//   memory.
// - Persistent blocks walk the 16 x 16 tiles (t, t + grid, ...). The producer
//   warp brings each tile's 18 x 18 x 64 input window into a 2-stage ring,
//   a stage once the 8 consumer warps have released it (mbarriers): by one
//   TMA box load (CU_TENSOR_MAP_SWIZZLE_128B, which is swz(p, q, 8)), whose
//   zero fill outside the tensor is the SAME padding and the ragged edges;
//   or, for an input whose Cin is not 64 (conv_first's 4: an 8-byte pixel
//   stride, which TMA cannot take), by plain loads of the live channel chunks
//   into stages zeroed once.
// - Cout 64: out^T = W^T x^T. wgmma m64n144k16 with both operands in shared
//   memory: A = the tap's weights (64 output channels x K), B = 144
//   consecutive window pixels shifted by the tap. A window row is 18 pixels,
//   so a warpgroup computes 8 rows x 18 "virtual" pixels and drops columns 16
//   and 17 (12.5% more MMA work); in exchange the pixels form one evenly
//   strided operand that one descriptor addresses (at any 128-byte row: see
//   wgmma_desc_sw128), and no A fragment passes through registers. The two
//   warpgroups take turns on the tensor cores. The epilogue transposes the
//   accumulators into pixels with stmatrix.trans and stores each warpgroup's
//   8 x 16 pixels with one TMA store, which also clips the ragged edges.
// - Cout <= 8 (conv_last's 3, a 6-byte pixel stride): pixels as M, wgmma
//   m64n8k16 with A from registers (ldmatrix from the window shifted by the
//   tap: per warp the mma.sync A fragment) and B from the weights; masked
//   stores.
// - 2x2 mode: a block takes the two parities (a, 0) and (a, 1) of its tiles
//   (a = block index % 2), so their 64 KB of weights fit beside the ring; one
//   window serves both (a parity moves the tap origin by (a, b)).
// ---------------------------------------------------------------------------

constexpr int kWin = kTile + 2;                                    // window edge: 18
constexpr uint32_t kWinBytes = kWin * kWin * 128;                  // 64 bf16 per pixel
constexpr uint32_t kWinStride = (kWinBytes + 1023) / 1024 * 1024;  // stages 1024-aligned
constexpr int kVirt = kTile / 2 * kWin;    // Cout 64: virtual pixels per warpgroup, 144
constexpr uint32_t kOutStg = kTile / 2 * kTile * 128;  // Cout 64: a warpgroup's 8 x 16 pixels
constexpr int kStgPix = 8;                 // Cout <= 8: pixels per warp and store pass
constexpr int kTcThreads = kThreads + 32;  // two consumer warpgroups + one producer warp

struct ConvTcArgs {
  const __nv_bfloat16* x;   // (n, h, w, cin) NHWC
  const __nv_bfloat16* wt;  // weight image [parity * taps][Cout_pad][64], 128B-swizzled rows
  const float* bias;        // [cout] or nullptr
  __nv_bfloat16* out;       // (n, h, w, cout), or (n, 2h, 2w, cout) in 2x2 mode
  int n, h, w, cin, cout, act;
  int use_tma;  // cin == 64: windows by TMA; otherwise plain loads
  int tiles_x, tiles_y, n_tiles;
};

// Shared memory of conv_tc_kernel<N, *, UP>: 1024 bytes of alignment slack, the
// block's weights, two window stages, the epilogue staging (Cout 64: two
// 8 x 16-pixel tiles and a 128-byte dump row each; Cout <= 8: 8 pixels per
// warp), five mbarriers.
__host__ __device__ constexpr uint32_t conv_tc_wbytes(int n_pad, bool up) {
  return (up ? 2 * 4 : 9) * n_pad * 128;
}
__host__ __device__ constexpr uint32_t conv_tc_stg_bytes(int n_pad) {
  return n_pad == 64 ? 2 * (kOutStg + 128) : (kThreads / 32) * kStgPix * n_pad * 2;
}
inline size_t conv_tc_smem_bytes(int n_pad, int ksize) {
  return 1024 + conv_tc_wbytes(n_pad, ksize == 2) + 2 * kWinStride + conv_tc_stg_bytes(n_pad) + 5 * 8;
}

// ---- Cout 64: pixels as N ----------------------------------------------------

// Issue (no wait) acc = W^T x^T of this warpgroup's 144 virtual pixels (first
// at window pixel v0) for parity (pa, pb): taps (ty, tx) < KH, KS K steps;
// the parity's tap weights start at w_s.
template <int KS, int KH>
__device__ __forceinline__ void conv_tn_issue(float (&acc)[kVirt / 2], uint32_t win_s, uint32_t w_s,
                                              int v0, int pa, int pb) {
  wgmma_fence();
#pragma unroll
  for (int tap = 0; tap < KH * KH; ++tap) {
    const uint32_t b_s = win_s + (v0 + (tap / KH + pa) * kWin + tap % KH + pb) * 128;
#pragma unroll
    for (int kb = 0; kb < KS; ++kb)
      WgmmaSS<kVirt>::mma(acc, wgmma_desc_sw128(w_s + tap * 64 * 128 + kb * 32),
                          wgmma_desc_sw128(b_s + kb * 32), tap + kb > 0);
  }
  wgmma_commit();
}

// Bias, lrelu and bf16 of the warpgroup's 144 virtual pixels into its staging
// tile stg_s (8 rows x 16 pixels x 128 bytes, 16-byte chunks swizzled by
// pixel as TMA reads them): the warp holds output channels 16 (warp % 4) ..
// + 15 of every pixel, and stmatrix.trans writes them as pixel rows. Columns
// 16 and 17 go to the dump row dump_s.
__device__ __forceinline__ void conv_tn_stage(const float (&acc)[kVirt / 2], const float (&bv)[2],
                                              bool act, uint32_t stg_s, uint32_t dump_s) {
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
        v0 = lrelu(v0);
        v1 = lrelu(v1);
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

// ---- Cout <= 8: pixels as M ----------------------------------------------------

// acc[mt] = sum over taps (ty, tx) < KH and KS K steps of A * B, where this
// warp's A rows of m64 tile mt are window pixels base[mt] + (ty + pa) * kWin +
// tx + pb and the tap's B operand starts at shared address w_s + tap * N * 128.
// A is double-buffered in registers by K step, so a step's ldmatrix runs
// while the previous step's wgmma is on the tensor cores.
template <int N, int KS, int KH>
__device__ __forceinline__ void conv_tile_mma(float (&acc)[2][N / 2], const unsigned char* win,
                                              uint32_t w_s, int pa, int pb, const int (&base)[2]) {
  const int half = (threadIdx.x & 31) >> 4;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[mt][i] = 0.f;
  }
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

// The live channel chunks (q < ceil(Cin / 8)) of tile (n, y0, x0)'s window,
// loaded by the 32 lanes of a warp into swizzled HWC shared memory, zero
// outside the image, for an input whose Cin TMA cannot take. The other chunks
// stay as they were zeroed at kernel start.
__device__ __forceinline__ void conv_tc_load_window(unsigned char* dst, const ConvTcArgs& a, int n,
                                                    int y0, int x0, int lane) {
  const int live = (a.cin + 7) / 8;
  for (int i = lane; i < kWin * kWin * live; i += 32) {
    const int q = i % live, p = i / live;
    const int gy = y0 - 1 + p / kWin, gx = x0 - 1 + p % kWin;
    uint32_t u[4] = {0, 0, 0, 0};
    if (gy >= 0 && gy < a.h && gx >= 0 && gx < a.w) {
      const unsigned short* src = reinterpret_cast<const unsigned short*>(
          a.x + (((size_t)n * a.h + gy) * a.w + gx) * a.cin + q * 8);
      for (int e = 0; e < 8 && q * 8 + e < a.cin; ++e) u[e / 2] |= uint32_t(src[e]) << (16 * (e % 2));
    }
    *reinterpret_cast<uint4*>(dst + swz(p, q, 8) * 2) = make_uint4(u[0], u[1], u[2], u[3]);
  }
}

// N: Cout padded (64: pixels as N, Cout exactly 64; 8: pixels as M); KS:
// 16-deep K steps per tap (Cin padded to 16 or 64); UP: 2x2 parity mode.
// omap: the output's tensor map (Cout 64): 5-D (channels, x, parity row, y,
// image), boxes of 64 channels x 16 x 1 x 8 x 1.
template <int N, int KS, bool UP>
__global__ void __launch_bounds__(kTcThreads, N == 64 ? 1 : 2)
    conv_tc_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap omap,
                   const ConvTcArgs a) {
  constexpr int kKH = UP ? 2 : 3, kPar = UP ? 2 : 1;  // parities per block: (pa, 0), (pa, 1)
  constexpr uint32_t kWBytes = conv_tc_wbytes(N, UP);
  extern __shared__ __align__(1024) unsigned char tc_smem[];
  unsigned char* wsm = tc_smem + ((1024 - (smem_addr(tc_smem) & 1023)) & 1023);
  unsigned char* win = wsm + kWBytes;
  unsigned char* stg_all = win + 2 * kWinStride;
  uint64_t* bars = reinterpret_cast<uint64_t*>(stg_all + conv_tc_stg_bytes(N));
  // bars[0]: weights; bars[1 + s]: window stage s is full; bars[3 + s]: the
  // 8 consumer warps have read window stage s (their last wgmma or ldmatrix)

  // the warp index through a shuffle, so that the compiler knows it is the
  // same for the whole warp: wgmma in a path it thinks divergent is serialized
  const int tid = threadIdx.x, lane = tid & 31, warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int g = warp >> 2, tiles_img = a.tiles_x * a.tiles_y;
  // 2x2 mode: block b takes parity row pa = b % 2 of tiles b / 2, b / 2 + grid / 2, ...
  const int pa = UP ? (int)(blockIdx.x & 1) : 0;
  const int t0 = UP ? (int)blockIdx.x >> 1 : (int)blockIdx.x;
  const int t_step = UP ? (int)gridDim.x >> 1 : (int)gridDim.x;
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&bars[i], 1);
    for (int i = 3; i < 5; ++i) mbar_init(&bars[i], kThreads / 32);
    mbar_fence_init();
  }
  if (!a.use_tma) {  // channels the loads never write stay zero
    for (uint32_t i = tid * 16; i < 2 * kWinStride; i += kTcThreads * 16)
      *reinterpret_cast<uint4*>(win + i) = make_uint4(0, 0, 0, 0);
    fence_proxy_async();
  }
  __syncthreads();

  if (warp == kThreads / 32) {  // the producer warp
    if (lane == 0) {
      mbar_expect_tx(&bars[0], kWBytes);
      const unsigned char* src = reinterpret_cast<const unsigned char*>(a.wt) + pa * kWBytes;
      for (uint32_t off = 0; off < kWBytes; off += 16384)
        bulk_copy_g2s(wsm + off, src + off, min(16384u, kWBytes - off), &bars[0]);
      if (a.use_tma) prefetch_tensor_map(&xmap);
    }
    int it = 0;
    for (int t = t0; t < a.n_tiles; t += t_step, ++it) {
      const int s = it & 1, n = t / tiles_img, r = t % tiles_img;
      const int y0 = (r / a.tiles_x) * kTile, x0 = (r % a.tiles_x) * kTile;
      if (it >= 2) mbar_wait(&bars[3 + s], ((it - 2) >> 1) & 1);
      if (a.use_tma) {
        if (lane == 0) {
          mbar_expect_tx(&bars[1 + s], kWinBytes);
          tma_load_4d(win + s * kWinStride, &xmap, 0, x0 - 1, y0 - 1, n, &bars[1 + s]);
        }
      } else {
        conv_tc_load_window(win + s * kWinStride, a, n, y0, x0, lane);
        fence_proxy_async();  // the wgmmas read the window through the async proxy
        __syncwarp();
        if (lane == 0) mbar_arrive(&bars[1 + s]);
      }
    }
    return;
  }

  // unit u: tile it = u / kPar of this block (global tile t0 + it * t_step,
  // window stage it % 2), parity (pa, u % kPar)
  const int n_units = (a.n_tiles - t0 + t_step - 1) / t_step * kPar;
  const uint32_t w_s = smem_addr(wsm), win_s = smem_addr(win);
  mbar_wait(&bars[0], 0);

  if constexpr (N == 64) {
    // this thread's accumulator rows: output channels 16 (warp % 4) + lane / 4 (+ 8)
    float bv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int co = 16 * (warp & 3) + lane / 4 + 8 * i;
      bv[i] = a.bias != nullptr ? a.bias[co] : 0.f;
    }
    const bool issuer = (tid & 127) == 0;  // the warpgroup's thread for its TMA stores
    const uint32_t stg_s = smem_addr(stg_all) + g * kOutStg;
    const uint32_t dump_s = smem_addr(stg_all) + 2 * kOutStg + g * 128;
    float acc[kVirt / 2];
    // The two warpgroups take turns issuing to the tensor cores, unit by unit
    // (0, 1, 0, 1, ...: named barriers 3 and 4): a group's wgmmas queue
    // behind the other's, and each stores its unit while the other's run.
    for (int u = 0; u < n_units; ++u) {
      const int it = u / kPar, pb = u % kPar, t = t0 + it * t_step, r = t % tiles_img;
      if (g == 1 || u > 0) named_barrier(3 + g, 2 * 128);  // the other group's turn is over
      if (pb == 0) mbar_wait(&bars[1 + (it & 1)], (it >> 1) & 1);
      conv_tn_issue<KS, kKH>(acc, win_s + (it & 1) * kWinStride, w_s + pb * kKH * kKH * 64 * 128,
                             g * kVirt, pa, pb);
      if (g == 0 || u + 1 < n_units) named_barrier_arrive(4 - g, 2 * 128);
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < kVirt / 2; ++i) reg_fence(acc[i]);
      if (pb == kPar - 1) {  // the warp is done with the window
        __syncwarp();
        if (lane == 0) mbar_arrive(&bars[3 + (it & 1)]);
      }
      if (issuer) bulk_wait_read<0>();  // the previous TMA store has read the staging tile
      named_barrier(1 + g, 128);
      conv_tn_stage(acc, bv, a.act, stg_s, dump_s);
      fence_proxy_async();  // the TMA store reads the staging tile through the async proxy
      named_barrier(1 + g, 128);
      if (issuer) {
        tma_store_5d(&omap, stg_s, UP ? pb * 64 : 0, (r % a.tiles_x) * kTile, UP ? pa : 0,
                     (r / a.tiles_x) * kTile + g * (kTile / 2), t / tiles_img);
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
      if (pb == 0) mbar_wait(&bars[1 + (it & 1)], (it >> 1) & 1);
      float acc[2][N / 2];
      conv_tile_mma<N, KS, kKH>(acc, win + (it & 1) * kWinStride, w_s + pb * kKH * kKH * N * 128,
                                pa, pb, base);
      if (pb == kPar - 1) {  // the warp is done with the window
        __syncwarp();
        if (lane == 0) mbar_arrive(&bars[3 + (it & 1)]);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        conv_tile_store<N, UP>(a, acc[mt], bv, stg, t / tiles_img, (r / a.tiles_x) * kTile + rows[mt],
                               (r % a.tiles_x) * kTile, pa, pb);
    }
  }
}

}  // namespace esr
