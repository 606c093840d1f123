// The f32 route of the conv and RDB kernels: one implicit-GEMM convolution
// on the FP32 units, conv_f32_kernel, for every f32 conv of the port.
//
// Replaces, in f32: esr_tpu/ops/pallas/kpack_conv.py:kpack_conv3x3 (SAME 3x3
// conv, NHWC x HWIO, K = 9 * Cin, f32 accumulation), its 2x2 parity mode for
// esr_tpu/ops/fused.py:upsample2x_conv3x3, and, as five launches,
// esr_tpu/ops/pallas/rdb_conv.py:fused_rdb5c / fused_rdb5c_tiled (rdb_conv.py
// chains them through one scratch tensor).
//
//   3x3:  out[n, i, j, o]        = b[o] + sum_{ty,tx,c} x[n, i+ty-1, j+tx-1, c] w[ty*3+tx, c, o]
//   2x2:  out[n, 2i+a, 2j+b', o] = b[o] + sum_{ty,tx,c} x[n, i+ty-1+a, j+tx-1+b', c] w[q, ty*2+tx, c, o]
//   then optionally lrelu_0.2, then optionally out = res + res_scale * out;
//   x is two NHWC sources concatenated along channels (xa's cin_a, then xb's
//   cin_b), zero outside the image; out is written at channel out_c0 of
//   pixels out_ld channels apart.
//
// The route exists to be exact to float error (the reference runs it at
// Precision.HIGHEST), so it is full f32 FMAs: no TF32, no tensor cores.
//
// What bounds it: a 64 -> 64 conv does 2 * 9 * 64 FLOP per output channel
// and pixel against 4 * (64 + 64) bytes per pixel, ~96 FLOP per byte, where
// the FP32 units' balance point (67 TFLOP/s over 3.35 TB/s) is ~20: bound by
// operations. Inside an SM the limits are the FMA issue rate (128 a clock)
// and the shared-memory reads that feed it. conv_first (Cin 4) and conv_last
// (Cout 3) are bound by bytes.
//
// Design (M = output pixels, N = a slice of Cout, K = taps x Cin):
// - A block owns a 16 x 16 output tile (2x2 mode: an 8 x 8 input tile and its
//   four parities, 16 x 16 output pixels) and one slice of N output channels:
//   N = 64, or N = 8 / 16 / 32 for a Cout that small (conv_last's 3, the RDB's
//   gc), with 4 N threads. Cout above 64 takes ceil(Cout / 64) slices.
// - K is walked in chunks of kF32Kc = 8 input channels. Each chunk's window
//   (the tile + 1-pixel halo, planar [channel][row][col]) and its weights
//   ([parity][tap][channel][N]) are copied into shared memory by cp.async
//   through a ring of f32_stages(N) stages: the copies of the next chunks
//   run under the FMAs of this one, and no k-loop reads global memory. The zero fill of
//   cp.async (source size 0) is the SAME padding, the ragged edge and the
//   chunk's channels beyond Cin. Any Cin and any Cout: shared memory does not
//   grow with either.
// - A thread owns 8 consecutive output pixels of one tile row (of one parity)
//   x 8 output channels (4 g .. 4 g + 3 and N/2 + 4 g ..: each 16-byte weight
//   read of a warp is one contiguous 128-byte line), 64 f32 accumulators. Per
//   (channel, tap row) it reads 10 window pixels as two 16-byte vectors and
//   one 8-byte vector and shifts them in registers for the taps of the row
//   (and for the 2x2 mode's column parity, a template argument); per tap two
//   16-byte weight vectors and 64 FMAs: 9 shared loads per 192 FMAs in the
//   3x3 mode. Window rows are padded so that the vectors are aligned and a
//   warp's reads free of bank conflicts.
// - The 2x2 mode computes the four parities from one window: a warp holds
//   one parity (its weights are then one broadcast line).
// - Epilogue: bias, lrelu, the residual, masked ragged stores (16-byte stores
//   where the channel offsets and strides allow them).
#pragma once

#include "common.cuh"

namespace esr {

constexpr int kF32Kc = 8;  // input channels per K chunk
constexpr int kF32Px = 8;  // output pixels per thread, consecutive in a row

// Stages of the cp.async ring: three for N 64 (two 256-thread blocks an SM);
// two for the narrower instances, whose smaller blocks need more blocks an SM
// to hide their latencies (N 32: five, N 8: eight; measured against three
// stages on an H100: the f32 RDB's N 32 convs 5% faster, conv_last 20%).
__host__ __device__ constexpr int f32_stages(int n_width) { return n_width <= 32 ? 2 : 3; }

struct ConvF32Args {
  const float* xa;  // (n, h, w, lda) NHWC: channels [0, cin_a) of the input
  const float* xb;  // (n, h, w, ldb) NHWC: channels [cin_a, cin_a + cin_b), or unused
  int lda, ldb, cin_a, cin_b;
  const float* wt;    // [slice][chunk][parity][tap][kF32Kc][N], zero-padded
  const float* bias;  // [slices * N] or nullptr
  float* out;         // (n, h, w, out_ld), or (n, 2h, 2w, out_ld) in 2x2 mode
  int out_ld, out_c0;
  const float* res;  // 3x3 mode: (n, h, w, res_ld), out = res + res_scale * out; or nullptr
  int res_ld;
  float res_scale;
  int n, h, w, cout, act;
  int slices, chunks, tiles_x, tiles_y;
  int vec;  // out (and res) take 16-byte stores (loads) at every 4th channel
};

// Tile geometry of a mode: output tile TH x TW input pixels, KH x KH taps,
// PAR parities; the window is (TH + 2) x (TW + 2) pixels, rows WS floats
// apart (a multiple of 4, for the vector reads), channel planes PS floats
// apart (PS mod 32 = 12 or 28: the 8 channels of the copy's 8-lane groups
// land in different banks).
template <bool UP>
struct F32Geo {
  static constexpr int TH = UP ? 8 : 16, TW = UP ? 8 : 16, KH = UP ? 2 : 3, PAR = UP ? 4 : 1;
  static constexpr int WR = TH + 2, WC = TW + 2, WS = (WC + 3) / 4 * 4, PS = WR * WS + 4;
  static constexpr int TAPS = KH * KH;
  static constexpr int WIN_F = kF32Kc * PS;  // floats of a stage's window
};

inline size_t conv_f32_smem_bytes(int n_width, bool up) {
  const int win = up ? F32Geo<true>::WIN_F : F32Geo<false>::WIN_F;
  const int wf = (up ? 4 * 4 : 9) * kF32Kc * n_width;
  return (size_t)f32_stages(n_width) * (win + wf) * sizeof(float);
}

// acc += this chunk's products. win: the stage's window; wq: its weights at
// this thread's parity and first channel; wrow: the window row of the
// thread's first tap row; c0: the window column of its first pixel; PB: the
// 2x2 mode's column parity (the window column shift of the taps).
template <int N, bool UP, int PB>
__device__ __forceinline__ void conv_f32_chunk(float (&acc)[kF32Px][8], const float* win,
                                               const float* wq, int wrow, int c0) {
  using G = F32Geo<UP>;
  // one channel a step: unrolled further, the 2x2 instances spill (and the
  // 3x3 ones measured no faster)
#pragma unroll 1
  for (int ci = 0; ci < kF32Kc; ++ci) {
#pragma unroll
    for (int ty = 0; ty < G::KH; ++ty) {
      // window columns c0 .. c0 + 9: two 16-byte reads and one 8-byte read
      const float* ap = win + ci * G::PS + (wrow + ty) * G::WS + c0;
      const float4 v0 = *reinterpret_cast<const float4*>(ap), v1 = *reinterpret_cast<const float4*>(ap + 4);
      const float2 v2 = *reinterpret_cast<const float2*>(ap + 8);
      const float av[10] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w, v2.x, v2.y};
#pragma unroll
      for (int tx = 0; tx < G::KH; ++tx) {
        const float* wp = wq + ((ty * G::KH + tx) * kF32Kc + ci) * N;
        const float4 b0 = *reinterpret_cast<const float4*>(wp);
        const float4 b1 = *reinterpret_cast<const float4*>(wp + N / 2);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int p = 0; p < kF32Px; ++p) {
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[p][j] = fmaf(av[p + tx + PB], bv[j], acc[p][j]);
        }
      }
    }
  }
}

template <int N, bool UP>
__global__ void __launch_bounds__(4 * N, 128 / N) conv_f32_kernel(const ConvF32Args a) {
  using G = F32Geo<UP>;
  constexpr int kThr = 4 * N, kCG = N / 8, kStages = f32_stages(N);
  constexpr int kWF = G::PAR * G::TAPS * kF32Kc * N, kStageF = G::WIN_F + kWF;  // weights, stage
  extern __shared__ __align__(16) float f32_smem[];

  const int tid = threadIdx.x, g = tid % kCG, pg = tid / kCG;  // channel group, pixel group
  // pixel group -> (parity, tile row, first column): 3x3: rows of two
  // 8-pixel halves; 2x2: a warp's groups share a parity (N = 64: four rows)
  const int row = UP ? (pg & 7) : (pg >> 1), c0 = UP ? 0 : (pg & 1) * kF32Px;
  const int q = UP ? pg >> 3 : 0, pa = q >> 1, pb = q & 1;
  const int slice = blockIdx.x % a.slices, t = blockIdx.x / a.slices;
  const int tiles_img = a.tiles_x * a.tiles_y, n = t / tiles_img, r = t % tiles_img;
  const int y0 = (r / a.tiles_x) * G::TH, x0 = (r % a.tiles_x) * G::TW;
  const int cin = a.cin_a + a.cin_b;
  const float* wsrc = a.wt + (size_t)slice * a.chunks * kWF;

  // chunk c's weights and window into stage s (cp.async, not waited for)
  auto load = [&](int c, int s) {
    float* win = f32_smem + s * kStageF;
    float* wsm = win + G::WIN_F;
    const float* wc = wsrc + (size_t)c * kWF;
    for (int i = tid * 4; i < kWF; i += kThr * 4) cp_async16(wsm + i, wc + i);
    // not unrolled: hoisting the chunk-invariant index math of every element
    // out of the chunk loop would take registers the FMA loop needs
#pragma unroll 1
    for (int e = tid; e < kF32Kc * G::WR * G::WC; e += kThr) {
      const int ch = e % kF32Kc, p = e / kF32Kc, py = p / G::WC, px = p - py * G::WC;
      const int gy = y0 - 1 + py, gx = x0 - 1 + px, ci = c * kF32Kc + ch;
      const float* src = a.xa;
      int bytes = 0;
      if (gy >= 0 && gy < a.h && gx >= 0 && gx < a.w && ci < cin) {
        const size_t pix = ((size_t)n * a.h + gy) * a.w + gx;
        src = ci < a.cin_a ? a.xa + pix * a.lda + ci : a.xb + pix * a.ldb + (ci - a.cin_a);
        bytes = 4;
      }
      cp_async4_zfill(win + ch * G::PS + py * G::WS + px, src, bytes);
    }
  };

  float acc[kF32Px][8];
#pragma unroll
  for (int p = 0; p < kF32Px; ++p) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[p][j] = 0.f;
  }
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < a.chunks) load(s, s);
    cp_async_commit();
  }
  for (int c = 0; c < a.chunks; ++c) {
    cp_async_wait<kStages - 2>();  // chunk c has landed (this thread's copies)
    __syncthreads();               // ... everyone's; and chunk c - 1 is consumed
    if (c + kStages - 1 < a.chunks) load(c + kStages - 1, (c + kStages - 1) % kStages);
    cp_async_commit();
    const float* win = f32_smem + (c % kStages) * kStageF;
    const float* wq = win + G::WIN_F + q * G::TAPS * kF32Kc * N + 4 * g;
    if (UP && pb)  // warp-uniform: a warp holds one parity
      conv_f32_chunk<N, UP, 1>(acc, win, wq, row + pa, c0);
    else
      conv_f32_chunk<N, UP, 0>(acc, win, wq, row + pa, c0);
  }
  cp_async_wait<0>();

  // epilogue: this thread's channels co0 + {0..3} and co0 + N/2 + {0..3}
  const int co0 = slice * N + 4 * g;
  float bv[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) bv[j] = a.bias != nullptr ? a.bias[co0 + (j / 4) * (N / 2) + j % 4] : 0.f;
  const int gy = y0 + row;
  if (gy >= a.h) return;
#pragma unroll
  for (int p = 0; p < kF32Px; ++p) {
    const int gx = x0 + c0 + p;
    if (gx >= a.w) break;
    const size_t pix = UP ? ((size_t)n * 2 * a.h + 2 * gy + pa) * (2 * a.w) + 2 * gx + pb
                          : ((size_t)n * a.h + gy) * a.w + gx;
    float* o = a.out + pix * a.out_ld + a.out_c0;
    const float* rp = a.res != nullptr ? a.res + pix * a.res_ld : nullptr;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int co = co0 + hf * (N / 2);
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = acc[p][4 * hf + j] + bv[4 * hf + j];
        if (a.act) v[j] = lrelu(v[j]);
      }
      if (a.vec && co + 4 <= a.cout) {
        if (rp != nullptr) {
          const float4 rv = *reinterpret_cast<const float4*>(rp + co);
          v[0] = rv.x + a.res_scale * v[0]; v[1] = rv.y + a.res_scale * v[1];
          v[2] = rv.z + a.res_scale * v[2]; v[3] = rv.w + a.res_scale * v[3];
        }
        *reinterpret_cast<float4*>(o + co) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (co + j < a.cout) o[co + j] = rp != nullptr ? rp[co + j] + a.res_scale * v[j] : v[j];
        }
      }
    }
  }
}

}  // namespace esr
