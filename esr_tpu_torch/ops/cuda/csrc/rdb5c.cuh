// One whole ResidualDenseBlock5C forward per launch, fused in shared memory.
//
// Replaces: esr_tpu/ops/pallas/rdb_conv.py:fused_rdb5c and
// esr_tpu/ops/pallas/rdb_conv.py:fused_rdb5c_tiled (the same function over a
// 2-D grid of halo tiles; on this card that grid is the launch geometry).
//
//   x_k = lrelu_0.2(conv3x3(concat(x, x_1..x_{k-1})) + b_k),  k = 1..4
//   x_5 = conv3x3(concat(x, x_1..x_4)) + b_5
//   out = x + 0.2 * x_5
//
// SAME zero padding applies to every conv at the IMAGE edge, so every
// intermediate is zeroed outside the image before the next conv reads it.
//
// What bounds it: at the flagship shape (nf 64, gc 32, B16 x 128 x 128) one
// launch does 2 * 239,616 MAC/px = 125.6 GFLOP against ~67 MB of activation
// in and out, ~1,900 FLOP per byte: far above the card's ~295 FLOP/byte
// balance point, so it is bound by operations, never by device memory.
// Inside an SM the scarce things are shared memory and its read rate: the
// 16 x 16 tile's window and intermediates (196 KB) leave 30 KB beside them,
// and with the pixels as M an RS wgmma of N = 32 (convs 1-4) needs 2 KB of A
// by ldmatrix plus 1 KB of B per 32K MACs (conv 5, N = 64: 4 KB per 64K):
// about 7.2 MB of shared-memory reads per tile. Measured on an H100, this
// ldmatrix + wgmma pattern sustains about 80 B/clk of them (a microbenchmark
// of the same loop: 420-440 TFLOP/s at N = 32, 580-640 at N = 64, against
// 968 with A already in registers), so the kernel is bound by that read
// rate, at about 4.4x the operations bound (PERF.md).
//
// Design. Each block owns one strip x wtile output tile of one image and
// holds the (strip + 10) x (wtile + 10) x nf input window (halo margin 5, one
// pixel per conv). x_1..x_4 are computed on shrinking windows ((strip + 10 -
// 2k) x (wtile + 10 - 2k)) and stay in shared memory in the input dtype, so
// no intermediate or concat ever reaches device memory; only the halo is
// recomputed (1.34x the FLOPs at 16 x 16). The dense concat is never built:
// each earlier feature adds its own slice of the weight's cin axis. Two
// kernels, three routes:
//  - rdb5c_tc_kernel (bf16, the main path; nf 64, gc 32, 16 x 16 tiles fixed
//    at compile time): persistent blocks of a producer warpgroup (one thread
//    works; its registers go to the consumers) and two consumer
//    warpgroups. The producer brings each tile's 26 x 26 x 64 window
//    with one TMA box (zero fill outside the image = the SAME padding of x)
//    and streams the RDB's weights (479 KB, more than a block can hold)
//    through a ring of three 8 KB shared-memory slots, one bulk copy per
//    stage, in exactly the order the consumers read them: every weight byte
//    reaches an SM once per tile, and no k-loop reads global memory. The
//    consumers run each conv as an implicit GEMM on the tensor cores: RS
//    wgmma, the pixels as M (A by ldmatrix from the swizzled windows shifted
//    by the tap), the whole cout as N (m64n32k16, conv 5 m64n64k16), B from
//    the ring slot through a descriptor. A warpgroup holds all its 64-pixel
//    M-tiles of a conv in registers, so each weight stage is read once per
//    warpgroup. A named barrier over the consumer threads separates conv k
//    from conv k + 1; the producer runs ahead across it.
//  - rdb5c_kernel<T>, SIMT FMAs over planar windows, any tile, weights from
//    L2, f32 accumulation: T = float for exact comparisons, and T = bf16 for
//    the widths the tensor-core kernel does not take (the x window and
//    x_1..x_4 kept in bf16, each x_k rounded to bf16 as the plain version
//    rounds it). nf and gc are multiples of 8 (kCO): rdb_conv.py zero-pads
//    other widths in the weight layout (zero weights and bias give x_k = 0
//    in the padded channels). At nf 16, gc 8 a launch does ~18 FLOP per
//    byte of activation: bound by operations on the SIMT units (67 TFLOP/s
//    f32), not by memory.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace esr {

template <typename T>
struct RdbArgs {
  const T* x;         // (n, h, w, nf) NHWC
  T* out;             // (n, h, w, nf) NHWC
  const T* wt[5];     // conv k: [9][cin_k][cout_k], K = 9 * (nf + (k-1) gc) tap-major
  const float* b[5];  // conv k bias: [cout_k]
  int n, h, w, nf, gc, strip, wtile;
};

// Shared-memory bytes one block of the f32 kernel needs.
inline size_t rdb5c_smem_bytes(int nf, int gc, int strip, int wtile, size_t elem) {
  size_t n = (size_t)nf * (strip + 10) * (wtile + 10);
  for (int k = 1; k < 5; ++k) n += (size_t)gc * (strip + 10 - 2 * k) * (wtile + 10 - 2 * k);
  return n * elem;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) rdb5c_kernel(const RdbArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // feature k lives on a (fh[k] x fw[k]) grid whose origin is k pixels inside
  // the input window's origin
  T* feat[5];
  int fh[5], fw[5], fc[5];
  size_t off = 0;
  for (int k = 0; k < 5; ++k) {
    fh[k] = a.strip + 10 - 2 * k;
    fw[k] = a.wtile + 10 - 2 * k;
    fc[k] = k == 0 ? a.nf : a.gc;
    feat[k] = reinterpret_cast<T*>(smem_raw) + off;
    off += (size_t)fc[k] * fh[k] * fw[k];
  }
  const int n = blockIdx.z, y0 = blockIdx.y * a.strip, x0 = blockIdx.x * a.wtile;
  load_window(feat[0], a.x, n, a.h, a.w, a.nf, y0 - 5, x0 - 5, fh[0], fw[0]);
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  for (int k = 1; k <= 5; ++k) {
    const int oh = k < 5 ? fh[k] : a.strip, ow = k < 5 ? fw[k] : a.wtile;
    const int cout = k < 5 ? a.gc : a.nf, cin_total = a.nf + (k - 1) * a.gc;
    const int npx = oh * ow, n_pb = (npx + kPixBlock - 1) / kPixBlock, n_cg = cout / kCO;
    const T* wk = a.wt[k - 1];
    const float* bk = a.b[k - 1];
    // a warp item: kPixBlock output pixels x kCO channels (warp-uniform)
    for (int item = warp; item < n_pb * n_cg; item += nwarps) {
      const int pb = item % n_pb, cg = item / n_pb;
      int q[kPX], pr[kPX], pc[kPX];
      bool ok[kPX];
#pragma unroll
      for (int p = 0; p < kPX; ++p) {
        q[p] = pb * kPixBlock + lane + 32 * p;
        ok[p] = q[p] < npx;
        const int qq = ok[p] ? q[p] : 0;
        pr[p] = qq / ow;
        pc[p] = qq % ow;
      }
      float acc[kPX][kCO];
#pragma unroll
      for (int c = 0; c < kCO; ++c) {
        const float bv = bk[cg * kCO + c];
#pragma unroll
        for (int p = 0; p < kPX; ++p) acc[p][c] = bv;
      }
      int cin_off = 0;
      for (int j = 0; j < k; ++j) {
        // output pixel (r, c) of conv k sits at window (r + k, c + k); its
        // first tap reads window (r + k - 1, c + k - 1) = feature j's
        // (r + s, c + s)
        const int s = k - 1 - j;
        int base[kPX];
#pragma unroll
        for (int p = 0; p < kPX; ++p) base[p] = (pr[p] + s) * fw[j] + pc[p] + s;
        accumulate<T>(acc, feat[j], fh[j] * fw[j], fw[j], base, fc[j], 3, 3,
                      wk + (size_t)cin_off * cout + cg * kCO, cin_total * cout, cout);
        cin_off += fc[j];
      }
      if (k < 5) {
#pragma unroll
        for (int p = 0; p < kPX; ++p) {
          if (!ok[p]) continue;
          const int gy = y0 - 5 + k + pr[p], gx = x0 - 5 + k + pc[p];
          const bool inside = gy >= 0 && gy < a.h && gx >= 0 && gx < a.w;
#pragma unroll
          for (int c = 0; c < kCO; ++c) {
            const float v = inside ? lrelu(acc[p][c]) : 0.f;
            feat[k][(cg * kCO + c) * npx + q[p]] = from_float<T>(v);
          }
        }
      } else {
        const int plane0 = fh[0] * fw[0];
#pragma unroll
        for (int p = 0; p < kPX; ++p) {
          const int gy = y0 + pr[p], gx = x0 + pc[p];
          if (!ok[p] || gy >= a.h || gx >= a.w) continue;
          const int xi = (pr[p] + 5) * fw[0] + pc[p] + 5;
          T* o = a.out + (((size_t)n * a.h + gy) * a.w + gx) * a.nf + cg * kCO;
#pragma unroll
          for (int c = 0; c < kCO; ++c) {
            const float xv = to_float(feat[0][(cg * kCO + c) * plane0 + xi]);
            o[c] = from_float<T>(xv + 0.2f * acc[p][c]);
          }
        }
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// rdb5c_tc_kernel: the bf16 main path (see the note at the top).
//
// Shared memory (from a 1024-byte aligned base): the weight ring (3 slots of
// 8 KB), the x window (26 x 26 pixels x 128 bytes, TMA's 128B swizzle =
// swz(p, q, 8)), x_1..x_4 (edge 26 - 2k, 64 bytes a pixel, swz(p, q, 4)),
// eight mbarriers.
//
// The weight image (rdb5c_kernel_weights in rdb_conv.py builds it): for each
// conv k, its K = 9 cin_k values (tap-major, the concat's channel order in a
// tap) cut into 64-deep k-blocks, the last one zero-padded; a k-block is
// cout_k rows of 64 K values, 128B-swizzled: the K-major wgmma B operand of
// its four 16-deep k-steps. The five convs' k-blocks back to back are 59
// stages of 8 KB; stage t is bytes [8192 t, 8192 t + 8192) and goes to ring
// slot t % 3. A 16-deep k-step never straddles a source feature (they are 32
// or 64 channels) and a k-block never straddles a stage.
// ---------------------------------------------------------------------------

constexpr int kRdbTile = 16;                     // output tile edge
constexpr int kRdbWin = kRdbTile + 10;           // x window edge: 26
constexpr int kRdbGroups = 2;                    // consumer warpgroups
constexpr int kRdbConsumers = 128 * kRdbGroups;
constexpr int kRdbThreads = kRdbConsumers + 128;  // the consumers + a producer warpgroup
constexpr uint32_t kRdbStage = 8192;             // bytes per weight stage and ring slot
constexpr int kRdbSlots = 3;

// Feature j (0: x, 1..4: x_j): window edge and 16-byte chunks per pixel.
__host__ __device__ constexpr int rdb_edge(int j) { return kRdbWin - 2 * j; }
__host__ __device__ constexpr int rdb_chunks(int j) { return j == 0 ? 8 : 4; }
// Byte offset of feature j's window (j = 5: the end of the windows).
__host__ __device__ constexpr uint32_t rdb_feat_off(int j) {
  uint32_t off = kRdbSlots * kRdbStage;
  for (int i = 0; i < j; ++i) off += rdb_edge(i) * rdb_edge(i) * rdb_chunks(i) * 16;
  return off;
}
// Conv k (1..5): cin, cout, bytes of a k-block, k-blocks, and the byte offset
// of its first k-block in the weight image (k = 6: the image's size).
__host__ __device__ constexpr int rdb_cin(int k) { return 64 + 32 * (k - 1); }
__host__ __device__ constexpr int rdb_cout(int k) { return k < 5 ? 32 : 64; }
__host__ __device__ constexpr uint32_t rdb_kblock_bytes(int k) { return rdb_cout(k) * 128; }
__host__ __device__ constexpr int rdb_kblocks(int k) { return (9 * rdb_cin(k) + 63) / 64; }
__host__ __device__ constexpr uint32_t rdb_wbase(int k) {
  uint32_t off = 0;
  for (int i = 1; i < k; ++i) off += rdb_kblocks(i) * rdb_kblock_bytes(i);
  return off;
}
// Conv k's output edge (k < 5: x_k's window; 5: the tile) and 64-pixel M-tiles.
__host__ __device__ constexpr int rdb_out_edge(int k) { return k < 5 ? rdb_edge(k) : kRdbTile; }
__host__ __device__ constexpr int rdb_mtiles(int k) {
  return (rdb_out_edge(k) * rdb_out_edge(k) + 63) / 64;
}

constexpr uint32_t kRdbWBytes = rdb_wbase(6);  // 483,328
constexpr int kRdbStages = kRdbWBytes / kRdbStage;  // 59
constexpr uint32_t kRdbXBytes = rdb_feat_off(1) - rdb_feat_off(0);
constexpr uint32_t kRdbBarOff = rdb_feat_off(5);
static_assert(kRdbWBytes % kRdbStage == 0, "the weight image is whole stages");
static_assert(rdb_wbase(5) % kRdbStage == 0, "conv 5's k-blocks fill whole stages");
static_assert(rdb_feat_off(0) % 1024 == 0, "the TMA window is 1024-byte aligned");

inline size_t rdb_tc_smem_bytes() { return 1024 + kRdbBarOff + 8 * 8; }

struct RdbTcArgs {
  const unsigned char* wimg;  // the weight image, kRdbWBytes
  const float* b[5];          // conv k bias: [cout_k]
  __nv_bfloat16* out;         // (n, h, w, 64) NHWC
  int n, h, w, tiles_x, tiles_y, n_tiles;
};

// A consumer warpgroup's view of the weight ring.
struct RdbRing {
  uint32_t slots;   // shared address of slot 0
  uint64_t* full;   // full[s]: slot s holds its stage
  uint64_t* empty;  // empty[s]: the consumer warps are done with slot s
  int base;         // global stage index of this tile's stage 0
  int cur;          // global stage of the last k-step issued; -1: none since the last release
};

__device__ __forceinline__ void rdb_release(uint64_t* empty, int stage) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[stage % kRdbSlots]);
}

// Conv K of one tile for M-tiles g, g + G, .. (MT of them; G = kRdbGroups) of warpgroup g:
// the implicit GEMM, then its epilogue (K < 5: bias, lrelu, zero outside the
// image, bf16 into x_K's window; K = 5: x + 0.2 (acc + b5) to global).
template <int K, int MT>
__device__ __forceinline__ void rdb_tc_conv(const RdbTcArgs& a, unsigned char* sm, RdbRing& ring,
                                            int g, int n, int y0, int x0) {
  constexpr int N = rdb_cout(K), KS = rdb_cin(K) / 16, O = rdb_out_edge(K), NPX = O * O;
  constexpr uint32_t KB = rdb_kblock_bytes(K), WB = rdb_wbase(K);
  // the lane through a volatile read: the values below are the same in every
  // tile, and hoisted out of the tile loop (for all five convs) they would
  // crowd out the registers the wgmma pipeline needs
  uint32_t lane_v;
  asm volatile("mov.u32 %0, %%laneid;\n" : "=r"(lane_v));
  const int lane = (int)lane_v, w4 = (threadIdx.x >> 5) & 3, half = lane >> 4;
  const uint32_t sm_s = smem_addr(sm);

  // this thread's bias columns: 8 jn + 2 (lane % 4) + e
  float bv[N / 8][2];
#pragma unroll
  for (int jn = 0; jn < N / 8; ++jn) {
#pragma unroll
    for (int e = 0; e < 2; ++e) bv[jn][e] = __ldg(a.b[K - 1] + 8 * jn + 2 * (lane & 3) + e);
  }
  // pix[i][j]: the window pixel of feature j that this lane's A row of M-tile
  // G i + g reads at tap (0, 0). Output pixel (r, c) of conv K reads feature
  // j's (r + s + ty, c + s + tx) at tap (ty, tx), s = K - 1 - j. Rows past
  // the region read pixel 0 and are not stored.
  int pix[MT][K];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    int p = (kRdbGroups * i + g) * 64 + 16 * w4 + (lane & 15);
    p = p < NPX ? p : 0;
    const int r = p / O, c = p - r * O;
#pragma unroll
    for (int j = 0; j < K; ++j) pix[i][j] = (r + K - 1 - j) * rdb_edge(j) + c + K - 1 - j;
  }
  float acc[MT][N / 2];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int v = 0; v < N / 2; ++v) acc[i][v] = 0.f;
  }
  // A is double-buffered in registers by k-step: a step's ldmatrix runs
  // while the previous step's wgmma is on the tensor cores (KS is even)
  uint32_t af[2][MT][4] = {};
#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const int ty = tap / 3, tx = tap - 3 * ty;
#pragma unroll
    for (int cs = 0; cs < KS; ++cs) {
      // k-step cs of the tap: x's channels 16 cs .. (cs < 4), else x_j's
      const int j = cs < 4 ? 0 : 1 + (cs - 4) / 2;
      const int q = (cs < 4 ? 2 * cs : 2 * ((cs - 4) % 2)) + half;
      const int buf = cs & 1;
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int p = pix[i][j] + ty * rdb_edge(j) + tx;
        const int chunk = j == 0 ? p * 8 + (q ^ (p & 7)) : p * 4 + (q ^ ((p >> 1) & 3));
        ldmatrix_x4(af[buf][i], sm_s + rdb_feat_off(j) + chunk * 16);
      }
      const int s = tap * KS + cs;
      const uint32_t kb = WB + (uint32_t)(s >> 2) * KB;  // this k-step's k-block in the image
      const int st = ring.base + (int)(kb / kRdbStage);
      const bool fresh = st != ring.cur;
      if (fresh) mbar_wait(&ring.full[st % kRdbSlots], (st / kRdbSlots) & 1);
      const uint64_t desc =
          wgmma_desc_sw128(ring.slots + (st % kRdbSlots) * kRdbStage + kb % kRdbStage + (s & 3) * 32);
      wgmma_fence();
#pragma unroll
      for (int i = 0; i < MT; ++i) Wgmma<N>::mma(acc[i], af[buf][i], desc);
      wgmma_commit();
      wgmma_wait<1>();  // the previous k-step's wgmmas are done
#pragma unroll
      for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int r = 0; r < 4; ++r) reg_fence(af[buf ^ 1][i][r]);
      }
      if (fresh) {  // so the stage before this one has been read for the last time
        if (ring.cur >= 0) rdb_release(ring.empty, ring.cur);
        ring.cur = st;
      }
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int v = 0; v < N / 2; ++v) reg_fence(acc[i][v]);
  }

  // accumulator acc[i][4 jn + 2 hf + e]: pixel (G i + g) * 64 + 16 w4 + lane / 4 + 8 hf,
  // channel 8 jn + 2 (lane % 4) + e
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int p = (kRdbGroups * i + g) * 64 + 16 * w4 + (lane >> 2) + 8 * hf;
      if (p >= NPX) continue;
      const int r = p / O, c = p - r * O;
      if constexpr (K < 5) {
        const int gy = y0 - 5 + K + r, gx = x0 - 5 + K + c;
        const bool inside = gy >= 0 && gy < a.h && gx >= 0 && gx < a.w;
        unsigned char* row = sm + rdb_feat_off(K) + p * 64 + 4 * (lane & 3);
#pragma unroll
        for (int jn = 0; jn < N / 8; ++jn) {
          const float v0 = inside ? lrelu(acc[i][4 * jn + 2 * hf] + bv[jn][0]) : 0.f;
          const float v1 = inside ? lrelu(acc[i][4 * jn + 2 * hf + 1] + bv[jn][1]) : 0.f;
          *reinterpret_cast<uint32_t*>(row + ((jn ^ ((p >> 1) & 3)) << 4)) = pack_bf16x2(v0, v1);
        }
      } else {
        const int gy = y0 + r, gx = x0 + c;
        if (gy >= a.h || gx >= a.w) continue;
        const int xw = (r + 5) * kRdbWin + c + 5;  // the same pixel in x's window
        const unsigned char* xrow = sm + rdb_feat_off(0) + xw * 128 + 4 * (lane & 3);
        uint32_t* o = reinterpret_cast<uint32_t*>(a.out + (((size_t)n * a.h + gy) * a.w + gx) * 64 +
                                                  2 * (lane & 3));
#pragma unroll
        for (int jn = 0; jn < N / 8; ++jn) {
          const uint32_t xv = *reinterpret_cast<const uint32_t*>(xrow + ((jn ^ (xw & 7)) << 4));
          const float v0 = __uint_as_float(xv << 16) + 0.2f * (acc[i][4 * jn + 2 * hf] + bv[jn][0]);
          const float v1 =
              __uint_as_float(xv & 0xffff0000u) + 0.2f * (acc[i][4 * jn + 2 * hf + 1] + bv[jn][1]);
          o[4 * jn] = pack_bf16x2(v0, v1);
        }
      }
    }
  }
}

// Conv K for warpgroup g: M-tiles g, g + G, ..; the first (M-tiles % G)
// groups take one more.
template <int K>
__device__ __forceinline__ void rdb_tc_conv_group(const RdbTcArgs& a, unsigned char* sm,
                                                  RdbRing& ring, int g, int n, int y0, int x0) {
  constexpr int LO = rdb_mtiles(K) / kRdbGroups, REM = rdb_mtiles(K) % kRdbGroups;
  static_assert(LO > 0, "every consumer warpgroup has an M-tile");
  if (REM > 0 && g < REM) {
    rdb_tc_conv<K, LO + (REM > 0)>(a, sm, ring, g, n, y0, x0);
  } else {
    rdb_tc_conv<K, LO>(a, sm, ring, g, n, y0, x0);
  }
  named_barrier(1, kRdbConsumers);  // x_K is complete before conv K + 1 reads it
}

// xmap: the input's tensor map, boxes of 26 x 26 pixels x 64 channels.
__global__ void __launch_bounds__(kRdbThreads, 1)
    rdb5c_tc_kernel(const __grid_constant__ CUtensorMap xmap, const RdbTcArgs a) {
  extern __shared__ __align__(1024) unsigned char rdb_smem[];
  unsigned char* sm = rdb_smem + ((1024 - (smem_addr(rdb_smem) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + kRdbBarOff);
  // bars[0..2]: ring slot full; [3..5]: ring slot empty; [6]: x window full;
  // [7]: the consumer warps are done with the x window
  uint64_t *full = bars, *empty = bars + 3, *xfull = bars + 6, *xfree = bars + 7;

  // the warp index through a shuffle, so that the compiler knows it is the
  // same for the whole warp: wgmma in a path it thinks divergent is serialized
  const int tid = threadIdx.x, lane = tid & 31, warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int tiles_img = a.tiles_x * a.tiles_y;
  if (tid == 0) {
    for (int i = 0; i < kRdbSlots; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kRdbConsumers / 32);
    }
    mbar_init(xfull, 1);
    mbar_init(xfree, kRdbConsumers / 32);
    mbar_fence_init();
  }
  __syncthreads();

  // 384 threads get 168 registers each. A consumer needs more (conv 1: 5
  // M-tiles x 16 accumulators and two A buffers), or ptxas serializes the
  // wgmmas or spills; the producer warpgroup hands its share over (24 + 2 x
  // 240 = 3 x 168).
  if (warp >= kRdbConsumers / 32) {  // the producer warpgroup: one thread works
    setmaxnreg_dec<24>();
    if (warp == kRdbConsumers / 32 && lane == 0) {
      prefetch_tensor_map(&xmap);
      int st = 0;  // global stage index
      int it = 0;
      for (int t = blockIdx.x; t < a.n_tiles; t += gridDim.x, ++it) {
        const int n = t / tiles_img, r = t % tiles_img;
        const int y0 = (r / a.tiles_x) * kRdbTile, x0 = (r % a.tiles_x) * kRdbTile;
        for (int s = 0; s < kRdbStages; ++s, ++st) {
          // the tile's window: at once for the first tile; later, once the
          // previous tile's stages 0..2 are in flight and its consumers are
          // done with x (its stage 3 waits on this tile's conv 1)
          if (s == (it == 0 ? 0 : kRdbSlots)) {
            if (it > 0) mbar_wait(xfree, (it - 1) & 1);
            mbar_expect_tx(xfull, kRdbXBytes);
            tma_load_4d(sm + rdb_feat_off(0), &xmap, 0, x0 - 5, y0 - 5, n, xfull);
          }
          const int slot = st % kRdbSlots;
          if (st >= kRdbSlots) mbar_wait(&empty[slot], (st / kRdbSlots - 1) & 1);
          mbar_expect_tx(&full[slot], kRdbStage);
          bulk_copy_g2s(sm + slot * kRdbStage, a.wimg + (size_t)s * kRdbStage, kRdbStage, &full[slot]);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<240>();
  const int g = warp >> 2;
  RdbRing ring{smem_addr(sm), full, empty, 0, -1};
  int it = 0;
  for (int t = blockIdx.x; t < a.n_tiles; t += gridDim.x, ++it) {
    const int n = t / tiles_img, r = t % tiles_img;
    const int y0 = (r / a.tiles_x) * kRdbTile, x0 = (r % a.tiles_x) * kRdbTile;
    ring.base = it * kRdbStages;
    mbar_wait(xfull, it & 1);
    rdb_tc_conv_group<1>(a, sm, ring, g, n, y0, x0);
    rdb_tc_conv_group<2>(a, sm, ring, g, n, y0, x0);
    rdb_tc_conv_group<3>(a, sm, ring, g, n, y0, x0);
    rdb_tc_conv_group<4>(a, sm, ring, g, n, y0, x0);
    rdb_tc_conv_group<5>(a, sm, ring, g, n, y0, x0);
    // conv 5's wgmmas are complete and its epilogue has read x: release the
    // tile's last stage and the window (the barrier above also keeps the
    // next tile's x_1 writes behind this tile's conv 5 reads)
    rdb_release(empty, ring.cur);
    ring.cur = -1;
    __syncwarp();
    if (lane == 0) mbar_arrive(xfree);
  }
}

}  // namespace esr
