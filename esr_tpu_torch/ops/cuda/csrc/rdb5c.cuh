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
// balance point, so it is bound by operations, never by device memory (at
// nf 16, gc 8 the same count is ~470 FLOP per byte, still above it).
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
// Design. rdb5c_tc_kernel<NF, GC, TILE> runs every bf16 RDB (an f32 RDB is
// five launches of conv_f32.cuh's kernel, chained by rdb_conv.py through a
// scratch tensor: in f32 the fused tile's window and x_1..x_4 do not fit
// shared memory at a tile whose halo is cheap). Each block owns TILE x TILE
// output tiles of one image and holds the (TILE + 10)^2 x NF input window
// (halo margin 5, one pixel per conv). x_1..x_4 are computed on shrinking
// windows ((TILE + 10 - 2k)^2) and stay in shared memory in bf16, so no
// intermediate or concat ever reaches device memory; only the halo is
// recomputed (1.34x the FLOPs at 16 x 16). The dense concat is never built:
// each earlier feature adds its own slice of the weight's cin axis.
// Persistent blocks of a producer warpgroup (one thread works; its registers
// go to the consumers) and two consumer warpgroups. The producer brings each
// tile's window with one TMA box per 64 channels (zero fill outside the image
// = the SAME padding of x) and streams the RDB's weights (479 KB at 64 / 32,
// more than a block can hold) through a ring of three shared-memory slots,
// one bulk copy per stage, in exactly the order the consumers read them:
// every weight byte reaches an SM once per tile, and no k-loop reads global
// memory. The consumers run each conv as an implicit GEMM on the tensor
// cores: RS wgmma, the pixels as M (A by ldmatrix from the swizzled windows
// shifted by the tap), the whole cout as N, B from the ring slot through a
// descriptor. A warpgroup holds all its 64-pixel M-tiles of a conv in
// registers, so each weight stage is read once per warpgroup; a conv of one
// M-tile (conv 5 at an 8 x 8 tile) is split by cout between the warpgroups
// instead. A named barrier over the consumer threads separates conv k from
// conv k + 1; the producer runs ahead across it.
//
// Instances (rdb_conv.py pads every other bf16 width to the smallest that
// holds it: zero weights, bias and input channels give x_k = lrelu(0) = 0 in
// the padded channels, so the function is the same). What bounds each on
// this card is the shared memory of its windows beside the ring:
//  - <64, 32, 16>, the main path: 196 KB of windows + 24 KB of ring;
//  - <32, 16, 16>, nf <= 32 and gc <= 16 (the JAX package's test and dry-run
//    widths): 98 KB + 24 KB. A 16 x 16 tile keeps the halo cheap; narrower
//    widths make the tile's tensor-core work small beside its fixed costs;
//  - <128, 64, 8>, nf <= 128 and gc <= 64: 168 KB + 48 KB (16 KB stages, the
//    size of one conv-5 k-block). A 16 x 16 tile's windows would take 392 KB;
//    at 8 x 8 the halo is 3.4x the tile's own work.
// And one instance for small grids, <64, 32, 8> (86 KB of windows + 24 KB of
// ring). A launch runs at most one block a SM, so a grid of fewer 16 x 16
// tiles than SMs (B1 x 64^2: 16 tiles for 132 SMs) takes a whole tile's time
// (~116k clocks) on a few SMs; four times as many 8 x 8 tiles take ~70k each,
// as their convs hold 1-2 M-tiles a warpgroup, where the 16 x 16 tile's hold
// 2-5 (it reads the same weights and shared memory per M-tile). rdb_conv.py
// picks the tile per launch from the grid and the SM count; both read the same
// weight image.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace esr {

constexpr int kRdbGroups = 2;                     // consumer warpgroups
constexpr int kRdbConsumers = 128 * kRdbGroups;
constexpr int kRdbThreads = kRdbConsumers + 128;  // the consumers + a producer warpgroup
constexpr int kRdbSlots = 3;                      // weight ring slots

__host__ __device__ constexpr uint32_t rdb_align(uint32_t v, uint32_t a) { return (v + a - 1) / a * a; }

// A window of C 16-byte chunks a pixel (C = 2, 4 or 8): the XOR key of pixel
// p's chunks, and the chunk index of chunk q of pixel p (common.cuh's
// swz(p, q, C) / 8; C = 8 is TMA's 128B swizzle, C = 4 its 64B one).
template <int C>
__device__ __forceinline__ int rdb_key(int p) {
  static_assert(C == 2 || C == 4 || C == 8, "2, 4 or 8 chunks a pixel");
  return C == 8 ? (p & 7) : (p >> (C == 4 ? 1 : 2)) & (C - 1);
}
template <int C>
__device__ __forceinline__ int rdb_chunk(int p, int q) {
  return p * C + (q ^ rdb_key<C>(p));
}

// ---------------------------------------------------------------------------
// The shape of one instance.
//
// Shared memory (from a 1024-byte aligned base): the weight ring (3 slots of
// kStage bytes), the x window ((TILE + 10)^2 pixels; one 128B-swizzled plane
// per 64 channels, each 1024-byte aligned, as TMA writes it; NF 32: one plane
// of 64-byte pixels with TMA's 64B swizzle), x_1..x_4 (edge TILE + 10 - 2k,
// 2 GC bytes a pixel, chunk q of pixel p at swz(p, q, GC / 8)), eight
// mbarriers.
//
// The weight image (rdb5c_kernel_weights in rdb_conv.py builds it): for each
// conv k, its K = 9 cin_k values (tap-major, the concat's channel order in a
// tap) cut into 64-deep k-blocks, the last one zero-padded; a k-block is
// cout_k rows of 64 K values, 128B-swizzled: the K-major wgmma B operand of
// its four 16-deep k-steps. Each conv's k-blocks start at a multiple of their
// size and the image ends at a whole stage (zero bytes between): stage t is
// bytes [kStage t, kStage (t + 1)) and goes to ring slot t % 3. A 16-deep
// k-step never straddles a source feature (NF and GC are multiples of 16) and
// a k-block never straddles a stage. At <64, 32, 16> no padding is needed:
// 59 stages of 8 KB. The image does not depend on TILE.
// ---------------------------------------------------------------------------

template <int NF, int GC, int TILE>
struct Rdb {
  static_assert((NF == 32 || NF == 64 || NF == 128) && (GC == 16 || GC == 32 || GC == 64), "the wgmma widths");
  static constexpr int kNF = NF, kGC = GC;
  static constexpr int kWin = TILE + 10;           // x window edge
  static constexpr uint32_t kStage = NF * 128 > 8192 ? NF * 128 : 8192;  // bytes per stage and slot
  // the bytes of one 64-channel plane of the x window (1024-byte aligned when
  // NF 128 has two; NF 32: the whole window)
  static constexpr uint32_t kPlane = NF > 64 ? rdb_align(kWin * kWin * 128, 1024) : kWin * kWin * NF * 2;

  // Feature j (0: x, 1..4: x_j): window edge and 16-byte chunks per pixel.
  __host__ __device__ static constexpr int edge(int j) { return kWin - 2 * j; }
  __host__ __device__ static constexpr int chunks(int j) { return j == 0 ? NF / 8 : GC / 8; }
  // Byte offset of feature j's window (j = 5: the end of the windows).
  __host__ __device__ static constexpr uint32_t feat_off(int j) {
    uint32_t off = kRdbSlots * kStage;
    for (int i = 0; i < j; ++i) off += i == 0 ? (NF + 63) / 64 * kPlane : edge(i) * edge(i) * chunks(i) * 16;
    return off;
  }
  // Conv k (1..5): cin, cout, bytes of a k-block, k-blocks, and the byte
  // offset of its first k-block in the weight image (k = 6: the image's size).
  __host__ __device__ static constexpr int cin(int k) { return NF + GC * (k - 1); }
  __host__ __device__ static constexpr int cout(int k) { return k < 5 ? GC : NF; }
  __host__ __device__ static constexpr uint32_t kblock_bytes(int k) { return cout(k) * 128; }
  __host__ __device__ static constexpr int kblocks(int k) { return (9 * cin(k) + 63) / 64; }
  __host__ __device__ static constexpr uint32_t wbase(int k) {
    uint32_t off = 0;
    for (int i = 1; i < k; ++i) off = rdb_align(off + kblocks(i) * kblock_bytes(i), i < 5 ? kblock_bytes(i + 1) : kStage);
    return off;
  }
  // Conv k's output edge (k < 5: x_k's window; 5: the tile) and 64-pixel M-tiles.
  __host__ __device__ static constexpr int out_edge(int k) { return k < 5 ? edge(k) : TILE; }
  __host__ __device__ static constexpr int mtiles(int k) { return (out_edge(k) * out_edge(k) + 63) / 64; }
  // The fewest M-tiles a warpgroup holds of a conv it does not split by cout:
  // at <64, 32, 8> two (convs 3 and 4 have 3 and 2, so one is all padding
  // rows), as ptxas serialises the wgmmas of a warpgroup with one M-tile at N
  // = 32 (C7513), which costs more than the padding (on an H100: 46 against
  // 42 us a tile).
  static constexpr int kMinMT = NF == 64 && TILE == 8 ? 2 : 1;

  static constexpr uint32_t kWBytes = wbase(6);
  static constexpr int kStages = kWBytes / kStage;
  static constexpr uint32_t kXBytes = kWin * kWin * NF * 2;  // what the window's TMA boxes bring
  static constexpr uint32_t kBarOff = feat_off(5);
  static constexpr size_t kSmemBytes = 1024 + kBarOff + 8 * 8;
  static_assert(kWBytes % kStage == 0, "the weight image is whole stages");
  static_assert(kStages > kRdbSlots, "the producer's window schedule needs more stages than slots");
  static_assert(feat_off(0) % 1024 == 0 && (NF <= 64 || kPlane % 1024 == 0), "the TMA planes are 1024-byte aligned");
  static_assert(kSmemBytes <= 232448, "a block's shared memory");

  // Feature j's window: the chunk index, from its start, of chunk q of pixel p
  // (x at NF 128: in the plane of 64 channels that holds it).
  static constexpr int kXC = NF < 64 ? NF / 8 : 8;  // chunks a pixel of an x plane
  __device__ __forceinline__ static int chunk(int j, int p, int q) {
    if (j > 0) return rdb_chunk<GC / 8>(p, q);
    return NF > 64 ? (q >> 3) * (int)(kPlane / 16) + rdb_chunk<8>(p, q & 7) : rdb_chunk<kXC>(p, q);
  }
};

struct RdbTcArgs {
  const unsigned char* wimg;  // the weight image, Rdb::kWBytes
  const float* b[5];          // conv k bias: [cout_k]
  __nv_bfloat16* out;         // (n, h, w, NF) NHWC
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

// Conv K of one tile for warpgroup g: M-tiles g, g + G, .. (MT of them; G =
// kRdbGroups) at all cout_K channels, or (SPLIT) M-tile 0 at channels
// [g N, (g + 1) N) of cout_K = G N. The implicit GEMM, then its epilogue (K <
// 5: bias, lrelu, zero outside the image, bf16 into x_K's window; K = 5: x +
// 0.2 (acc + b5) to global, at the warpgroup's channels from n0).
template <class R, int K, int MT, bool SPLIT>
__device__ __forceinline__ void rdb_tc_conv(const RdbTcArgs& a, unsigned char* sm, RdbRing& ring,
                                            int g, int n, int y0, int x0) {
  constexpr int N = SPLIT ? R::cout(K) / kRdbGroups : R::cout(K), KS = R::cin(K) / 16, O = R::out_edge(K),
                NPX = O * O, XS = R::chunks(0) / 2, JS = R::chunks(1) / 2;  // k-steps of x and of an x_j
  constexpr uint32_t KB = R::kblock_bytes(K), WB = R::wbase(K);
  const int n0 = SPLIT ? g * N : 0;  // this warpgroup's first output channel
  // the lane through a volatile read: the values below are the same in every
  // tile, and hoisted out of the tile loop (for all five convs) they would
  // crowd out the registers the wgmma pipeline needs
  uint32_t lane_v;
  asm volatile("mov.u32 %0, %%laneid;\n" : "=r"(lane_v));
  const int lane = (int)lane_v, w4 = (threadIdx.x >> 5) & 3, half = lane >> 4;
  const uint32_t sm_s = smem_addr(sm);

  // this thread's bias columns: n0 + 8 jn + 2 (lane % 4) + e
  float bv[N / 8][2];
#pragma unroll
  for (int jn = 0; jn < N / 8; ++jn) {
#pragma unroll
    for (int e = 0; e < 2; ++e) bv[jn][e] = __ldg(a.b[K - 1] + n0 + 8 * jn + 2 * (lane & 3) + e);
  }
  // pix[i][j]: the window pixel of feature j that this lane's A row of its
  // i-th M-tile reads at tap (0, 0). Output pixel (r, c) of conv K reads
  // feature j's (r + s + ty, c + s + tx) at tap (ty, tx), s = K - 1 - j. Rows
  // past the region read pixel 0 and are not stored.
  int pix[MT][K];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    int p = (SPLIT ? i : kRdbGroups * i + g) * 64 + 16 * w4 + (lane & 15);
    p = p < NPX ? p : 0;
    const int r = p / O, c = p - r * O;
#pragma unroll
    for (int j = 0; j < K; ++j) pix[i][j] = (r + K - 1 - j) * R::edge(j) + c + K - 1 - j;
  }
  float acc[MT][N / 2];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int v = 0; v < N / 2; ++v) acc[i][v] = 0.f;
  }
  // A is double-buffered in registers by k-step: a step's ldmatrix runs
  // while the previous step's wgmma is on the tensor cores. An odd KS (<32,
  // 16, 16>'s convs 2 and 4) gives a tap's first k-step the buffer of the
  // previous tap's last, so a tap then starts by waiting for every wgmma
  uint32_t af[2][MT][4] = {};
#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const int ty = tap / 3, tx = tap - 3 * ty;
    if constexpr (KS % 2 == 1) {
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int r = 0; r < 4; ++r) reg_fence(af[0][i][r]);
      }
    }
#pragma unroll
    for (int cs = 0; cs < KS; ++cs) {
      // k-step cs of the tap: x's channels 16 cs .. (cs < XS), else x_j's
      const int j = cs < XS ? 0 : 1 + (cs - XS) / JS;
      const int q = (cs < XS ? 2 * cs : 2 * ((cs - XS) % JS)) + half;
      const int buf = cs & 1;
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int p = pix[i][j] + ty * R::edge(j) + tx;
        ldmatrix_x4(af[buf][i], sm_s + R::feat_off(j) + R::chunk(j, p, q) * 16);
      }
      const int s = tap * KS + cs;
      const uint32_t kb = WB + (uint32_t)(s >> 2) * KB;  // this k-step's k-block in the image
      const int st = ring.base + (int)(kb / R::kStage);
      const bool fresh = st != ring.cur;
      if (fresh) mbar_wait(&ring.full[st % kRdbSlots], (st / kRdbSlots) & 1);
      const uint64_t desc = wgmma_desc_sw128(ring.slots + (st % kRdbSlots) * R::kStage + kb % R::kStage +
                                             n0 * 128 + (s & 3) * 32);
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

  // accumulator acc[i][4 jn + 2 hf + e]: pixel (M-tile) * 64 + 16 w4 + lane / 4 + 8 hf,
  // channel n0 + 8 jn + 2 (lane % 4) + e
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int p = (SPLIT ? i : kRdbGroups * i + g) * 64 + 16 * w4 + (lane >> 2) + 8 * hf;
      if (p >= NPX) continue;
      const int r = p / O, c = p - r * O;
      if constexpr (K < 5) {
        const int gy = y0 - 5 + K + r, gx = x0 - 5 + K + c;
        const bool inside = gy >= 0 && gy < a.h && gx >= 0 && gx < a.w;
        unsigned char* row = sm + R::feat_off(K) + p * R::kGC * 2 + 4 * (lane & 3);
#pragma unroll
        for (int jn = 0; jn < N / 8; ++jn) {
          const float v0 = inside ? lrelu(acc[i][4 * jn + 2 * hf] + bv[jn][0]) : 0.f;
          const float v1 = inside ? lrelu(acc[i][4 * jn + 2 * hf + 1] + bv[jn][1]) : 0.f;
          *reinterpret_cast<uint32_t*>(row + ((jn ^ rdb_key<R::kGC / 8>(p)) << 4)) = pack_bf16x2(v0, v1);
        }
      } else {
        const int gy = y0 + r, gx = x0 + c;
        if (gy >= a.h || gx >= a.w) continue;
        const int xw = (r + 5) * R::kWin + c + 5;  // the same pixel in x's window
        // (x's plane of channels n0 ..)
        const unsigned char* xrow = sm + R::feat_off(0) + (n0 / 64) * R::kPlane + xw * R::kXC * 16 + 4 * (lane & 3);
        uint32_t* o = reinterpret_cast<uint32_t*>(a.out + (((size_t)n * a.h + gy) * a.w + gx) * R::kNF + n0 +
                                                  2 * (lane & 3));
#pragma unroll
        for (int jn = 0; jn < N / 8; ++jn) {
          const uint32_t xv =
              *reinterpret_cast<const uint32_t*>(xrow + ((((n0 % 64) / 8 + jn) ^ rdb_key<R::kXC>(xw)) << 4));
          const float v0 = __uint_as_float(xv << 16) + 0.2f * (acc[i][4 * jn + 2 * hf] + bv[jn][0]);
          const float v1 =
              __uint_as_float(xv & 0xffff0000u) + 0.2f * (acc[i][4 * jn + 2 * hf + 1] + bv[jn][1]);
          o[4 * jn] = pack_bf16x2(v0, v1);
        }
      }
    }
  }
}

// Conv K for warpgroup g: M-tiles g, g + G, .. (the first M-tiles % G groups
// take one more; at least kMinMT), or, for a conv of fewer M-tiles than
// groups, its one M-tile at the group's share of cout.
template <class R, int K>
__device__ __forceinline__ void rdb_tc_conv_group(const RdbTcArgs& a, unsigned char* sm, RdbRing& ring,
                                                  int g, int n, int y0, int x0) {
  constexpr int LO = R::mtiles(K) / kRdbGroups, REM = R::mtiles(K) % kRdbGroups;
  if constexpr (LO == 0) {
    static_assert(R::mtiles(K) == 1 && R::cout(K) % (8 * kRdbGroups) == 0, "one M-tile, split by cout");
    rdb_tc_conv<R, K, 1, true>(a, sm, ring, g, n, y0, x0);
  } else if (REM > 0 && g < REM) {
    rdb_tc_conv<R, K, (LO + (REM > 0) > R::kMinMT ? LO + (REM > 0) : R::kMinMT), false>(a, sm, ring, g, n, y0, x0);
  } else {
    rdb_tc_conv<R, K, (LO > R::kMinMT ? LO : R::kMinMT), false>(a, sm, ring, g, n, y0, x0);
  }
  named_barrier(1, kRdbConsumers);  // x_K is complete before conv K + 1 reads it
}

// xmap: the input's tensor map, boxes of (TILE + 10)^2 pixels x min(NF, 64) channels.
template <int NF, int GC, int TILE>
__global__ void __launch_bounds__(kRdbThreads, 1)
    rdb5c_tc_kernel(const __grid_constant__ CUtensorMap xmap, const RdbTcArgs a) {
  using R = Rdb<NF, GC, TILE>;
  extern __shared__ __align__(1024) unsigned char rdb_smem[];
  unsigned char* sm = rdb_smem + ((1024 - (smem_addr(rdb_smem) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + R::kBarOff);
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

  // 384 threads get 168 registers each. A consumer needs more (conv 1 at 16 x
  // 16: 5 M-tiles x 16 accumulators and two A buffers), or ptxas serializes
  // the wgmmas or spills; the producer warpgroup hands its share over (24 + 2
  // x 240 = 3 x 168).
  if (warp >= kRdbConsumers / 32) {  // the producer warpgroup: one thread works
    setmaxnreg_dec<24>();
    if (warp == kRdbConsumers / 32 && lane == 0) {
      prefetch_tensor_map(&xmap);
      int st = 0;  // global stage index
      int it = 0;
      for (int t = blockIdx.x; t < a.n_tiles; t += gridDim.x, ++it) {
        const int n = t / tiles_img, r = t % tiles_img;
        const int y0 = (r / a.tiles_x) * TILE, x0 = (r % a.tiles_x) * TILE;
        for (int s = 0; s < R::kStages; ++s, ++st) {
          // the tile's window: at once for the first tile; later, once the
          // previous tile's stages 0..2 are in flight and its consumers are
          // done with x (its stage 3 waits on this tile's conv 1)
          if (s == (it == 0 ? 0 : kRdbSlots)) {
            if (it > 0) mbar_wait(xfree, (it - 1) & 1);
            mbar_expect_tx(xfull, R::kXBytes);
#pragma unroll
            for (int c = 0; c < NF; c += 64)  // one box per 64-channel plane
              tma_load_4d(sm + R::feat_off(0) + (c / 64) * R::kPlane, &xmap, c, x0 - 5, y0 - 5, n, xfull);
          }
          const int slot = st % kRdbSlots;
          if (st >= kRdbSlots) mbar_wait(&empty[slot], (st / kRdbSlots - 1) & 1);
          mbar_expect_tx(&full[slot], R::kStage);
          bulk_copy_g2s(sm + slot * R::kStage, a.wimg + (size_t)s * R::kStage, R::kStage, &full[slot]);
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
    const int y0 = (r / a.tiles_x) * TILE, x0 = (r % a.tiles_x) * TILE;
    ring.base = it * R::kStages;
    mbar_wait(xfull, it & 1);
    rdb_tc_conv_group<R, 1>(a, sm, ring, g, n, y0, x0);
    rdb_tc_conv_group<R, 2>(a, sm, ring, g, n, y0, x0);
    rdb_tc_conv_group<R, 3>(a, sm, ring, g, n, y0, x0);
    rdb_tc_conv_group<R, 4>(a, sm, ring, g, n, y0, x0);
    rdb_tc_conv_group<R, 5>(a, sm, ring, g, n, y0, x0);
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
