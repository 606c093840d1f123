// A token-wise linear layer of SwinIR with its epilogue: y = x W^T + b on a
// (M, K) bf16 token stream, then per call site GELU (erf) or a residual add,
// one launch a layer (models/blocks.py::Linear). SwinIR-M's four sites a
// Swin block, (K, N, epilogue):
//
//   attn.qkv  (180, 540, bias)       y = x W^T + b
//   attn.proj (180, 180, residual)   y = u + (x W^T + b)
//   mlp.fc1   (180, 360, gelu)       y = gelu(x W^T + b), erf form
//   mlp.fc2   (360, 180, residual)   y = u + (x W^T + b)
//
// bf16 operands, f32 accumulation on the tensor cores (wgmma), the bias, GELU
// and the residual added to the f32 sum, one rounding to bf16 at the store.
// GELU is v Phi(v) with Phi from an erfc approximation of fractional error
// under 1.2e-7 (gelu_erf), nearer the exact GELU than torch's f32
// 0.5 v (1 + erff(v / sqrt 2)), which cancels for v below about -3.
//
// Replaces no TPU kernel: the JAX package has no SwinIR. Added because, on
// an H100 SXM at 700 W, cuBLAS ran these GEMMs on its sm80 align2 kernels
// (rows of 180, 360 and 540 bf16 are not 16-byte multiples) at ~113
// TFLOP/s, 116.7 ms of a 215 ms forward at B4 x 344 x 512 tokens, followed
// by 36 GELU and 72 residual-add passes (~30 ms).
//
// What bounds it: bytes. Per token and Swin block the four launches read x
// (and u) and write y once: 28 C bytes (5,040 at C 180) against 518,400
// FLOP, 103 FLOP a byte, below the H100's ~295. So each launch reads every
// input byte from device memory once and writes y once, nothing between the
// GEMM and the epilogue goes back to device memory, and the threads spend
// as few instructions as they can on moving bytes:
//  - the weights stay in shared memory: the output columns are cut into
//    slabs (180 columns at K 180, padded to a wgmma width of 184; 96 at K 360
//    so that the slab's 384 K values fit), and each block holds one slab's
//    weight image for its whole life, packed once by the wrapper into
//    128-byte rows of 64 K values with their 16-byte chunks swizzled by row
//    (hopper.cuh: the B operand of wgmma_desc_sw128), K and the slab's
//    columns zero-padded. The blocks of one group, one a slab, walk the same
//    tiles at the same pace, so x's second and third reads hit L2;
//  - a tile is 64 token rows, one warpgroup's wgmma M. Its rows are
//    contiguous in device memory (23,040 bytes at K 180), so one thread moves
//    it with one bulk copy (cp.async.bulk, completed on an mbarrier; the
//    8-byte tail of an odd row count by hand) into shared memory as it lies
//    there, rows K values apart. A row of 360 bytes is no TMA stride and no
//    ldmatrix row, so the A fragments are 4-byte shared loads (two-way bank
//    conflicts at K 180, none at 360), the columns past K zeroed in
//    registers. 8-byte cp.async by every thread, the first design, spent
//    thread time stalled on issue and ran 5-14% slower;
//  - each of the block's warpgroups walks its own tiles through its own ring
//    of x stages, so later tiles are in flight while one computes, and the
//    warpgroups drift apart and overlap each other's epilogues: two
//    warpgroups of three stages at qkv, of two at proj and of one at fc2
//    (what shared memory holds beside the weights and the residual stage);
//    three of two at fc1, whose GELUs are ~20 instructions a value and want
//    more warps to hide their latencies;
//  - a tile's K steps are one chain of wgmma m64n184k16 (m64n96k16), A from
//    registers, the accumulators in registers; the epilogue adds the bias
//    (f32, shared memory), applies GELU (16 values interleaved) or adds the
//    residual tile, rounds once and writes bf16 into shared memory, over the
//    residual or over the consumed x tile;
//  - proj's residual and y tiles are whole rows too (N 180): bulk copies in
//    and out. The slabs of qkv, fc1 and fc2 are not (their rows lie 1,080,
//    720 or 360 bytes apart), so their y tiles are stored by the warps, row
//    segments 8 bytes a lane, and fc2's residual slab comes by 8-byte
//    cp.async into rows padded to a stride of 8 modulo 16 elements;
//  - the grid is the SMs rounded down to whole slab groups, persistent,
//    fewer for a short input; the last tile is ragged (its rows past M are
//    neither copied nor stored).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "ptx.cuh"

namespace {

constexpr int kRows = 64;                 // token rows a tile: one warpgroup's wgmma M
constexpr int kSmemMax = 232448;          // shared memory a block may use on the H100
constexpr int kErrShape = -2;             // a (K, N, epilogue) the kernel does not take
enum Epilogue { kBias = 0, kGelu = 1, kResidual = 2 };

// d[64 x N] (+)= A[64 x 16] (registers: per warp the mma.sync m16n8k16 A
// fragment of its 16 rows) * B[16 x N] (descriptor); d is overwritten when
// scale_d is 0. Accumulators per warp as N/8 mma.sync m16n8 C fragments.
template <int N>
struct WgmmaRS;

template <>
struct WgmmaRS<184> {
  __device__ __forceinline__ static void mma(float (&d)[92], const uint32_t (&a)[4], uint64_t b, int scale_d) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %97, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n184k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
        "%84, %85, %86, %87, %88, %89, %90, %91"
        "}, {%92, %93, %94, %95}, %96, p, 1, 1, 0;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct WgmmaRS<96> {
  __device__ __forceinline__ static void mma(float (&d)[48], const uint32_t (&a)[4], uint64_t b, int scale_d) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %53, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
        "}, {%48, %49, %50, %51}, %52, p, 1, 1, 0;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};


// A stride of 8 modulo 16 elements: a warp's fragment accesses (rows g and g
// + 8, columns 2 t + 8 j) fall into 32 distinct banks (fc2's residual tile).
__host__ __device__ constexpr int padded_stride(int n) { return n % 16 == 8 ? n : (n + 8) / 16 * 16 + 8; }

template <int K, int NW, int EPI>
struct Cfg {
  static constexpr int kKP = (K + 15) / 16 * 16;          // K in whole k-steps
  static constexpr int kSteps = kKP / 16;
  static constexpr int kPanels = (kKP + 63) / 64;         // 128-byte rows of 64 K values
  static constexpr int kWBytes = kPanels * NW * 128;      // one slab's weight image
  static constexpr int kBiasBytes = NW * 4;
  static constexpr int kXBytes = kRows * K * 2;           // an x tile, its rows as in device memory
  static constexpr int kQ = (NW / 4 + 31) / 32;           // a warp's passes over a slab's row of y or the residual
  static constexpr bool kRes = EPI == kResidual;
  // proj (K 180, N 180): the residual and y tiles are whole rows as in device
  // memory, moved by bulk copies; fc2's slabs are not, so by cp.async and stores
  static constexpr bool kWholeRows = kRes && K == 180;
  static constexpr int kRS = kWholeRows ? K : padded_stride(NW);  // residual / output tile row stride
  static constexpr int kRBytes = kRes ? kRows * kRS * 2 : 0;
  // warpgroups a block, each on its own tiles: three at fc1, whose GELU
  // epilogue is issue-bound (-20% against two on the H100), two elsewhere
  // (qkv ran 43% slower with three)
  static constexpr int kWG = EPI == kGelu ? 3 : 2;
  static constexpr int kThreads = 128 * kWG;
  static constexpr int kBars = 1 + kWG * (3 + 1);         // weights; per warpgroup up to 3 x stages and a residual
  static constexpr int kFixed = 1024 + kWBytes + kBiasBytes + kWG * kRBytes + 8 * kBars;
  static constexpr int kSX =
      (kSmemMax - kFixed) / (kWG * kXBytes) < 3 ? (kSmemMax - kFixed) / (kWG * kXBytes) : 3;
  static constexpr int kWgBytes = kSX * kXBytes + kRBytes;  // a warpgroup's stages
  static constexpr int kSmemBytes = 1024 + kWBytes + kBiasBytes + kWG * kWgBytes + 8 * kBars;
  static constexpr int kOS = kRes ? kRS : K;              // the output tile's row stride
  static_assert(K % 4 == 0 && NW % 8 == 0 && kSX >= 1 && kSmemBytes <= kSmemMax, "shape");
  static_assert(kWBytes % 1024 == 0 && kBiasBytes % 16 == 0 && kXBytes % 16 == 0 && kRBytes % 16 == 0, "align");
};

struct TlArgs {
  const __nv_bfloat16* x;  // (m, k)
  const __nv_bfloat16* w;  // [slabs][panels][NW][64], swizzled (token_linear.py)
  const float* b;          // [slabs][NW]
  const __nv_bfloat16* r;  // (m, n), the residual, or null
  __nv_bfloat16* y;        // (m, n)
  long long m;
  long long tiles;         // ceil(m / 64)
  int n;
  int ns;                  // columns a slab
  int slabs;
};

__device__ __forceinline__ float2 unpack(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// GELU with erf of n values in place, v Phi(v), Phi(v) = erfc(-v / sqrt 2) /
// 2, branchless: erfc of z = |v| / sqrt 2 >= 0 by Numerical Recipes' erfcc
// (fractional error under 1.2e-7 for every z), t exp(-z^2 + P(t)), t = 1 /
// (1 + z / 2); then Phi = e / 2 for v < 0 (no cancellation in the tail) or
// 1 - e / 2. About 20 instructions a value against erff's ~35 with both of
// its branches; each step runs over all n values, so that n independent
// chains hide the FMA and MUFU latencies (a warp has one other warp on its
// scheduler to hide them with).
template <int N>
__device__ __forceinline__ void gelu_erf(float (&v)[N]) {
  constexpr float kP[10] = {0.17087277f, -0.82215223f, 1.48851587f, -1.13520398f, 0.27886807f,
                            -0.18628806f, 0.09678418f, 0.37409196f, 1.00002368f, -1.26551223f};
  float z[N], t[N], p[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    z[i] = fabsf(v[i]) * 0.70710678f;
    t[i] = __fdividef(1.0f, fmaf(0.5f, z[i], 1.0f));
    p[i] = fmaf(t[i], kP[0], kP[1]);
  }
#pragma unroll
  for (int k = 2; k < 10; ++k) {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = fmaf(t[i], p[i], kP[k]);
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float e = t[i] * __expf(fmaf(-z[i], z[i], p[i]));
    v[i] *= v[i] >= 0.f ? fmaf(-0.5f, e, 1.0f) : 0.5f * e;
  }
}

// Arrive on bar once every cp.async this thread issued so far has landed
// (the barrier counts the arrival as one of its expected ones).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(esr::smem_addr(bar)) : "memory");
}

// bytes (a multiple of 8) contiguous bytes from global src to shared dst, both
// 16-byte aligned, completing on bar (its one expected arrival): a bulk copy
// of the multiple of 16 below, the 8-byte tail (an odd row count at K 180)
// by this thread.
__device__ __forceinline__ void load_rows(unsigned char* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  const uint32_t body = bytes & ~15u;
  if (body != bytes) {
    *reinterpret_cast<uint2*>(dst + body) = *reinterpret_cast<const uint2*>(static_cast<const char*>(src) + body);
    esr::fence_proxy_async();
  }
  esr::mbar_expect_tx(bar, body);
  esr::bulk_copy_g2s(dst, src, body, bar);
}

// bytes (a multiple of 8) contiguous bytes from shared src to global dst, both
// 16-byte aligned: a bulk copy of the multiple of 16 below (a bulk group:
// esr::bulk_wait_read before src is written again), the tail by this thread.
__device__ __forceinline__ void store_rows(void* dst, const unsigned char* src, uint32_t bytes) {
  const uint32_t body = bytes & ~15u;
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst), "r"(esr::smem_addr(src)),
               "r"(body)
               : "memory");
  esr::bulk_commit();
  if (body != bytes)
    *reinterpret_cast<uint2*>(static_cast<char*>(dst) + body) = *reinterpret_cast<const uint2*>(src + body);
}

// rows x chunks 8-byte chunks by cp.async, chunk q of row r from src + r
// src_ld + 4 q (elements) to dst + r dst_ld + 4 q: warp w of the warpgroup
// takes rows w, w + 4, ..., lane l the row's chunks l, l + 32, ... (at most
// 32 Q); unrolled, so the copies issue back to back.
template <int Q>
__device__ __forceinline__ void copy_rows(__nv_bfloat16* dst, int dst_ld, const __nv_bfloat16* src, long long src_ld,
                                          int rows, int chunks, int warp, int lane) {
#pragma unroll
  for (int rr = 0; rr < kRows / 4; ++rr) {
    const int r = warp + 4 * rr;
#pragma unroll
    for (int qq = 0; qq < Q; ++qq) {
      const int q = lane + 32 * qq;
      if (r < rows && q < chunks) esr::cp_async8_zfill(dst + r * dst_ld + 4 * q, src + r * src_ld + 4 * q, 8);
    }
  }
}

template <int K, int NW, int EPI>
__global__ void __launch_bounds__(Cfg<K, NW, EPI>::kThreads, 1) token_linear_kernel(const TlArgs a) {
  using C = Cfg<K, NW, EPI>;
  extern __shared__ __align__(1024) unsigned char tl_smem[];
  unsigned char* wsm = tl_smem + ((1024 - (esr::smem_addr(tl_smem) & 1023)) & 1023);
  const float* bias = reinterpret_cast<const float*>(wsm + C::kWBytes);
  unsigned char* stages = wsm + C::kWBytes + C::kBiasBytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(stages + C::kWG * C::kWgBytes);

  // the warpgroup through a shuffle, so that the compiler knows it is the
  // same for the whole warp: wgmma in a path it thinks divergent is serialized
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 7, 0);
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const bool leader = (threadIdx.x & 127) == 0;     // issues the warpgroup's bulk copies
  unsigned char* mine = stages + wg * C::kWgBytes;  // x stages, then the residual stage
  uint64_t* wbar = bars;                            // the weights and the bias landed
  uint64_t* xbar = bars + 1 + wg * 4;               // x stage s landed
  uint64_t* rbar = xbar + 3;                        // the residual stage landed

  const int slab = blockIdx.x % a.slabs;
  const long long step = (long long)C::kWG * (gridDim.x / a.slabs);
  const long long first = (long long)C::kWG * (blockIdx.x / a.slabs) + wg;
  const int col0 = slab * a.ns, cols = min(a.ns, a.n - col0);  // the slab's columns of y and the residual

  if (threadIdx.x == 0) {
    for (int i = 0; i < C::kBars; ++i) esr::mbar_init(bars + i, i % 4 == 0 && i && !C::kWholeRows ? 128 : 1);
    esr::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    esr::mbar_expect_tx(wbar, C::kWBytes + C::kBiasBytes);
    esr::bulk_copy_g2s(wsm, a.w + (long long)slab * (C::kWBytes / 2), C::kWBytes, wbar);
    esr::bulk_copy_g2s(wsm + C::kWBytes, a.b + (long long)slab * NW, C::kBiasBytes, wbar);
  }

  auto rows_of = [&](long long t) { return (int)min((long long)kRows, a.m - t * kRows); };
  auto issue_x = [&](long long t, int s) {
    if (t < a.tiles && leader)
      load_rows(mine + s * C::kXBytes, a.x + t * kRows * K, rows_of(t) * K * 2, xbar + s);
  };
  auto issue_r = [&](long long t) {
    if (t >= a.tiles) return;
    unsigned char* rs = mine + C::kSX * C::kXBytes;
    if constexpr (C::kWholeRows) {
      if (leader) {
        esr::bulk_wait_read<0>();  // the last y tile's store has read the stage
        load_rows(rs, a.r + t * kRows * K, rows_of(t) * K * 2, rbar);
      }
    } else {
      copy_rows<C::kQ>(reinterpret_cast<__nv_bfloat16*>(rs), C::kRS, a.r + t * kRows * a.n + col0, a.n, rows_of(t),
                       cols / 4, warp, lane);
      cp_async_arrive(rbar);
    }
  };

  float d[NW / 2];
#pragma unroll
  for (int j = 0; j < NW / 2; ++j) d[j] = 0.f;
  for (int s = 0; s < C::kSX; ++s) issue_x(first + s * step, s);
  if constexpr (C::kRes) issue_r(first);
  esr::mbar_wait(wbar, 0);

  const uint32_t w_addr = esr::smem_addr(wsm);
  const int g = lane >> 2, tq = lane & 3, row0 = warp * 16 + g;
  int i = 0;
  for (long long t = first; t < a.tiles; t += step, ++i) {
    const int s = i % C::kSX;
    unsigned char* xs = mine + s * C::kXBytes;
    esr::mbar_wait(xbar + s, (uint32_t)(i / C::kSX) & 1);
    // the A fragments (mma.sync m16n8k16 layout) of the warp's 16 rows, from
    // rows K values apart; the columns past K (the last k-step's) are zeros
    uint32_t af[C::kSteps][4];
    const uint32_t* x0 = reinterpret_cast<const uint32_t*>(xs) + row0 * (K / 2) + tq;
    const uint32_t* x1 = x0 + 8 * (K / 2);
#pragma unroll
    for (int k = 0; k < C::kSteps; ++k) {
      const int c = 16 * k + 2 * tq;
      const bool lo = 16 * k + 8 <= K || c < K, hi = 16 * k + 16 <= K || c + 8 < K;
      af[k][0] = lo ? x0[8 * k] : 0u;
      af[k][1] = lo ? x1[8 * k] : 0u;
      af[k][2] = hi ? x0[8 * k + 4] : 0u;
      af[k][3] = hi ? x1[8 * k + 4] : 0u;
    }
    esr::wgmma_fence();
#pragma unroll
    for (int k = 0; k < C::kSteps; ++k)
      WgmmaRS<NW>::mma(d, af[k], esr::wgmma_desc_sw128(w_addr + (k >> 2) * NW * 128 + (k & 3) * 32), k > 0);
    esr::wgmma_commit();
    esr::wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < NW / 2; ++j) esr::reg_fence(d[j]);
    esr::named_barrier(1 + wg, 128);  // the warpgroup's reads of the x tile are done

    unsigned char* out = xs;  // the output tile: over the x tile, or over the residual
    if constexpr (C::kRes) {
      issue_x(t + C::kSX * step, s);
      esr::mbar_wait(rbar, (uint32_t)i & 1);
      out = mine + C::kSX * C::kXBytes;
    }
    // a batch of kJB n8 blocks at a time: 4 kJB values, their GELUs interleaved
    constexpr int kJB = EPI == kGelu ? 4 : 1;
#pragma unroll
    for (int j0 = 0; j0 < NW / 8; j0 += kJB) {
      float v[4 * kJB];
#pragma unroll
      for (int jj = 0; jj < kJB; ++jj) {
        const int j = j0 + jj < NW / 8 ? j0 + jj : NW / 8 - 1;  // past the last block: a copy, not stored
        const float2 bb = *reinterpret_cast<const float2*>(bias + 8 * j + 2 * tq);
        v[4 * jj] = d[4 * j] + bb.x, v[4 * jj + 1] = d[4 * j + 1] + bb.y;
        v[4 * jj + 2] = d[4 * j + 2] + bb.x, v[4 * jj + 3] = d[4 * j + 3] + bb.y;
      }
      if constexpr (EPI == kGelu) gelu_erf(v);
#pragma unroll
      for (int jj = 0; jj < kJB; ++jj) {
        const int c = 8 * (j0 + jj) + 2 * tq;
        if (j0 + jj < NW / 8 && c < cols) {
          uint32_t* o0 = reinterpret_cast<uint32_t*>(out + (row0 * C::kOS + c) * 2);
          uint32_t* o1 = reinterpret_cast<uint32_t*>(out + ((row0 + 8) * C::kOS + c) * 2);
          float* u = v + 4 * jj;
          if constexpr (EPI == kResidual) {
            const float2 u0 = unpack(*o0), u1 = unpack(*o1);
            u[0] += u0.x, u[1] += u0.y, u[2] += u1.x, u[3] += u1.y;
          }
          *o0 = esr::pack_bf16x2(u[0], u[1]);
          *o1 = esr::pack_bf16x2(u[2], u[3]);
        }
      }
    }
    esr::fence_proxy_async();  // the tile's shared-memory writes, before bulk copies read or overwrite it
    esr::named_barrier(1 + wg, 128);
    const int rows = rows_of(t);
    if constexpr (C::kWholeRows) {
      if (leader) store_rows(a.y + t * kRows * K, out, rows * K * 2);
    } else {  // the output tile's rows to y as copy_rows walks them, unrolled so the shared loads issue together
      const int chunks = cols / 4;
      __nv_bfloat16* dst = a.y + t * kRows * a.n + col0;
#pragma unroll
      for (int rr = 0; rr < kRows / 4; ++rr) {
        const int r = warp + 4 * rr;
#pragma unroll
        for (int qq = 0; qq < C::kQ; ++qq) {
          const int q = lane + 32 * qq;
          if (r < rows && q < chunks)
            *reinterpret_cast<uint2*>(dst + r * (long long)a.n + 4 * q) =
                *reinterpret_cast<const uint2*>(out + (r * C::kOS + 4 * q) * 2);
        }
      }
      esr::named_barrier(1 + wg, 128);  // the output tile is read: its stage may be refilled
    }
    if constexpr (C::kRes) {
      issue_r(t + step);
    } else {
      issue_x(t + C::kSX * step, s);
    }
  }
  if (leader) esr::bulk_wait<0>();
}

template <int K, int NW, int EPI>
int launch(TlArgs a, int sms, cudaStream_t stream) {
  using C = Cfg<K, NW, EPI>;
  const auto kernel = token_linear_kernel<K, NW, EPI>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  a.tiles = (a.m + kRows - 1) / kRows;
  const long long most = sms / a.slabs, need = (a.tiles + C::kWG - 1) / C::kWG;
  const long long groups = need < most ? need : most;
  kernel<<<(unsigned)((groups > 0 ? groups : 1) * a.slabs), C::kThreads, C::kSmemBytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (m, k) bf16; w, b: token_linear_weights' image ([slabs][panels][NW][64]
// bf16, 128-byte chunks swizzled by row) and bias ([slabs][NW] f32); r: (m, n)
// bf16 or null; y: (m, n) bf16; every pointer 16-byte aligned. (k, n,
// epilogue): k 180 with n 180, 360 or 540 and the bias or GELU, or with n 180
// and the residual (slabs of 180 columns); k 360 with n 180 and the residual
// (slabs of 96). epi: 0 bias,
// 1 GELU, 2 residual. sms: the card's SMs. Launches on stream, allocates
// nothing. Returns 0, a cudaError_t, or kErrShape.
int esr_token_linear(const void* x, const void* w, const void* b, const void* r, void* y, long long m, int k, int n,
                     int epi, int sms, void* stream) {
  if (m < 0 || sms < 1 || epi < kBias || epi > kResidual || (epi == kResidual) != (r != nullptr)) return kErrShape;
  TlArgs a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.w = static_cast<const __nv_bfloat16*>(w);
  a.b = static_cast<const float*>(b);
  a.r = static_cast<const __nv_bfloat16*>(r);
  a.y = static_cast<__nv_bfloat16*>(y);
  a.m = m;
  a.tiles = 0;
  a.n = n;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k == 180 && (n == 180 || n == 360 || n == 540) && (epi != kResidual || n == 180)) {
    a.ns = 180;
    a.slabs = n / 180;
    if (m == 0) return 0;
    if (epi == kBias) return launch<180, 184, kBias>(a, sms, s);
    if (epi == kGelu) return launch<180, 184, kGelu>(a, sms, s);
    return launch<180, 184, kResidual>(a, sms, s);
  }
  if (k == 360 && n == 180 && epi == kResidual) {
    a.ns = 96;
    a.slabs = 2;
    return m == 0 ? 0 : launch<360, 96, kResidual>(a, sms, s);
  }
  return kErrShape;
}

const char* esr_error_string(int err) {
  if (err == kErrShape)
    return "token_linear takes K 180 with N 180, 360 or 540 (a residual at N 180 only), "
           "or K 360 with N 180 and a residual";
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
