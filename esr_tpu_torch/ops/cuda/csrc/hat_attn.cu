// HAT's two attentions (Chen et al., "Activating More Pixels in Image
// Super-Resolution Transformer", CVPR 2023, hat_arch.py), one launch a block,
// one kernel template hat_attn_kernel<KW> for both, KW the key window's edge:
//
//  - KW = 16, a HAB's (shifted) window self-attention: every 16 x 16 window
//    of the (b, hp, wp) token map rolled by -shift (0 or 8), relative
//    position bias from a (31^2, heads) table, and SwinIR's region mask
//    (-100 between the shifted map's regions) at shift 8;
//  - KW = 24, an OCAB's overlapping cross-attention: the 256 queries of a 16
//    x 16 window against the 576 keys of the 24 x 24 window centred on it
//    (nn.Unfold(24, stride 16, padding 4) of the k and v maps), bias from a
//    (39^2, heads) table, no mask: a key outside the map is zero (k = v =
//    0), so it scores its bias alone and adds nothing to the output.
//
// Replaces no TPU kernel: the JAX package has no attention. Added for the
// HAT generator (models/architecture.py), whose 36 HABs and 6 OCABs each run
// one launch.
//
//   in:  qkv (b, hp, wp, 3 C) bf16, the qkv linear's token-major output,
//        channel which * C + head * hd + d (which: q, k, v), C = heads * hd
//        table (heads, T^2) f32, the relative position bias table
//        transposed (T = 15 + KW: 31 or 39)
//   out: o (b, hp, wp, C) bf16, channel head * hd + d, for the proj linear
//   o[t] = sum_j softmax_j(scale q_t . k_j + table[head, idx(i, j)] + mask(i, j)) v_j
//
// with i the query's place (qy, qx) in its window and j = (ky, kx) the key's
// in the key window: idx = (qy - ky + 15) 31 + qx - kx + 15 at KW 16 (Swin's
// relative_position_index), (ky - qy + 15) 39 + kx - qx + 15 at KW 24 (the
// key's offset from the query, each coordinate shifted into 0..38). The
// roll, the windows and the key window's zero padding are index arithmetic
// on the token-major map (tests/test_torch_hat.py mirrors it against roll,
// partition and nn.Unfold): no rolled, unfolded or windowed copy, and no
// dense bias or score tensor, exists in device memory.
//
// What bounds it: per token it reads q, k, v (3 C bf16) and writes o (C
// bf16), 1,440 bytes at C = 180, against 4 N C FLOP, N = 256 or 576 keys:
// 128 or 288 FLOP a byte, at or below the H100's ~295. So bytes, and the
// softmax's exponentials beside them (N a query and head). The design:
// - One block a (window, head), the heads of a window adjacent in the grid,
//   so a window's token rows come from device memory once and from L2 for
//   its other heads (and, for KW 24, for the neighbouring windows whose key
//   windows overlap it). The block copies its head's q (256 rows), k and v
//   (N rows each) into shared memory with 4-byte cp.async copies that
//   zero-fill the head-dim padding (hd 30 -> 32) and keys outside the map:
//   64-byte rows whose 16-byte chunks are swizzled by row, so ldmatrix reads
//   them without bank conflicts (48 KB at KW 16, 88 KB at KW 24: the whole
//   key window is resident, no key streaming).
// - The head's bias table, times log2(e), sits in shared memory beside the
//   tiles (3.8 or 6.1 KB) and is read by index, idx = qterm[i] + kterm[j],
//   each term precomputed once a block: a dense (heads, 256, N) bias read
//   by every window would move 1.5 or 3.5 MB a window through L2.
// - Each of 8 warps takes 16-query m-tiles (rows of the window) and walks
//   the keys in chunks of 64 with an online softmax in f32 (FlashAttention
//   2's running max and sum, in base 2): S = Q K^T with mma.sync m16n8k16
//   (bf16 in, f32 out), scale, bias and mask in f32 registers, P rounded to
//   bf16 as the A operand of O = P V (V through ldmatrix.trans), O rescaled
//   as the maximum moves and divided by the row sums at the end, in f32, and
//   written as 4-byte pairs to the token's own place.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

constexpr int kWs = 16;               // query window edge
constexpr int kTokQ = kWs * kWs;      // queries a window
constexpr int kHd = 32;               // head dim, padded
constexpr int kRowBytes = kHd * 2;    // a tile row: 64 bytes
constexpr int kWords = kHd / 2;       // 4-byte words a tile row
constexpr int kChunk = 64;            // keys a step of the online softmax
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kErrShape = -2;         // a head dim, map, shift or key window the kernel does not take
constexpr float kLog2e = 1.4426950408889634f;

struct HatAttnArgs {
  const __nv_bfloat16* qkv;
  const float* table;  // (heads, T^2)
  __nv_bfloat16* out;
  int hp, wp, heads, hd, shift, windows_x, windows_img;
  float scale;
};

// The key window's geometry: KW^2 keys, the table edge T, the padding of the
// key window beyond the query window on each side.
template <int KW>
struct Geo {
  static constexpr int kTokK = KW * KW;
  static constexpr int kT = kWs + KW - 1;
  static constexpr int kPad = (KW - kWs) / 2;
  static constexpr int kChunks = kTokK / kChunk;
  static_assert(kTokK % kChunk == 0, "keys in whole chunks");
};

// Shared memory of one block: the q, k, v tiles, the queries' pixel
// indices, the bias table, the query and key index terms and the queries'
// region ids.
__host__ __device__ constexpr size_t smem_bytes(int kw) {
  return (size_t)(kTokQ + 2 * kw * kw) * kRowBytes + (size_t)(kWs + kw - 1) * (kWs + kw - 1) * 4 +
         (size_t)kTokQ * (4 + 8 + 4) + (size_t)kw * kw * 4;
}

// Byte offset of element d (even) of tile row r: 16-byte chunk d / 8 stored
// at chunk (d / 8) ^ ((r / 2) % 4), so the 8 rows of an ldmatrix matrix fall
// on 8 distinct 16-byte bank groups.
__device__ __forceinline__ int tile_off(int r, int d) {
  return r * kRowBytes + ((((d >> 3) ^ (r >> 1)) & 3) << 4) + (d & 7) * 2;
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t saddr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(saddr));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The pixel index of query i of window (b, wy, wx) in the map rolled by
// -shift, and its region id (0 everywhere at shift 0; rows and columns of
// the rolled map cut at hp - 16 and hp - shift, wp - 16 and wp - shift).
__device__ __forceinline__ long long query_pixel(const HatAttnArgs& a, int b, int wy, int wx, int i) {
  const int sy = wy * kWs + i / kWs, sx = wx * kWs + i % kWs;
  const int y = sy + a.shift < a.hp ? sy + a.shift : sy + a.shift - a.hp;
  const int x = sx + a.shift < a.wp ? sx + a.shift : sx + a.shift - a.wp;
  return ((long long)b * a.hp + y) * a.wp + x;
}
__device__ __forceinline__ int query_region(const HatAttnArgs& a, int wy, int wx, int i) {
  if (a.shift == 0) return 0;
  const int sy = wy * kWs + i / kWs, sx = wx * kWs + i % kWs;
  const int ry = sy < a.hp - kWs ? 0 : (sy < a.hp - a.shift ? 1 : 2);
  const int rx = sx < a.wp - kWs ? 0 : (sx < a.wp - a.shift ? 1 : 2);
  return ry * 3 + rx;
}

template <int KW>
__global__ void __launch_bounds__(kThreads, 2) hat_attn_kernel(const HatAttnArgs a) {
  using G = Geo<KW>;
  constexpr int kT = G::kT, kTokK = G::kTokK;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* qt = smem;                                          // [256 rows][64 bytes]
  unsigned char* kt = qt + kTokQ * kRowBytes;                        // [KW^2 rows][64 bytes]
  unsigned char* vt = kt + kTokK * kRowBytes;
  long long* qpix = reinterpret_cast<long long*>(vt + kTokK * kRowBytes);  // query i's pixel index
  float* tab = reinterpret_cast<float*>(qpix + kTokQ);               // [T^2], times log2(e)
  int* qterm = reinterpret_cast<int*>(tab + kT * kT);                // query i's term of idx
  int* qreg = qterm + kTokQ;                                         // query i's region id
  int* kterm = qreg + kTokQ;                                         // key j's term of idx

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int head = blockIdx.x % a.heads, win = blockIdx.x / a.heads;
  const int b = win / a.windows_img, wi = win % a.windows_img;
  const int wy = wi / a.windows_x, wx = wi % a.windows_x;
  const int c = a.heads * a.hd, c3 = 3 * c;

  // q, k, v of this head: tile row r, 4-byte word w (elements 2w, 2w + 1);
  // words beyond the head dim, and keys outside the map, are zero-filled
  const __nv_bfloat16* base = a.qkv + head * a.hd;
  for (int e = tid; e < (kTokQ + 2 * kTokK) * kWords; e += kThreads) {
    const int row = e / kWords, w = e % kWords;
    const int which = row < kTokQ ? 0 : (row < kTokQ + kTokK ? 1 : 2);
    const int r = which == 0 ? row : row - kTokQ - (which - 1) * kTokK;
    long long pix;
    if (which == 0 || KW == kWs) {
      pix = query_pixel(a, b, wy, wx, r);
    } else {
      const int y = wy * kWs - G::kPad + r / KW, x = wx * kWs - G::kPad + r % KW;
      pix = y >= 0 && y < a.hp && x >= 0 && x < a.wp ? ((long long)b * a.hp + y) * a.wp + x : -1;
    }
    const bool live = pix >= 0 && 2 * w < a.hd;
    const __nv_bfloat16* src = live ? base + pix * c3 + which * c + 2 * w : a.qkv;
    esr::cp_async4_zfill(qt + tile_off(row, 2 * w), src, live ? 4 : 0);  // the tiles' rows are contiguous
  }
  esr::cp_async_commit();
  const float* th = a.table + (size_t)head * kT * kT;
  for (int i = tid; i < kT * kT; i += kThreads) tab[i] = __ldg(th + i) * kLog2e;
  for (int i = tid; i < kTokQ; i += kThreads) {
    const int qy = i / kWs, qx = i % kWs;
    qpix[i] = query_pixel(a, b, wy, wx, i);
    qreg[i] = query_region(a, wy, wx, i);
    qterm[i] = (KW == kWs ? qy * kT + qx : -(qy * kT + qx)) + 15 * (kT + 1);
  }
  for (int j = tid; j < kTokK; j += kThreads) {
    const int ky = j / KW, kx = j % KW;
    kterm[j] = KW == kWs ? -(ky * kT + kx) : ky * kT + kx;
  }
  esr::cp_async_wait<0>();
  __syncthreads();

  const int g = lane >> 2, q4 = lane & 3, m = lane >> 3;
  // the key to its right in a tile pair: one column on, the same key row (KW even)
  constexpr int kStep = KW == kWs ? -1 : 1;
  const bool masked = KW == kWs && a.shift != 0;
  const float sl = a.scale * kLog2e, mask_val = -100.f * kLog2e;
  const uint32_t qs = static_cast<uint32_t>(__cvta_generic_to_shared(qt));
  const uint32_t ks = static_cast<uint32_t>(__cvta_generic_to_shared(kt));
  const uint32_t vs = static_cast<uint32_t>(__cvta_generic_to_shared(vt));
  for (int mt = warp; mt < kTokQ / 16; mt += kWarps) {
    const int r0 = mt * 16;
    // Q's A fragments, k-steps 0 and 1: matrix m is rows r0 + 8 (m % 2) ..,
    // columns 8 (2 kstep + m / 2) ..
    uint32_t qa[2][4];
#pragma unroll
    for (int kst = 0; kst < 2; ++kst)
      esr::ldmatrix_x4(qa[kst], qs + tile_off(r0 + (m & 1) * 8 + (lane & 7), 16 * kst + 8 * (m >> 1)));
    const int qi0 = r0 + g, qi1 = r0 + g + 8;
    const int qt0 = qterm[qi0], qt1 = qterm[qi1], rg0 = qreg[qi0], rg1 = qreg[qi1];
    float mx0 = -1e30f, mx1 = -1e30f, sum0 = 0.f, sum1 = 0.f;
    float acc[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
    }
    for (int ch = 0; ch < G::kChunks; ++ch) {
      const int k0 = ch * kChunk;
      float s[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        // K rows k0 + 8 nt .. as B (col): matrices = columns 0, 8, 16, 24
        uint32_t kb[4];
        esr::ldmatrix_x4(kb, ks + tile_off(k0 + 8 * nt + (lane & 7), 8 * m));
#pragma unroll
        for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
        mma16816(s[nt], qa[0], kb[0], kb[1]);
        mma16816(s[nt], qa[1], kb[2], kb[3]);
      }
      // scale, bias and mask in base 2; the chunk's row maxima (rows qi0, qi1)
      float cm0 = mx0, cm1 = mx1;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int kj = k0 + 8 * nt + 2 * q4, kt0 = kterm[kj];
        float m0 = 0.f, m1 = 0.f;
        if (masked) {  // keys kj and kj + 1 share a region (cuts fall on even columns)
          const int rk = qreg[kj];
          m0 = rg0 != rk ? mask_val : 0.f;
          m1 = rg1 != rk ? mask_val : 0.f;
        }
        s[nt][0] = fmaf(s[nt][0], sl, tab[qt0 + kt0] + m0);
        s[nt][1] = fmaf(s[nt][1], sl, tab[qt0 + kt0 + kStep] + m0);
        s[nt][2] = fmaf(s[nt][2], sl, tab[qt1 + kt0] + m1);
        s[nt][3] = fmaf(s[nt][3], sl, tab[qt1 + kt0 + kStep] + m1);
        cm0 = fmaxf(cm0, fmaxf(s[nt][0], s[nt][1]));
        cm1 = fmaxf(cm1, fmaxf(s[nt][2], s[nt][3]));
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        cm0 = fmaxf(cm0, __shfl_xor_sync(0xffffffffu, cm0, o));
        cm1 = fmaxf(cm1, __shfl_xor_sync(0xffffffffu, cm1, o));
      }
      // the running sums and outputs rescaled to the new maxima
      const float f0 = exp2f(mx0 - cm0), f1 = exp2f(mx1 - cm1);
      mx0 = cm0;
      mx1 = cm1;
      sum0 *= f0;
      sum1 *= f1;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        acc[nt][0] *= f0;
        acc[nt][1] *= f0;
        acc[nt][2] *= f1;
        acc[nt][3] *= f1;
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        s[nt][0] = exp2f(s[nt][0] - mx0);
        s[nt][1] = exp2f(s[nt][1] - mx0);
        s[nt][2] = exp2f(s[nt][2] - mx1);
        s[nt][3] = exp2f(s[nt][3] - mx1);
        sum0 += s[nt][0] + s[nt][1];
        sum1 += s[nt][2] + s[nt][3];
      }
      // O += P V: P's A fragment of keys k0 + 16 kk .. from S's n-tiles 2 kk, 2 kk + 1
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t pa[4] = {esr::pack_bf16x2(s[2 * kk][0], s[2 * kk][1]),
                                esr::pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
                                esr::pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                esr::pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          // V rows k0 + 16 kk + 8 (m % 2) .., columns 8 (2 np + m / 2) .., transposed
          uint32_t vb[4];
          ldmatrix_x4_trans(vb, vs + tile_off(k0 + 16 * kk + 8 * (m & 1) + (lane & 7), 8 * (2 * np + (m >> 1))));
          mma16816(acc[2 * np], pa, vb[0], vb[1]);
          mma16816(acc[2 * np + 1], pa, vb[2], vb[3]);
        }
      }
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, o);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, o);
    }
    const float inv0 = 1.f / sum0, inv1 = 1.f / sum1;
    __nv_bfloat16* o0 = a.out + qpix[qi0] * c + head * a.hd;
    __nv_bfloat16* o1 = a.out + qpix[qi1] * c + head * a.hd;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int d = 8 * nt + 2 * q4;
      if (d < a.hd) {
        *reinterpret_cast<uint32_t*>(o0 + d) = esr::pack_bf16x2(acc[nt][0] * inv0, acc[nt][1] * inv0);
        *reinterpret_cast<uint32_t*>(o1 + d) = esr::pack_bf16x2(acc[nt][2] * inv1, acc[nt][3] * inv1);
      }
    }
  }
}

template <int KW>
int launch(const HatAttnArgs& a, long long blocks, cudaStream_t stream) {
  const size_t smem = smem_bytes(KW);
  cudaError_t err = cudaFuncSetAttribute(hat_attn_kernel<KW>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  hat_attn_kernel<KW><<<(unsigned)blocks, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// qkv: (b, hp, wp, 3 heads hd) bf16, 4-byte aligned; table: (heads, (15 +
// kw)^2) f32; out: (b, hp, wp, heads hd) bf16, 4-byte aligned. kw 16 (shift
// 0 or in (0, 16), the mask at shift > 0) or 24 (shift 0, zero keys outside
// the map); hp, wp multiples of 16; hd even, at most 32. Returns 0, a
// cudaError_t, or kErrShape.
int esr_hat_attn(const void* qkv, const void* table, void* out, int b, int hp, int wp, int heads, int hd,
                 int shift, int kw, float scale, void* stream) {
  if (b < 0 || hp % kWs || wp % kWs || hd < 2 || hd > kHd || hd % 2 || heads < 1 || shift < 0 || shift % 2 ||
      (kw == kWs ? shift >= kWs : (kw != 24 || shift != 0)))
    return kErrShape;
  HatAttnArgs a;
  a.qkv = static_cast<const __nv_bfloat16*>(qkv);
  a.table = static_cast<const float*>(table);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.hp = hp; a.wp = wp; a.heads = heads; a.hd = hd; a.shift = shift; a.scale = scale;
  a.windows_x = wp / kWs;
  a.windows_img = (hp / kWs) * a.windows_x;
  const long long blocks = (long long)b * a.windows_img * heads;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return kErrShape;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return kw == kWs ? launch<16>(a, blocks, s) : launch<24>(a, blocks, s);
}

const char* esr_error_string(int err) {
  if (err == kErrShape)
    return "HAT attention takes key window 16 (an even shift in [0, 16)) or 24 (shift 0), hp and wp multiples of 16 "
           "and an even head dim up to 32";
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
