// Shifted-window multi-head self-attention of a Swin transformer block
// (SwinIR, Liang et al. 2021), one launch a block: every (window, head) of a
// (b, hp, wp) token map, window 8 x 8, cyclic shift 0 or 4, with the
// relative position bias and the shifted windows' region mask.
//
// Replaces no TPU kernel: the JAX package has no attention. Added for the
// SwinIR generator (models/architecture.py), whose 36 blocks each run one.
//
//   in:  qkv (b, hp, wp, 3 C) bf16, the qkv linear's token-major output,
//        channel which * C + head * hd + d (which: q, k, v), C = heads * hd
//   out: o (b, hp, wp, C) bf16, channel head * hd + d, for the proj linear
//   o[t] = sum_j softmax_j(scale q_t . k_j + bias[head, i, j] + mask(i, j)) v_j
//
// over the tokens j of t's window in the map rolled by -shift, where i, j
// are window-local indices (row-major 8 x 8). The roll, the window
// partition and its reverse are index arithmetic: window (wy, wx)'s token i
// at rolled coordinates (sy, sx) = (8 wy + i / 8, 8 wx + i % 8) is the
// token at ((sy + shift) % hp, (sx + shift) % wp), read and written there.
// mask(i, j) = -100 where the region ids of the rolled coordinates differ
// (rows and columns cut at hp - 8 and hp - shift, wp - 8 and wp - shift;
// SwinIR's calculate_mask), else 0; no mask at shift 0. No rolled tensor, no
// window copy and no dense score tensor exists in device memory.
//
// What bounds it: per token it reads q, k, v (3 C bf16) and writes o (C
// bf16), 1,440 bytes at C = 180, against 4 * 64 * C = 46,080 FLOP: 32 FLOP
// a byte, far below the H100's ~295, so bytes. The design keeps each byte
// read once: one block a window, all heads; its 64 tokens' q, k, v are
// loaded into shared memory with 8-byte loads (a token's 3 C channels are
// contiguous), each head's q, k, v as 64 x 32 tiles (head dim zero-padded
// to 32; 64-byte rows whose 16-byte chunks are swizzled by row, so
// ldmatrix reads them without bank conflicts). Each warp takes (head,
// 16-query) tasks: S = Q K^T with mma.sync m16n8k16 (bf16 in, f32 out),
// then scale, bias (f32, the block's dense (heads, 64, 64) table, read
// through the L1/L2), mask and the softmax in f32 registers, P rounded to
// bf16 as the A operand of O = P V (V through ldmatrix.trans), O divided by
// the row sums in f32, staged in shared memory and written as whole token
// rows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

constexpr int kWs = 8;                // window edge
constexpr int kTok = kWs * kWs;       // tokens a window
constexpr int kHd = 32;               // head dim, padded
constexpr int kRowBytes = kHd * 2;    // a tile row: 64 bytes
constexpr int kTileBytes = kTok * kRowBytes;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxHeads = 8;
constexpr int kErrShape = -2;         // a head dim, head count or map the kernel does not take

struct AttnArgs {
  const __nv_bfloat16* qkv;
  const float* bias;  // (heads, 64, 64)
  __nv_bfloat16* out;
  int hp, wp, heads, hd, shift, windows_x, windows_img;
  float scale;
};

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

// The region id (0..8) of rolled coordinates (sy, sx); 0 everywhere at shift 0.
__device__ __forceinline__ int region(int sy, int sx, const AttnArgs& a) {
  if (a.shift == 0) return 0;
  const int ry = sy < a.hp - kWs ? 0 : (sy < a.hp - a.shift ? 1 : 2);
  const int rx = sx < a.wp - kWs ? 0 : (sx < a.wp - a.shift ? 1 : 2);
  return ry * 3 + rx;
}

__global__ void __launch_bounds__(kThreads, 2) window_attn_kernel(const AttnArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int c = a.heads * a.hd, c3 = 3 * c;
  unsigned char* tiles = smem;                                      // [3][heads][64 rows][64 bytes]
  unsigned char* stage = smem + 3 * a.heads * kTileBytes;           // [64][c] bf16, the output rows
  long long* tok = reinterpret_cast<long long*>(stage + kTok * c * 2);  // token t's pixel index
  int* reg = reinterpret_cast<int*>(tok + kTok);                    // token t's region id

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / a.windows_img, wi = blockIdx.x % a.windows_img;
  const int wy = wi / a.windows_x, wx = wi % a.windows_x;
  if (tid < kTok) {
    const int sy = wy * kWs + tid / kWs, sx = wx * kWs + tid % kWs;
    const int y = sy + a.shift < a.hp ? sy + a.shift : sy + a.shift - a.hp;
    const int x = sx + a.shift < a.wp ? sx + a.shift : sx + a.shift - a.wp;
    tok[tid] = ((long long)b * a.hp + y) * a.wp + x;
    reg[tid] = region(sy, sx, a);
  }
  // the head-dim padding (columns hd .. 31) of every tile row is zero
  for (int i = tid; i < 3 * a.heads * kTok * (kHd - a.hd) / 2; i += kThreads) {
    const int per = (kHd - a.hd) / 2, row = i / per, d = a.hd + 2 * (i % per);
    *reinterpret_cast<uint32_t*>(tiles + (row / kTok) * kTileBytes + tile_off(row % kTok, d)) = 0u;
  }
  __syncthreads();

  // q, k, v: warp w loads tokens w, w + 8, ..., 8-byte words k = lane + 32 j
  // of each; a word holds channels 4k .. 4k + 3, two pairs that may belong
  // to different heads (head dims are even, so a pair never straddles)
  const int words = c3 / 4;
  for (int k = lane; k < words; k += 32) {
    int dst[2], dd[2];
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int e = 4 * k + 2 * p, which = e / c, rem = e - which * c, head = rem / a.hd;
      dst[p] = (which * a.heads + head) * kTileBytes;
      dd[p] = rem - head * a.hd;
    }
    uint2 v[kTok / kWarps];
#pragma unroll
    for (int t = 0; t < kTok / kWarps; ++t)
      v[t] = __ldg(reinterpret_cast<const uint2*>(a.qkv + tok[warp + kWarps * t] * c3) + k);
#pragma unroll
    for (int t = 0; t < kTok / kWarps; ++t) {
      const int row = warp + kWarps * t;
      *reinterpret_cast<uint32_t*>(tiles + dst[0] + tile_off(row, dd[0])) = v[t].x;
      *reinterpret_cast<uint32_t*>(tiles + dst[1] + tile_off(row, dd[1])) = v[t].y;
    }
  }
  __syncthreads();

  const int g = lane >> 2, q4 = lane & 3;
  const uint32_t tiles_s = static_cast<uint32_t>(__cvta_generic_to_shared(tiles));
  for (int task = warp; task < a.heads * 4; task += kWarps) {
    const int head = task >> 2, r0 = (task & 3) * 16;
    const uint32_t qs = tiles_s + head * kTileBytes;
    const uint32_t ks = tiles_s + (a.heads + head) * kTileBytes;
    const uint32_t vs = tiles_s + (2 * a.heads + head) * kTileBytes;
    // Q's A fragments, k-steps 0 and 1: matrix m = lane / 8 is rows r0 +
    // 8 (m % 2) .., columns 8 (2 kstep + m / 2) ..
    uint32_t qa[2][4];
#pragma unroll
    for (int kst = 0; kst < 2; ++kst) {
      const int m = lane >> 3, r = r0 + (m & 1) * 8 + (lane & 7);
      esr::ldmatrix_x4(qa[kst], qs + tile_off(r, 16 * kst + 8 * (m >> 1)));
    }
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      // K rows 8 nt .. as B (col): matrices = columns 0, 8, 16, 24
      uint32_t kb[4];
      const int m = lane >> 3;
      esr::ldmatrix_x4(kb, ks + tile_off(8 * nt + (lane & 7), 8 * m));
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
      mma16816(s[nt], qa[0], kb[0], kb[1]);
      mma16816(s[nt], qa[1], kb[2], kb[3]);
    }
    // scale, bias, mask; row maxima (rows r0 + g and r0 + g + 8)
    const float* bh = a.bias + (size_t)head * kTok * kTok;
    const int qi0 = r0 + g, qi1 = r0 + g + 8;
    const int rg0 = reg[qi0], rg1 = reg[qi1];
    float mx0 = -1e30f, mx1 = -1e30f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int kj = 8 * nt + 2 * q4;
      const float2 b0 = __ldg(reinterpret_cast<const float2*>(bh + qi0 * kTok + kj));
      const float2 b1 = __ldg(reinterpret_cast<const float2*>(bh + qi1 * kTok + kj));
      const int rk0 = reg[kj], rk1 = reg[kj + 1];
      s[nt][0] = s[nt][0] * a.scale + b0.x + (rg0 != rk0 ? -100.f : 0.f);
      s[nt][1] = s[nt][1] * a.scale + b0.y + (rg0 != rk1 ? -100.f : 0.f);
      s[nt][2] = s[nt][2] * a.scale + b1.x + (rg1 != rk0 ? -100.f : 0.f);
      s[nt][3] = s[nt][3] * a.scale + b1.y + (rg1 != rk1 ? -100.f : 0.f);
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
    }
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = __expf(s[nt][0] - mx0);
      s[nt][1] = __expf(s[nt][1] - mx0);
      s[nt][2] = __expf(s[nt][2] - mx1);
      s[nt][3] = __expf(s[nt][3] - mx1);
      sum0 += s[nt][0] + s[nt][1];
      sum1 += s[nt][2] + s[nt][3];
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, o);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, o);
    }
    // O = P V: P's A fragment of keys 16 kk .. from S's n-tiles 2 kk, 2 kk + 1
    float acc[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {esr::pack_bf16x2(s[2 * kk][0], s[2 * kk][1]),
                              esr::pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
                              esr::pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              esr::pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        // V rows 16 kk + 8 (m % 2) .., columns 8 (2 np + m / 2) .., transposed
        uint32_t vb[4];
        const int m = lane >> 3;
        ldmatrix_x4_trans(vb, vs + tile_off(16 * kk + 8 * (m & 1) + (lane & 7), 8 * (2 * np + (m >> 1))));
        mma16816(acc[2 * np], pa, vb[0], vb[1]);
        mma16816(acc[2 * np + 1], pa, vb[2], vb[3]);
      }
    }
    const float inv0 = 1.f / sum0, inv1 = 1.f / sum1;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int d = 8 * nt + 2 * q4;
      if (d < a.hd) {
        __nv_bfloat16* st = reinterpret_cast<__nv_bfloat16*>(stage) + head * a.hd + d;
        *reinterpret_cast<uint32_t*>(st + qi0 * c) = esr::pack_bf16x2(acc[nt][0] * inv0, acc[nt][1] * inv0);
        *reinterpret_cast<uint32_t*>(st + qi1 * c) = esr::pack_bf16x2(acc[nt][2] * inv1, acc[nt][3] * inv1);
      }
    }
  }
  __syncthreads();

  // the output rows, 4-byte words (c is even), a warp a token at a time
  for (int t = warp; t < kTok; t += kWarps) {
    const uint32_t* src = reinterpret_cast<const uint32_t*>(stage + t * c * 2);
    uint32_t* dst = reinterpret_cast<uint32_t*>(a.out + tok[t] * c);
    for (int k = lane; k < c / 2; k += 32) dst[k] = src[k];
  }
}

}  // namespace

extern "C" {

// Shared memory of one block: the q, k, v tiles, the output rows, the
// tokens' pixel indices and region ids.
size_t esr_window_attn_smem_bytes(int heads, int hd) {
  return (size_t)3 * heads * kTileBytes + (size_t)kTok * heads * hd * 2 + kTok * (8 + 4);
}

// qkv: (b, hp, wp, 3 heads hd) bf16, 8-byte aligned; bias: (heads, 64, 64)
// f32, 8-byte aligned; out: (b, hp, wp, heads hd) bf16, 4-byte aligned.
// Window 8; hp, wp multiples of 8; hd even, at most 32; heads at most 8; 3
// heads hd a multiple of 4; shift 0 or in (0, 8). Returns 0, a cudaError_t,
// or kErrShape.
int esr_window_attn(const void* qkv, const void* bias, void* out, int b, int hp, int wp, int heads, int hd,
                    int shift, float scale, void* stream) {
  if (b < 0 || hp % kWs || wp % kWs || hd < 2 || hd > kHd || hd % 2 || heads < 1 || heads > kMaxHeads ||
      (3 * heads * hd) % 4 || shift < 0 || shift >= kWs)
    return kErrShape;
  AttnArgs a;
  a.qkv = static_cast<const __nv_bfloat16*>(qkv);
  a.bias = static_cast<const float*>(bias);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.hp = hp; a.wp = wp; a.heads = heads; a.hd = hd; a.shift = shift; a.scale = scale;
  a.windows_x = wp / kWs;
  a.windows_img = (hp / kWs) * a.windows_x;
  const long long blocks = (long long)b * a.windows_img;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return kErrShape;
  const size_t smem = esr_window_attn_smem_bytes(heads, hd);
  cudaError_t err = cudaFuncSetAttribute(window_attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  window_attn_kernel<<<(unsigned)blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

const char* esr_error_string(int err) {
  if (err == kErrShape)
    return "window attention takes window 8, hp and wp multiples of 8, an even head dim up to 32, at most 8 "
           "heads, 3 heads hd a multiple of 4 and a shift in [0, 8)";
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
