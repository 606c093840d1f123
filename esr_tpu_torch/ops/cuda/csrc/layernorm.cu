// LayerNorm over the last axis of contiguous bf16 rows, one launch a
// LayerNorm: SwinIR's patch_embed.norm, each Swin block's norm1 and norm2,
// and its final norm (models/blocks.py::LayerNorm).
//
//   y[t, i] = (x[t, i] - mean_t) * rstd_t * w[i] + b[i]
//   mean_t = sum_i x[t, i] / C,  rstd_t = rsqrt(sum_i (x[t, i] - mean_t)^2 / C + eps)
//
// with the statistics and the affine step in f32, bf16 in and out, as torch's
// vectorized_layer_norm_kernel computes it for bf16. The variance is taken
// about the mean (two passes over registers), not as E[x^2] - E[x]^2.
//
// Replaces no TPU kernel: the JAX package has no LayerNorm. Added because
// torch's kernel, which gives one block to each row (a 360-byte row at
// SwinIR-M's C 180), ran the 74 LayerNorms of a SwinIR-M forward at ~0.89 ms
// a launch on B4 x 344 x 512 tokens: 17% of the byte bound, a quarter of the
// forward.
//
// What bounds it: bytes. Each token is read once and written once, 4 C bytes
// against ~8 C FLOP; at 704,512 tokens of 180 channels a launch moves 507 MB,
// 0.151 ms at 3.35 TB/s. So the design moves each byte once, in 16-byte
// coalesced accesses, and keeps loads in flight while rows are reduced:
//  - a run is two consecutive rows, 4 C bytes. With C a multiple of 4 that is
//    a whole number of 16-byte chunks, so every run starts 16-byte aligned
//    (the wrapper aligns the tensor's start). A warp's lanes take a run's
//    consecutive chunks, chunk k by lane k % 32 (at C 180, 45 chunks: lanes
//    0-31, then 0-12). A chunk straddles the two rows only at its middle
//    (C % 8 == 4), so each 8-byte half, 4 channels, belongs to one row;
//  - a warp walks its stages grid-stride, kRuns consecutive runs a stage
//    (2,880 bytes at C 180), through a ring of kStages stages in shared
//    memory filled by cp.async: while it reduces one stage, the next
//    kStages - 1 are in flight (~92 KB an SM at C 180: 16 warps x 2 stages).
//    Each lane reads back only the chunks it copied, so no warp waits on
//    another. Measured on the H100 against loads into registers (the whole
//    stage issued, then reduced, 122 registers): 0.194 against 0.212 ms at
//    the cell's shape;
//  - a row's mean and variance are warp shuffles over the registers that hold
//    it: no row is read twice from device memory. Every run puts a lane on
//    the same channels, so its w and b (bf16) are read once, into registers;
//  - the grid is the SMs times the blocks an SM holds, fewer for a short
//    input;
//  - the ragged end: an odd row count leaves a last run of one row, whose
//    last chunk may lie half in the tensor (8 bytes), copied (the rest
//    zero-filled) and stored so.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRuns = 4;       // runs a stage
constexpr int kStages = 3;     // stages of a warp's ring: kStages - 1 in flight while one is reduced
constexpr int kMaxC = 256;     // at most 64 chunks a run: two a lane
constexpr int kErrShape = -2;  // a width the kernel does not take
constexpr int kStageSlots = kRuns * 2 * 32;  // 16-byte slots a stage: each lane's two chunks of each run
constexpr size_t kSmemBytes = (size_t)kWarps * kStages * kStageSlots * 16;

struct LnArgs {
  const __nv_bfloat16* x;
  const __nv_bfloat16* w;
  const __nv_bfloat16* b;
  __nv_bfloat16* y;
  long long runs;   // ceil(rows / 2)
  long long elems;  // rows * c
  int c;
  int chunks;       // 16-byte chunks of a run: c / 4
  float eps;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float2 unpack(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// 16 bytes from global src to shared dst, asynchronously, through L2 only;
// the src_bytes (16, 8 or 0) first are read, the rest written as zeros.
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__global__ void __launch_bounds__(kThreads) layernorm_kernel(LnArgs a) {
  extern __shared__ uint4 ring[];
  const int lane = threadIdx.x & 31;
  const long long warp = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long step = (long long)gridDim.x * kWarps * kRuns;
  // the lane's own slots: it reads back only what it copied, so no warp sync
  uint4* mine = ring + (threadIdx.x >> 5) * kStages * kStageSlots + lane;

  bool has[2], row1[4];
  uint2 wh[4], bh[4];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    has[j] = lane + 32 * j < a.chunks;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int h = 2 * j + s;
      const int e = 8 * (lane + 32 * j) + 4 * s;
      row1[h] = e >= a.c;
      const int ch = row1[h] ? e - a.c : e;
      wh[h] = has[j] ? __ldg(reinterpret_cast<const uint2*>(a.w + ch)) : make_uint2(0, 0);
      bh[h] = has[j] ? __ldg(reinterpret_cast<const uint2*>(a.b + ch)) : make_uint2(0, 0);
    }
  }

  // stage t of the walk: runs warp kRuns + t step .. + kRuns - 1, into ring slot t % kStages
  auto issue = [&](long long t) {
    const long long r0 = warp * kRuns + t * step;
    if (r0 < a.runs) {
      uint4* slot = mine + (int)(t % kStages) * kStageSlots;
#pragma unroll
      for (int u = 0; u < kRuns; ++u) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const long long e = (r0 + u) * 2 * a.c + 8 * (lane + 32 * j);
          const int bytes = !has[j] || e >= a.elems ? 0 : e + 8 <= a.elems ? 16 : 8;
          cp_async16_zfill(slot + (2 * u + j) * 32, bytes ? a.x + e : a.x, bytes);
        }
      }
    }
    esr::cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) issue(t);

  for (long long t = 0, r0 = warp * kRuns; r0 < a.runs; ++t, r0 += step) {
    issue(t + kStages - 1);
    esr::cp_async_wait<kStages - 1>();
    const uint4* slot = mine + (int)(t % kStages) * kStageSlots;
#pragma unroll
    for (int u = 0; u < kRuns; ++u) {
      uint4 v[2];
      v[0] = slot[(2 * u) * 32];
      v[1] = slot[(2 * u + 1) * 32];
      float x[4][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float2 p0 = unpack(v[j].x), p1 = unpack(v[j].y), p2 = unpack(v[j].z), p3 = unpack(v[j].w);
        x[2 * j][0] = p0.x; x[2 * j][1] = p0.y; x[2 * j][2] = p1.x; x[2 * j][3] = p1.y;
        x[2 * j + 1][0] = p2.x; x[2 * j + 1][1] = p2.y; x[2 * j + 1][2] = p3.x; x[2 * j + 1][3] = p3.y;
      }
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const float s = (x[h][0] + x[h][1]) + (x[h][2] + x[h][3]);
        if (row1[h]) s1 += s; else s0 += s;
      }
      const float m0 = warp_sum(s0) / a.c, m1 = warp_sum(s1) / a.c;
      float q0 = 0.f, q1 = 0.f;
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        if (!has[h / 2]) continue;  // zeros that are no channel
        const float m = row1[h] ? m1 : m0;
        float q = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) q += (x[h][i] - m) * (x[h][i] - m);
        if (row1[h]) q1 += q; else q0 += q;
      }
      const float rs0 = rsqrtf(warp_sum(q0) / a.c + a.eps), rs1 = rsqrtf(warp_sum(q1) / a.c + a.eps);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const long long e = (r0 + u) * 2 * a.c + 8 * (lane + 32 * j);
        if (!has[j] || e >= a.elems) continue;
        uint32_t o[4];
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const int h = 2 * j + s;
          const float m = row1[h] ? m1 : m0, rs = row1[h] ? rs1 : rs0;
          const float2 w01 = unpack(wh[h].x), w23 = unpack(wh[h].y);
          const float2 b01 = unpack(bh[h].x), b23 = unpack(bh[h].y);
          o[2 * s] = esr::pack_bf16x2(w01.x * (rs * (x[h][0] - m)) + b01.x, w01.y * (rs * (x[h][1] - m)) + b01.y);
          o[2 * s + 1] = esr::pack_bf16x2(w23.x * (rs * (x[h][2] - m)) + b23.x, w23.y * (rs * (x[h][3] - m)) + b23.y);
        }
        if (e + 8 <= a.elems) {
          *reinterpret_cast<uint4*>(a.y + e) = make_uint4(o[0], o[1], o[2], o[3]);
        } else {
          *reinterpret_cast<uint2*>(a.y + e) = make_uint2(o[0], o[1]);
        }
      }
    }
  }
  esr::cp_async_wait<0>();
}

// The ring's shared memory allowed on the current device, and the blocks an
// SM holds at once (asked once, on the first call: outside any graph
// capture, since the forward's warm-up runs before its capture).
cudaError_t blocks_per_sm(int* n) {
  static int per_sm = 0;
  cudaError_t err =
      cudaFuncSetAttribute(layernorm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err == cudaSuccess && per_sm == 0)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, layernorm_kernel, kThreads, kSmemBytes);
  *n = per_sm;
  return err;
}

}  // namespace

extern "C" {

// x, y: (rows, c) bf16, 16-byte aligned; w, b: (c,) bf16, 8-byte aligned;
// c a multiple of 4 in [4, 256]; sms: the card's SMs. The grid: a block a
// kWarps x kRuns runs, at most the blocks the SMs hold at once. Launches on
// stream, allocates nothing. Returns 0, a cudaError_t, or kErrShape.
int esr_layernorm(const void* x, const void* w, const void* b, void* y, long long rows, int c, float eps, int sms,
                  void* stream) {
  if (rows < 0 || c < 4 || c > kMaxC || c % 4 || sms < 1) return kErrShape;
  if (rows == 0) return 0;
  int per_sm = 0;
  const cudaError_t err = blocks_per_sm(&per_sm);
  if (err != cudaSuccess) return (int)err;
  const long long runs = (rows + 1) / 2, per_block = (long long)kWarps * kRuns;
  const long long need = (runs + per_block - 1) / per_block, most = (long long)sms * per_sm;
  const long long blocks = need < most ? need : most;
  LnArgs a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.w = static_cast<const __nv_bfloat16*>(w);
  a.b = static_cast<const __nv_bfloat16*>(b);
  a.y = static_cast<__nv_bfloat16*>(y);
  a.runs = runs;
  a.elems = rows * c;
  a.c = c;
  a.chunks = c / 4;
  a.eps = eps;
  layernorm_kernel<<<(unsigned)blocks, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

const char* esr_error_string(int err) {
  if (err == kErrShape) return "layernorm takes rows of a width that is a multiple of 4 in [4, 256]";
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
