// The channel attention of HAT's CAB (hat_arch.py's ChannelAttention, a
// squeeze-excitation) and the HAB residual it feeds, two launches a block:
//
//   s[b, c] = sigmoid(W2 relu(W1 mean_hw(cx[b, :, c]) + b1) + b2)   (C -> C / 30 -> C)
//   r[b, p, c] = u[b, p, c] + scale s[b, c] cx[b, p, c]               (scale: conv_scale, 0.01)
//
// r is the residual that the attention's proj linear adds in its epilogue
// (u + attn + 0.01 CAB(LN1(u)) of a HAB), so token_linear runs as it is.
//
// Replaces no TPU kernel: the JAX package has no HAT. Added because the
// mean is over the whole (padded) map of each image, which every tile of the
// CAB's second conv feeds: a dependency across the map inside every block,
// which a conv epilogue alone cannot close.
//
//   in:  cx (n, hw, ldc) bf16, the CAB's second conv (C channels of ldc: the
//        conv writes whole Cout slices of 64), u (n, hw, C) bf16; w1
//        (hidden, C), b1 (hidden), w2 (C, hidden), b2 (C) f32
//   out: r (n, hw, C) bf16
//
// What bounds it: bytes, cx and u read once and r written once, 2 x 3 C
// bytes a pixel. This design reads cx twice (the mean needs all of it before
// the first product, and at HAT's cell its 277 MB, 138M bf16 elements at
// ldc 192, do not stay in the 50 MB L2), 2 x 4 C bytes a pixel; each launch
// is one streaming pass with 16- or 8-byte loads.
// - ca_pool_kernel: block (part, image) sums its pixels per channel into f32
//   partials, in a fixed order (deterministic); the last block of an image
//   to finish (a counter per image, after a fence) sums the image's
//   partials, squeezes, and writes scale * s[b, :]. The caller zeroes the
//   counters before each launch.
// - ca_scale_kernel: r = u + (scale s) cx, 4 channels a thread, in f32, one
//   rounding to bf16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxC = 256;      // channels (ldc)
constexpr int kMaxHidden = 32;  // squeezed channels
constexpr int kErrShape = -2;

__device__ __forceinline__ float2 unpack(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

struct PoolArgs {
  const __nv_bfloat16* cx;
  const float *w1, *b1, *w2, *b2;
  float* part;     // (n, parts, ldc)
  float* s;        // (n, c): scale * sigmoid(...)
  unsigned* done;  // (n,): the image's blocks that finished; zero at launch
  int hw, c, ldc, hidden, parts;
  float scale;
};

// Block (part p, image b): pixels p, p + parts, ... of image b, rows of
// 16-byte chunks (cpr = ldc / 8 a pixel), thread t on chunk t % cpr of
// every (t / cpr)-th of them.
__global__ void __launch_bounds__(kThreads) ca_pool_kernel(const PoolArgs a) {
  __shared__ float red[kThreads * 8];  // [pixel lane][ldc]
  __shared__ float mean[kMaxC];
  __shared__ float hid[kMaxHidden];
  __shared__ bool last;
  const int tid = threadIdx.x, p = blockIdx.x, b = blockIdx.y;
  const int cpr = a.ldc / 8, lanes = kThreads / cpr, lane_px = tid / cpr, q = tid % cpr;
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (lane_px < lanes) {
    const uint4* src = reinterpret_cast<const uint4*>(a.cx + (size_t)b * a.hw * a.ldc) + q;
#pragma unroll 4
    for (int px = p + a.parts * lane_px; px < a.hw; px += a.parts * lanes) {
      const uint4 v = __ldg(src + (size_t)px * cpr);
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = unpack(w[i]);
        acc[2 * i] += f.x;
        acc[2 * i + 1] += f.y;
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) red[lane_px * a.ldc + 8 * q + i] = acc[i];
  }
  __syncthreads();
  float* part = a.part + (size_t)b * a.parts * a.ldc;
  for (int ch = tid; ch < a.ldc; ch += kThreads) {
    float sum = 0.f;
    for (int l = 0; l < lanes; ++l) sum += red[l * a.ldc + ch];
    part[(size_t)p * a.ldc + ch] = sum;
  }
  __threadfence();  // the partials are visible before the count says so
  __syncthreads();
  if (tid == 0) last = atomicAdd(&a.done[b], 1u) == (unsigned)a.parts - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the image's last block: the mean, the squeeze, the scale
  for (int ch = tid; ch < a.c; ch += kThreads) {
    float sum = 0.f;
    for (int k = 0; k < a.parts; ++k) sum += __ldcg(part + (size_t)k * a.ldc + ch);
    mean[ch] = sum / (float)a.hw;
  }
  __syncthreads();
  const int lane = tid & 31, warp = tid >> 5;
  for (int j = warp; j < a.hidden; j += kThreads / 32) {
    float dot = 0.f;
    for (int ch = lane; ch < a.c; ch += 32) dot += a.w1[j * a.c + ch] * mean[ch];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
    if (lane == 0) hid[j] = fmaxf(dot + a.b1[j], 0.f);
  }
  __syncthreads();
  for (int ch = tid; ch < a.c; ch += kThreads) {
    float z = a.b2[ch];
    for (int j = 0; j < a.hidden; ++j) z += a.w2[ch * a.hidden + j] * hid[j];
    a.s[(size_t)b * a.c + ch] = a.scale / (1.f + expf(-z));
  }
}

struct ScaleArgs {
  const __nv_bfloat16* cx;
  const __nv_bfloat16* u;
  const float* s;  // (n, c)
  __nv_bfloat16* out;
  int hw, c, ldc;
};

// Block (x, image b): pixels of image b in steps of gridDim.x * ppi, thread t
// on 4-channel group t % (c / 4) of pixel t / (c / 4) of each step.
__global__ void __launch_bounds__(kThreads) ca_scale_kernel(const ScaleArgs a) {
  __shared__ float sv[kMaxC];
  const int tid = threadIdx.x, b = blockIdx.y, groups = a.c / 4, ppi = kThreads / groups;
  for (int ch = tid; ch < a.c; ch += kThreads) sv[ch] = a.s[(size_t)b * a.c + ch];
  __syncthreads();
  const int dp = tid / groups, j = tid % groups;
  if (dp >= ppi) return;
  const float4 s4 = make_float4(sv[4 * j], sv[4 * j + 1], sv[4 * j + 2], sv[4 * j + 3]);
  const size_t img = (size_t)b * a.hw;
#pragma unroll 2
  for (int px = blockIdx.x * ppi + dp; px < a.hw; px += gridDim.x * ppi) {
    const uint2 uv = __ldg(reinterpret_cast<const uint2*>(a.u + (img + px) * a.c) + j);
    const uint2 cv = __ldg(reinterpret_cast<const uint2*>(a.cx + (img + px) * a.ldc) + j);
    const float2 u0 = unpack(uv.x), u1 = unpack(uv.y), c0 = unpack(cv.x), c1 = unpack(cv.y);
    uint2 r;
    r.x = pack(fmaf(s4.x, c0.x, u0.x), fmaf(s4.y, c0.y, u0.y));
    r.y = pack(fmaf(s4.z, c1.x, u1.x), fmaf(s4.w, c1.y, u1.y));
    reinterpret_cast<uint2*>(a.out + (img + px) * a.c)[j] = r;
  }
}

}  // namespace

extern "C" {

// cx: (n, hw, ldc) bf16, 16-byte aligned, ldc a multiple of 8 up to 256;
// u, out: (n, hw, c) bf16, 8-byte aligned, c a multiple of 4 up to ldc; w1:
// (hidden, c), b1: (hidden), w2: (c, hidden), b2: (c) f32, hidden up to 32;
// part: n parts ldc f32; s: n c f32, 16-byte aligned; done: n unsigned,
// zero. Returns 0, a cudaError_t, or kErrShape.
int esr_channel_attn(const void* cx, const void* u, const void* w1, const void* b1, const void* w2,
                     const void* b2, void* part, void* s, void* done, void* out, int n, int hw, int c, int ldc,
                     int hidden, int parts, int blocks_x, float scale, void* stream) {
  if (n < 0 || hw < 1 || c < 4 || c % 4 || ldc < c || ldc % 8 || ldc > kMaxC || hidden < 1 ||
      hidden > kMaxHidden || parts < 1 || parts > 65535 || blocks_x < 1 || blocks_x > 65535 || n > 65535)
    return kErrShape;
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  PoolArgs pa;
  pa.cx = static_cast<const __nv_bfloat16*>(cx);
  pa.w1 = static_cast<const float*>(w1);
  pa.b1 = static_cast<const float*>(b1);
  pa.w2 = static_cast<const float*>(w2);
  pa.b2 = static_cast<const float*>(b2);
  pa.part = static_cast<float*>(part);
  pa.s = static_cast<float*>(s);
  pa.done = static_cast<unsigned*>(done);
  pa.hw = hw; pa.c = c; pa.ldc = ldc; pa.hidden = hidden; pa.parts = parts; pa.scale = scale;
  ca_pool_kernel<<<dim3(parts, n), kThreads, 0, st>>>(pa);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ScaleArgs sa;
  sa.cx = pa.cx;
  sa.u = static_cast<const __nv_bfloat16*>(u);
  sa.s = pa.s;
  sa.out = static_cast<__nv_bfloat16*>(out);
  sa.hw = hw; sa.c = c; sa.ldc = ldc;
  ca_scale_kernel<<<dim3(blocks_x, n), kThreads, 0, st>>>(sa);
  return (int)cudaGetLastError();
}

const char* esr_error_string(int err) {
  if (err == kErrShape)
    return "channel attention takes c a multiple of 4 up to ldc, ldc a multiple of 8 up to 256, a hidden width "
           "of 1-32 and at most 65535 images, parts and blocks";
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
