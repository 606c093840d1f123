// C interface of the implicit-GEMM conv kernels (conv3x3.cuh: bf16 on the
// tensor cores; conv_f32.cuh: f32 on the FP32 units), loaded with ctypes.
#include <cuda_runtime.h>
#include <string.h>

#include "conv3x3.cuh"
#include "conv_f32.cuh"

namespace {

// Error codes of the launches besides cudaError_t values.
constexpr int kErrNoEncoder = -1;       // libcuda has no cuTensorMapEncodeTiled
constexpr int kErrEncodeBase = -1000;   // -1000 - CUresult of cuTensorMapEncodeTiled
constexpr int kErrShape = -2;           // cin or cout the tensor-core kernel does not take
constexpr int kErrF32Shape = -4;        // an N, mode or residual the f32 kernel does not take

// conv_f32_kernel<N, UP>: one block per (tile, Cout slice), slice-minor.
template <int N, bool UP>
int launch_f32(const esr::ConvF32Args& a, cudaStream_t stream) {
  const auto kernel = esr::conv_f32_kernel<N, UP>;
  const size_t smem = esr::conv_f32_smem_bytes(N, UP);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // shared memory before L1: two (N 64) to eight (N 8) blocks an SM
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)a.n * a.tiles_x * a.tiles_y * a.slices;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return kErrF32Shape;
  kernel<<<(unsigned)blocks, 4 * N, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// GELU: conv_tc_kernel_gelu, else conv_tc_kernel.
template <int N, int KS, bool UP, int KC, bool SLICED, bool GELU = false>
int launch_tc(const esr::ConvTcArgs& a, cudaStream_t stream) {
  auto kernel = esr::conv_tc_kernel<N, KS, UP, KC, SLICED>;
  if constexpr (GELU) kernel = esr::conv_tc_kernel_gelu<N, KS, UP, KC, SLICED>;
  CUtensorMap xmap, omap;
  memset(&xmap, 0, sizeof(xmap));
  memset(&omap, 0, sizeof(omap));
  int e = 0;
  if (a.use_tma) e = esr::encode_nhwc64_map(&xmap, a.x, a.n, a.h, a.w, esr::kWin, esr::kWin, a.cin);
  if (e == 0 && N == 64) {
    // out: (n, h, w, C), or (n, h, 2 [pa], w, 2 [pb] x C) in 2x2 mode, C = 64 slices
    const cuuint64_t px = (cuuint64_t)(UP ? 2 : 1) * 64 * a.slices * 2;  // bytes per x step
    const cuuint64_t row = (cuuint64_t)a.w * px;                          // bytes per output row
    const cuuint64_t strides[4] = {px, row, UP ? 2 * row : row, (cuuint64_t)a.h * (UP ? 2 : 1) * row};
    e = esr::encode_out_map(&omap, a.out, (UP ? 2 : 1) * 64 * a.slices, a.w, UP ? 2 : 1, a.h, a.n, strides);
  }
  if (e != 0) return e == -1 ? kErrNoEncoder : kErrEncodeBase - e;
  const size_t smem = esr::conv_tc_smem_bytes(N, UP ? 2 : 3, KC);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, esr::kTcThreads, smem);
  if (err != cudaSuccess) return (int)err;
  // persistent: one wave of blocks, a multiple of the roles (parity rows of
  // the 2x2 mode x Cout slices), each role on every tile
  const int roles = (UP ? 2 : 1) * a.slices;
  const int blocks = roles * a.n_tiles, resident = sms * (per_sm > 0 ? per_sm : 1);
  int grid = blocks < resident ? blocks : resident;
  grid -= grid % roles;
  if (grid == 0) return kErrShape;
  kernel<<<grid, esr::kTcThreads, smem, stream>>>(xmap, omap, a);
  return (int)cudaGetLastError();
}

int launch_bf16_tc(const void* x, const void* wt, const void* bias, void* out, int n, int h,
                   int w, int cin, int cin_pad, int cout, int cout_pad, int ksize, int act,
                   cudaStream_t stream) {
  esr::ConvTcArgs a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.wt = static_cast<const __nv_bfloat16*>(wt);
  a.bias = static_cast<const float*>(bias);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.n = n; a.h = h; a.w = w; a.cin = cin; a.cout = cout; a.act = act;
  a.slices = cout_pad == 8 ? 1 : cout_pad / 64;
  a.use_tma = cin % 64 == 0;
  a.tiles_x = (w + esr::kTile - 1) / esr::kTile;
  a.tiles_y = (h + esr::kTile - 1) / esr::kTile;
  a.n_tiles = n * a.tiles_x * a.tiles_y;
  if (a.n_tiles == 0) return 0;
  const bool up = ksize == 2, sliced = a.slices > 1;
  const int kc = esr::conv_tc_kchunks(cin);
  // N = 64 writes whole slices (cout == cout_pad); N = 8 masks cout <= 8
  const bool n64 = cout_pad % 64 == 0 && cout == cout_pad && a.slices <= esr::kTcMaxSlices;
  if (!(n64 || (cout_pad == 8 && cout <= 8)) || cin > 64 * esr::kTcMaxChunks) return kErrShape;
  if (act == 2 && kc != 3) return kErrShape;  // lrelu_0.01: the Cin 129-192 instances alone
  if (act == 3) {  // GELU: Cin 129-192 (a multiple of 4), 3x3, one Cout slice of 64
    if (n64 && !up && !sliced && kc == 3 && cin_pad == 192 && cin % 4 == 0)
      return launch_tc<64, 4, false, 3, false, true>(a, stream);
    return kErrShape;
  }
#define ESR_CONV_TC(NN, KK, CC, SL)                                                          \
  if ((NN == 64 ? n64 : cout_pad == 8) && cin_pad == (KK == 1 ? 16 : 64 * CC) && kc == CC && \
      sliced == SL)                                                                          \
    return up ? launch_tc<NN, KK, true, CC, SL>(a, stream) : launch_tc<NN, KK, false, CC, SL>(a, stream);
  ESR_CONV_TC(64, 4, 1, false)
  ESR_CONV_TC(64, 1, 1, false)
  ESR_CONV_TC(64, 4, 2, false)
  ESR_CONV_TC(64, 4, 1, true)
  ESR_CONV_TC(64, 1, 1, true)
  ESR_CONV_TC(64, 4, 2, true)
  ESR_CONV_TC(8, 4, 1, false)
  ESR_CONV_TC(8, 1, 1, false)
  ESR_CONV_TC(8, 4, 2, false)
#undef ESR_CONV_TC
  // Cin 129-192: 3x3, Cout a multiple of 64, Cin a multiple of 4 (streamed weights)
  if (n64 && !up && kc == 3 && cin_pad == 192 && cin % 4 == 0)
    return sliced ? launch_tc<64, 4, false, 3, true>(a, stream) : launch_tc<64, 4, false, 3, false>(a, stream);
  return kErrShape;
}

}  // namespace

extern "C" {

// The bf16 tensor-core kernel. x: (n, h, w, cin) NHWC bf16; bias: f32
// [cout] or null; out: (n, h, w, cout), or (n, 2h, 2w, cout) for ksize 2; wt
// the weight image of conv_kernel_weights, cin_pad 16 (cin <= 16), 64, 128 or
// 192 (64 per K chunk; 192: 3x3, cout a multiple of 64, cin a multiple of 4),
// cout_pad 8 (cout <= 8) or cout itself, a multiple of 64 up to 1024; act 0
// (none), 1 (lrelu_0.2), 2 (lrelu_0.01, cin_pad 192 only) or 3 (GELU with
// erf, cin_pad 192 and cout 64 only). Returns 0, a
// cudaError_t of the launch, or one of the negative codes above.
int esr_conv(const void* x, const void* wt, const void* bias, void* out, int n, int h, int w,
             int cin, int cin_pad, int cout, int cout_pad, int ksize, int act, void* stream) {
  return launch_bf16_tc(x, wt, bias, out, n, h, w, cin, cin_pad, cout, cout_pad, ksize, act,
                        static_cast<cudaStream_t>(stream));
}

// The f32 kernel: out[..., out_c0 + o] (pixels out_ld floats apart) = the
// conv of concat(xa[..., :cin_a], xb[..., :cin_b]) (pixels lda / ldb floats
// apart, 4-byte aligned) + bias, lrelu if act, then res + res_scale * that
// if res (3x3 only; pixels res_ld apart). wt: conv_kernel_weights' f32 layout
// [slice][chunk][parity][tap][8][n_width], 16-byte aligned; bias: f32
// [slices * n_width] or null; n_width 8, 16, 32 or 64 (Cout above 64 in
// slices of 64); ksize 3 or 2. Returns as esr_conv.
int esr_conv_f32(const void* xa, int lda, int cin_a, const void* xb, int ldb, int cin_b,
                 const void* wt, const void* bias, void* out, int out_ld, int out_c0,
                 const void* res, int res_ld, float res_scale, int n, int h, int w, int cout,
                 int n_width, int ksize, int act, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool up = ksize == 2;
  if ((ksize != 2 && ksize != 3) || (up && res != nullptr) || cout < 1 || cin_a + cin_b < 1)
    return kErrF32Shape;
  esr::ConvF32Args a;
  a.xa = static_cast<const float*>(xa);
  a.xb = static_cast<const float*>(xb);
  a.lda = lda; a.ldb = ldb; a.cin_a = cin_a; a.cin_b = cin_b;
  a.wt = static_cast<const float*>(wt);
  a.bias = static_cast<const float*>(bias);
  a.out = static_cast<float*>(out);
  a.out_ld = out_ld; a.out_c0 = out_c0;
  a.res = static_cast<const float*>(res);
  a.res_ld = res_ld; a.res_scale = res_scale;
  a.n = n; a.h = h; a.w = w; a.cout = cout; a.act = act;
  a.slices = (cout + n_width - 1) / n_width;
  a.chunks = (cin_a + cin_b + esr::kF32Kc - 1) / esr::kF32Kc;
  const int tile = up ? esr::F32Geo<true>::TH : esr::F32Geo<false>::TH;
  a.tiles_x = (w + tile - 1) / tile;
  a.tiles_y = (h + tile - 1) / tile;
  const auto al16 = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  a.vec = out_ld % 4 == 0 && out_c0 % 4 == 0 && al16(out) &&
          (res == nullptr || (res_ld % 4 == 0 && al16(res)));
  if (up) {
    if (n_width == 64) return launch_f32<64, true>(a, s);
    if (n_width == 32) return launch_f32<32, true>(a, s);
    if (n_width == 16) return launch_f32<16, true>(a, s);
    if (n_width == 8) return launch_f32<8, true>(a, s);
  } else {
    if (n_width == 64) return launch_f32<64, false>(a, s);
    if (n_width == 32) return launch_f32<32, false>(a, s);
    if (n_width == 16) return launch_f32<16, false>(a, s);
    if (n_width == 8) return launch_f32<8, false>(a, s);
  }
  return kErrF32Shape;
}

const char* esr_error_string(int err) {
  if (err == kErrNoEncoder) return "cuTensorMapEncodeTiled not found in libcuda.so.1";
  if (err == kErrShape)
    return "the tensor-core kernel takes cin up to 128 (cin_pad 16, 64 or 128) and cout <= 8 "
           "(cout_pad 8) or cout == cout_pad, a multiple of 64 up to 1024; or, in 3x3 mode, cin 129-192 "
           "(a multiple of 4, cin_pad 192) and cout a multiple of 64; act 2 (lrelu_0.01) with cin_pad 192 only, "
           "act 3 (GELU) with cin_pad 192 and cout 64 only";
  if (err == kErrF32Shape)
    return "the f32 kernel takes n_width 8, 16, 32 or 64, ksize 3 or 2 (a residual in 3x3 mode only), "
           "cout >= 1, cin >= 1 and fewer than 2^31 blocks";
  if (err <= kErrEncodeBase) return "cuTensorMapEncodeTiled refused the input's tensor map";
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
