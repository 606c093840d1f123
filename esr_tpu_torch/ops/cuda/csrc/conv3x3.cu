// C interface of the implicit-GEMM conv kernels (conv3x3.cuh), loaded with ctypes.
#include <cuda_runtime.h>
#include <string.h>

#include "conv3x3.cuh"

namespace {

// Error codes of the bf16 launch besides cudaError_t values.
constexpr int kErrNoEncoder = -1;       // libcuda has no cuTensorMapEncodeTiled
constexpr int kErrEncodeBase = -1000;   // -1000 - CUresult of cuTensorMapEncodeTiled
constexpr int kErrShape = -2;           // cin or cout the tensor-core kernel does not take
constexpr int kErrRoute = -3;           // no such route

// Routes (kpack_conv.py picks one per call).
constexpr int kRouteF32 = 0;       // conv_kernel<float>
constexpr int kRouteBf16Tc = 1;    // conv_tc_kernel: Cin and Cout up to 64
constexpr int kRouteBf16Simt = 2;  // conv_kernel<__nv_bfloat16>: wider convs

// The SIMT kernel in T (float, or __nv_bfloat16 for a Cin or Cout above
// 64, which the tensor-core kernel does not take).
template <typename T>
int launch_simt(const void* x, const void* wt, const void* bias, void* out, int n, int h, int w,
                int cin, int cout, int cout_pad, int ksize, int act, cudaStream_t stream) {
  esr::ConvArgs<T> a;
  a.x = static_cast<const T*>(x);
  a.wt = static_cast<const T*>(wt);
  a.bias = static_cast<const float*>(bias);
  a.out = static_cast<T*>(out);
  a.n = n; a.h = h; a.w = w; a.cin = cin; a.cout = cout; a.cout_pad = cout_pad;
  a.ksize = ksize; a.act = act;
  const size_t smem = esr::conv_smem_bytes(cin, ksize, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(esr::conv_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int parities = ksize == 2 ? 4 : 1;
  const dim3 grid((w + esr::kTile - 1) / esr::kTile, (h + esr::kTile - 1) / esr::kTile,
                  n * parities);
  esr::conv_kernel<T><<<grid, esr::kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int N, int KS, bool UP>
int launch_tc(const esr::ConvTcArgs& a, cudaStream_t stream) {
  const auto kernel = esr::conv_tc_kernel<N, KS, UP>;
  CUtensorMap xmap, omap;
  memset(&xmap, 0, sizeof(xmap));
  memset(&omap, 0, sizeof(omap));
  int e = 0;
  if (a.use_tma) e = esr::encode_nhwc64_map(&xmap, a.x, a.n, a.h, a.w, esr::kWin, esr::kWin);
  if (e == 0 && N == 64) {  // out: (n, h, w, 64), or (n, h, 2 [pa], w, 2 [pb] x 64) in 2x2 mode
    const cuuint64_t row = (cuuint64_t)a.w * (UP ? 2 : 1) * 64 * 2;  // bytes per output row
    const cuuint64_t strides[4] = {UP ? 256u : 128u, row, UP ? 2 * row : row,
                                   (cuuint64_t)a.h * (UP ? 4 : 1) * a.w * 128};
    e = esr::encode_out_map(&omap, a.out, UP ? 128 : 64, a.w, UP ? 2 : 1, a.h, a.n, strides);
  }
  if (e != 0) return e == -1 ? kErrNoEncoder : kErrEncodeBase - e;
  const size_t smem = esr::conv_tc_smem_bytes(N, UP ? 2 : 3);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, esr::kTcThreads, smem);
  if (err != cudaSuccess) return (int)err;
  // persistent: one wave of blocks; in 2x2 mode two per tile (parity rows 0 and 1)
  const int blocks = (UP ? 2 : 1) * a.n_tiles, resident = sms * (per_sm > 0 ? per_sm : 1);
  int grid = blocks < resident ? blocks : resident;
  if (UP) grid &= ~1;
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
  a.use_tma = cin == 64;
  a.tiles_x = (w + esr::kTile - 1) / esr::kTile;
  a.tiles_y = (h + esr::kTile - 1) / esr::kTile;
  a.n_tiles = n * a.tiles_x * a.tiles_y;
  if (a.n_tiles == 0) return 0;
  const bool up = ksize == 2;
  if (cout_pad == 64 && cout != 64) return kErrShape;
#define ESR_CONV_TC(NN, KK)                                                     \
  if (cout_pad == NN && cin_pad == 16 * KK)                                     \
    return up ? launch_tc<NN, KK, true>(a, stream) : launch_tc<NN, KK, false>(a, stream);
  ESR_CONV_TC(64, 4)
  ESR_CONV_TC(64, 1)
  ESR_CONV_TC(8, 4)
  ESR_CONV_TC(8, 1)
#undef ESR_CONV_TC
  return kErrShape;
}

}  // namespace

extern "C" {

// x: (n, h, w, cin) NHWC; bias: f32 [cout] or null; out: (n, h, w, cout), or
// (n, 2h, 2w, cout) for ksize 2. route 1 (bf16): the tensor-core kernel; wt
// the weight image of conv_kernel_weights, cin_pad 16 or 64 (the K the
// kernel reads per tap), cout_pad 8 (cout <= 8) or 64 (cout == 64). Routes 0
// (f32) and 2 (bf16): the SIMT kernel, wt [parities][ksize^2][cin][cout_pad],
// cin_pad unused. Returns 0, a cudaError_t of the launch, or one of the
// negative codes above.
int esr_conv(int route, const void* x, const void* wt, const void* bias, void* out, int n,
             int h, int w, int cin, int cin_pad, int cout, int cout_pad, int ksize, int act,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (route) {
    case kRouteF32:
      return launch_simt<float>(x, wt, bias, out, n, h, w, cin, cout, cout_pad, ksize, act, s);
    case kRouteBf16Tc:
      return launch_bf16_tc(x, wt, bias, out, n, h, w, cin, cin_pad, cout, cout_pad, ksize, act, s);
    case kRouteBf16Simt:
      return launch_simt<__nv_bfloat16>(x, wt, bias, out, n, h, w, cin, cout, cout_pad, ksize,
                                        act, s);
    default:
      return kErrRoute;
  }
}

// Dynamic shared memory of one block: the tensor-core kernel's depends on
// cout_pad and ksize, the SIMT kernel's on cin, ksize and the type.
size_t esr_conv_smem_bytes(int route, int cin, int cout_pad, int ksize) {
  if (route == kRouteBf16Tc) return esr::conv_tc_smem_bytes(cout_pad, ksize);
  return esr::conv_smem_bytes(cin, ksize, route == kRouteF32 ? sizeof(float) : sizeof(__nv_bfloat16));
}

const char* esr_error_string(int err) {
  if (err == kErrNoEncoder) return "cuTensorMapEncodeTiled not found in libcuda.so.1";
  if (err == kErrShape) return "the tensor-core kernel takes cin_pad 16 or 64, and cout <= 8 or cout == 64";
  if (err == kErrRoute) return "no such route (0: f32 SIMT, 1: bf16 tensor cores, 2: bf16 SIMT)";
  if (err <= kErrEncodeBase) return "cuTensorMapEncodeTiled refused the input's tensor map";
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
