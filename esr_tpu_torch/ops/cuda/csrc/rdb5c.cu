// C interface of the fused RDB kernels (rdb5c.cuh), loaded with ctypes.
#include <cuda_runtime.h>
#include <string.h>

#include "rdb5c.cuh"

namespace {

// Error codes of the bf16 launch besides cudaError_t values.
constexpr int kErrNoEncoder = -1;      // libcuda has no cuTensorMapEncodeTiled
constexpr int kErrEncodeBase = -1000;  // -1000 - CUresult of cuTensorMapEncodeTiled
constexpr int kErrShape = -2;          // nf, gc or tile the tensor-core kernel does not take
constexpr int kErrRoute = -3;          // no such route

// Routes (rdb_conv.py picks one per call; an f32 RDB is five launches of the
// f32 conv kernel, conv_f32.cuh, from rdb_conv.py, and has no route here).
constexpr int kRouteBf16Tc = 1;    // rdb5c_tc_kernel: nf 64, gc 32, 16 x 16 tiles
constexpr int kRouteBf16Simt = 2;  // rdb5c_kernel: the other widths

// The SIMT kernel in bf16, for the widths the tensor-core kernel does not
// take: any strip x wtile tile, nf and gc multiples of 8 (rdb_conv.py
// zero-pads other widths).
int launch_simt(const void* x, void* out, const void* const* wt, const void* const* b, int n, int h,
                int w, int nf, int gc, int strip, int wtile, cudaStream_t stream) {
  esr::RdbArgs a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.out = static_cast<__nv_bfloat16*>(out);
  for (int k = 0; k < 5; ++k) {
    a.wt[k] = static_cast<const __nv_bfloat16*>(wt[k]);
    a.b[k] = static_cast<const float*>(b[k]);
  }
  a.n = n; a.h = h; a.w = w; a.nf = nf; a.gc = gc; a.strip = strip; a.wtile = wtile;
  const size_t smem = esr::rdb5c_smem_bytes(nf, gc, strip, wtile);
  cudaError_t err = cudaFuncSetAttribute(esr::rdb5c_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((w + wtile - 1) / wtile, (h + strip - 1) / strip, n);
  esr::rdb5c_kernel<<<grid, esr::kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

int launch_tc(const void* x, void* out, const void* wimg, const void* const* b, int n, int h,
                int w, int nf, int gc, int strip, int wtile, cudaStream_t stream) {
  if (nf != 64 || gc != 32 || strip != esr::kRdbTile || wtile != esr::kRdbTile) return kErrShape;
  esr::RdbTcArgs a;
  a.wimg = static_cast<const unsigned char*>(wimg);
  for (int k = 0; k < 5; ++k) a.b[k] = static_cast<const float*>(b[k]);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.n = n; a.h = h; a.w = w;
  a.tiles_x = (w + esr::kRdbTile - 1) / esr::kRdbTile;
  a.tiles_y = (h + esr::kRdbTile - 1) / esr::kRdbTile;
  a.n_tiles = n * a.tiles_x * a.tiles_y;
  if (a.n_tiles == 0) return 0;
  CUtensorMap xmap;
  memset(&xmap, 0, sizeof(xmap));
  const int e = esr::encode_nhwc64_map(&xmap, x, n, h, w, esr::kRdbWin, esr::kRdbWin);
  if (e != 0) return e == -1 ? kErrNoEncoder : kErrEncodeBase - e;
  const size_t smem = esr::rdb_tc_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(esr::rdb5c_tc_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, esr::rdb5c_tc_kernel,
                                                      esr::kRdbThreads, smem);
  if (err != cudaSuccess) return (int)err;
  // persistent: at most one wave of blocks, each walking tiles t, t + grid, ..
  const int resident = sms * (per_sm > 0 ? per_sm : 1);
  const int grid = a.n_tiles < resident ? a.n_tiles : resident;
  esr::rdb5c_tc_kernel<<<grid, esr::kRdbThreads, smem, stream>>>(xmap, a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x, out: (n, h, w, nf) NHWC; b_k: f32 [cout_k]. route 1 (bf16): the
// tensor-core kernel, nf 64, gc 32, 16 x 16 tiles; w1 is the weight image of
// rdb5c_kernel_weights (w2..w5 unused). Route 2 (bf16): the SIMT kernel, any
// strip x wtile tile, w_k [9][cin_k][cout_k] (nf, gc multiples of 8). Returns 0, a cudaError_t of the launch, or one of the
// negative codes above.
int esr_rdb5c(int route, const void* x, void* out, const void* w1, const void* w2,
              const void* w3, const void* w4, const void* w5, const void* b1, const void* b2,
              const void* b3, const void* b4, const void* b5, int n, int h, int w, int nf,
              int gc, int strip, int wtile, void* stream) {
  const void* wt[5] = {w1, w2, w3, w4, w5};
  const void* b[5] = {b1, b2, b3, b4, b5};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (route) {
    case kRouteBf16Tc:
      return launch_tc(x, out, w1, b, n, h, w, nf, gc, strip, wtile, s);
    case kRouteBf16Simt:
      return launch_simt(x, out, wt, b, n, h, w, nf, gc, strip, wtile, s);
    default:
      return kErrRoute;
  }
}

// Dynamic shared memory of one block: the tensor-core kernel's is fixed, the
// SIMT kernel's depends on nf, gc and the tile.
size_t esr_rdb5c_smem_bytes(int route, int nf, int gc, int strip, int wtile) {
  if (route == kRouteBf16Tc) return esr::rdb_tc_smem_bytes();
  return esr::rdb5c_smem_bytes(nf, gc, strip, wtile);
}

// Bytes of the tensor-core kernel's weight image.
size_t esr_rdb5c_weight_image_bytes() { return esr::kRdbWBytes; }

const char* esr_error_string(int err) {
  if (err == kErrNoEncoder) return "cuTensorMapEncodeTiled not found in libcuda.so.1";
  if (err == kErrShape) return "the tensor-core kernel takes nf 64, gc 32 and 16 x 16 tiles";
  if (err == kErrRoute) return "no such route (1: bf16 tensor cores, 2: bf16 SIMT)";
  if (err <= kErrEncodeBase) return "cuTensorMapEncodeTiled refused the input's tensor map";
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
