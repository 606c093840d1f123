// C interface of the fused RDB kernel (rdb5c.cuh), loaded with ctypes.
#include <cuda_runtime.h>
#include <string.h>

#include "rdb5c.cuh"

namespace {

// Error codes of the launch besides cudaError_t values.
constexpr int kErrNoEncoder = -1;      // libcuda has no cuTensorMapEncodeTiled
constexpr int kErrEncodeBase = -1000;  // -1000 - CUresult of cuTensorMapEncodeTiled
constexpr int kErrShape = -2;          // no instance of these nf, gc and tile

template <int NF, int GC, int TILE>
int launch(const void* x, void* out, const void* wimg, const void* const* b, int n, int h, int w,
           cudaStream_t stream) {
  using R = esr::Rdb<NF, GC, TILE>;
  esr::RdbTcArgs a;
  a.wimg = static_cast<const unsigned char*>(wimg);
  for (int k = 0; k < 5; ++k) a.b[k] = static_cast<const float*>(b[k]);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.n = n; a.h = h; a.w = w;
  a.tiles_x = (w + TILE - 1) / TILE;
  a.tiles_y = (h + TILE - 1) / TILE;
  a.n_tiles = n * a.tiles_x * a.tiles_y;
  if (a.n_tiles == 0) return 0;
  CUtensorMap xmap;
  memset(&xmap, 0, sizeof(xmap));
  const int e = esr::encode_nhwc64_map(&xmap, x, n, h, w, R::kWin, R::kWin, NF, NF < 64 ? NF : 64);
  if (e != 0) return e == -1 ? kErrNoEncoder : kErrEncodeBase - e;
  const auto kernel = esr::rdb5c_tc_kernel<NF, GC, TILE>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)R::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, esr::kRdbThreads, R::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  // persistent: at most one wave of blocks, each walking tiles t, t + grid, ..
  const int resident = sms * (per_sm > 0 ? per_sm : 1);
  const int grid = a.n_tiles < resident ? a.n_tiles : resident;
  kernel<<<grid, esr::kRdbThreads, R::kSmemBytes, stream>>>(xmap, a);
  return (int)cudaGetLastError();
}

}  // namespace

// X(nf, gc, tile) for each instance of the kernel (rdb_conv.py's INSTANCES
// lists the same four; <64, 32, 8> is the small-grid tile of nf 64 / gc 32).
#define ESR_RDB_INSTANCES(X) X(32, 16, 16) X(64, 32, 16) X(64, 32, 8) X(128, 64, 8)

extern "C" {

// x, out: (n, h, w, nf) NHWC bf16; wimg: the instance's weight image
// (rdb5c_kernel_weights); b_k: f32 [cout_k]. (nf, gc, tile) names an
// instance (widths padded to it). Returns 0, a cudaError_t of the launch, or
// one of the negative codes above.
int esr_rdb5c(const void* x, void* out, const void* wimg, const void* b1, const void* b2, const void* b3,
              const void* b4, const void* b5, int n, int h, int w, int nf, int gc, int tile, void* stream) {
  const void* b[5] = {b1, b2, b3, b4, b5};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ESR_RDB_LAUNCH(NF, GC, TILE) \
  if (nf == NF && gc == GC && tile == TILE) return launch<NF, GC, TILE>(x, out, wimg, b, n, h, w, s);
  ESR_RDB_INSTANCES(ESR_RDB_LAUNCH)
#undef ESR_RDB_LAUNCH
  return kErrShape;
}

// Dynamic shared memory of one block of an instance (0: no such instance).
size_t esr_rdb5c_smem_bytes(int nf, int gc, int tile) {
#define ESR_RDB_SMEM(NF, GC, TILE) \
  if (nf == NF && gc == GC && tile == TILE) return esr::Rdb<NF, GC, TILE>::kSmemBytes;
  ESR_RDB_INSTANCES(ESR_RDB_SMEM)
#undef ESR_RDB_SMEM
  return 0;
}

// Bytes of an instance's weight image (0: no such instance).
size_t esr_rdb5c_weight_image_bytes(int nf, int gc, int tile) {
#define ESR_RDB_WBYTES(NF, GC, TILE) \
  if (nf == NF && gc == GC && tile == TILE) return esr::Rdb<NF, GC, TILE>::kWBytes;
  ESR_RDB_INSTANCES(ESR_RDB_WBYTES)
#undef ESR_RDB_WBYTES
  return 0;
}

const char* esr_error_string(int err) {
  if (err == kErrNoEncoder) return "cuTensorMapEncodeTiled not found in libcuda.so.1";
  if (err == kErrShape)
    return "no rdb5c_tc_kernel instance of these nf, gc and tile (32/16/16, 64/32/16, 64/32/8, 128/64/8)";
  if (err <= kErrEncodeBase) return "cuTensorMapEncodeTiled refused the input's tensor map";
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
