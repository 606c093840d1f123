// Microbenchmark of the loop rdb5c_tc_kernel runs: RS wgmma m64nNk16 on an
// H100, MT independent 64-row M-tiles per warpgroup, A double-buffered in
// registers by k-step and either reloaded by ldmatrix from a swizzled
// shared-memory window each step (as the kernel does) or kept in registers,
// B from shared memory through a 128B-swizzle descriptor; WG consumer
// warpgroups per block, one block per SM. Prints TFLOP/s per configuration.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -o wgmma_rate tools/wgmma_rate.cu
//   ./wgmma_rate
#include <cstdio>
#include <cuda_runtime.h>
#include "../esr_tpu_torch/ops/cuda/csrc/common.cuh"
#include "../esr_tpu_torch/ops/cuda/csrc/hopper.cuh"

using namespace esr;

template <int N, int MT, bool LDSM, int WAIT, int WG>
__global__ void __launch_bounds__(WG * 128, 1) bench(float* out, int steps) {
  extern __shared__ __align__(1024) unsigned char sm_raw[];
  unsigned char* sm = sm_raw + ((1024 - (smem_addr(sm_raw) & 1023)) & 1023);
  for (int i = threadIdx.x * 16; i < 96 * 1024; i += WG * 128 * 16) *reinterpret_cast<uint4*>(sm + i) = make_uint4(0, 0, 0, 0);
  fence_proxy_async();
  __syncthreads();
  const int lane = threadIdx.x & 31, w4 = (threadIdx.x >> 5) & 3;
  const uint32_t b_s = smem_addr(sm), a_s = b_s + 16384;
  float acc[MT][N / 2];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int v = 0; v < N / 2; ++v) acc[i][v] = 0.f;
  uint32_t af[WAIT + 1][MT][4] = {};
  for (int s0 = 0; s0 < steps; s0 += WAIT + 1) {
#pragma unroll
    for (int u = 0; u <= WAIT; ++u) {
      const int s = s0 + u;
      if (LDSM) {
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const int p = ((s * MT + i) * 64 + 16 * w4 + (lane & 15)) % 576;
          const int q = (s & 3) * 2 + (lane >> 4);
          ldmatrix_x4(af[u][i], a_s + (p * 8 + (q ^ (p & 7))) * 16);
        }
      }
      wgmma_fence();
      const uint64_t desc = wgmma_desc_sw128(b_s + (s & 1) * 8192 + (s & 3) * 32);
#pragma unroll
      for (int i = 0; i < MT; ++i) Wgmma<N>::mma(acc[i], af[u][i], desc);
      wgmma_commit();
      wgmma_wait<WAIT>();
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int r = 0; r < 4; ++r) reg_fence(af[(u + 1) % (WAIT + 1)][i][r]);
    }
  }
  wgmma_wait<0>();
  float t = 0.f;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int v = 0; v < N / 2; ++v) t += acc[i][v];
  if (t == 1.2345f) out[threadIdx.x] = t;
}

template <int N, int MT, bool LDSM, int WAIT, int WG = 2>
void run(const char* name) {
  float* out;
  cudaMalloc(&out, 4096);
  const int smem = 1024 + 96 * 1024, steps = 20000, blocks = 132;
  auto k = bench<N, MT, LDSM, WAIT, WG>;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  k<<<blocks, WG * 128, smem>>>(out, 1000);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  k<<<blocks, WG * 128, smem>>>(out, steps);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0;
  cudaEventElapsedTime(&ms, e0, e1);
  const double flop = 2.0 * blocks * WG * (double)steps * MT * 64 * N * 16;
  printf("%-28s %8.3f ms  %7.1f TFLOP/s  (%s)\n", name, ms, flop / ms / 1e9,
         cudaGetErrorString(cudaGetLastError()));
  cudaFree(out);
}

int main() {
  run<32, 4, false, 1>("n32 mt4 regs 2wg");
  run<64, 2, false, 1>("n64 mt2 regs 2wg");
  run<32, 4, true, 1>("n32 mt4 ldsm 2wg");
  run<32, 5, true, 1>("n32 mt5 ldsm 2wg");
  run<32, 4, true, 2>("n32 mt4 ldsm 2wg wait2");
  run<32, 3, true, 1, 3>("n32 mt3 ldsm 3wg");
  run<32, 2, true, 1, 4>("n32 mt2 ldsm 4wg");
  run<32, 3, true, 1, 4>("n32 mt3 ldsm 4wg");
  run<64, 2, true, 1>("n64 mt2 ldsm 2wg");
  run<64, 2, true, 1, 3>("n64 mt2 ldsm 3wg");
  run<64, 1, true, 1, 4>("n64 mt1 ldsm 4wg");
  run<64, 2, true, 1, 4>("n64 mt2 ldsm 4wg");
  return 0;
}
