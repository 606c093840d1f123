// GELU with erf, shared by the kernels that end in it (token_linear.cu's
// fc1 epilogue, conv3x3.cuh's CAB conv epilogue).
#pragma once

namespace esr {

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

}  // namespace esr
