// What the matrix-free products share (B4 and B5 in matvec.cu, B4-ARD in
// ard_matvec.cuh): the folded exponential and 16-byte loads of staged tiles.
#pragma once

#include <cuda_runtime.h>

namespace {

// 2^-sq in one MUFU instruction: ex2.approx is within 2 ulp (as exp2f is,
// which adds only the subnormal range: k < 2^-126 flushes to 0 here)
__device__ __forceinline__ float neg_exp(float sq) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(-sq));
  return y;
}
__device__ __forceinline__ double neg_exp(double sq) { return exp(-sq); }

// values per 16-byte vector
template <typename T>
__host__ __device__ constexpr int vec_elems() { return 16 / static_cast<int>(sizeof(T)); }

// N consecutive values from shared memory, 16 bytes at a time where N allows
template <int N>
__device__ __forceinline__ void ldv(const float* p, float (&o)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 t = reinterpret_cast<const float4*>(p)[i];
      o[4 * i] = t.x; o[4 * i + 1] = t.y; o[4 * i + 2] = t.z; o[4 * i + 3] = t.w;
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float2 t = reinterpret_cast<const float2*>(p)[i];
      o[2 * i] = t.x; o[2 * i + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = p[i];
  }
}

template <int N>
__device__ __forceinline__ void ldv(const double* p, double (&o)[N]) {
  if constexpr (N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const double2 t = reinterpret_cast<const double2*>(p)[i];
      o[2 * i] = t.x; o[2 * i + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = p[i];
  }
}

}  // namespace
