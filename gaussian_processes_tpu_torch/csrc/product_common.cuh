// What the kernels share: the folded exponential (B4 and B5 in matvec.cuh,
// B4-ARD in ard_matvec.cuh, B6 in ard_pairwise.cu), 16-byte loads of staged
// tiles and the padded stride of staged coordinates (B4-ARD, B6), and
// 16-byte stores of a thread's run of output columns (B2 in pairwise.cu, B6)
// and loads of one (B2a contracted).
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

// the row stride of a staged coordinate tile: D padded to a whole vector
// (or to 2 in float32 for D = 2), so each point's coordinates are aligned
template <typename T, int D>
__host__ __device__ constexpr int padded_dim() {
  constexpr int v = vec_elems<T>();
  return D == 1 ? 1 : (D == 2 ? 2 : (D + v - 1) / v * v);
}

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

// C = vec_elems<T>() values to p[0, C): one 16-byte store when `vec` (p is
// then 16-byte aligned) and all C lie inside the row, else one store per
// value below `valid`
template <typename T, int C>
__device__ __forceinline__ void stv(T* p, const T (&v)[C], int valid, bool vec) {
  static_assert(C * sizeof(T) == 16, "a run of output columns is one 16-byte vector");
  if (vec && valid >= C) {
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
    }
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (c < valid) p[c] = v[c];
    }
  }
}

// the mirror of stv: C = vec_elems<T>() values from p[0, C) of device
// memory, one 16-byte load when `vec` and all C lie inside the row, else one
// load per value below `valid` and 0 past it
template <typename T, int C>
__device__ __forceinline__ void ldg_run(const T* p, T (&v)[C], int valid, bool vec) {
  static_assert(C * sizeof(T) == 16, "a run of columns is one 16-byte vector");
  if (vec && valid >= C) {
    if constexpr (sizeof(T) == 4) {
      const float4 t = *reinterpret_cast<const float4*>(p);
      v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
    } else {
      const double2 t = *reinterpret_cast<const double2*>(p);
      v[0] = t.x; v[1] = t.y;
    }
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = c < valid ? p[c] : T(0);
  }
}

}  // namespace
