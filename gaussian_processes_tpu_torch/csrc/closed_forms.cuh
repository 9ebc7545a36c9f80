// Closed-form kernel values and hyperparameter derivatives of the pairwise
// kernels (B1, B2a, B2b, B6).  The matrix-free products (B4, B5: matvec.cu)
// evaluate the same functions with every constant folded out of the element.
//
// Each form mirrors, expression for expression, the static k_fn / jac_fn /
// hess_fn of its Python class (models/gaussian.py, models/periodic.py), so
// the kernels and their plain PyTorch twins evaluate the same arithmetic.
// Matern 3/2 and 5/2, RQ and Sum/Product trees extend the Family switch when
// their modules are ported.  The D-dimensional ARD-SE kernel
// (models/ard.py) is not a case of the switch: B6 (matvec.cu) evaluates it
// through ard_k below, B4-ARD (ard_matvec.cuh) in its own pre-scaled form.
//
// Compiled without --use_fast_math: sin and exp are the accurate libm forms,
// never __sinf / __expf.
#pragma once

#include <cuda_runtime.h>

namespace gp {

enum Family : int { kSE = 0, kPeriodic = 1 };

__device__ __forceinline__ float dexp(float v) { return expf(v); }
__device__ __forceinline__ double dexp(double v) { return exp(v); }
__device__ __forceinline__ float dfma(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double dfma(double a, double b, double c) { return fma(a, b, c); }
__device__ __forceinline__ float dsin(float v) { return sinf(v); }
__device__ __forceinline__ double dsin(double v) { return sin(v); }
__device__ __forceinline__ float dcos(float v) { return cosf(v); }
__device__ __forceinline__ double dcos(double v) { return cos(v); }

// Squared exponential, theta = (h, w):  h^2 exp(-d^2 / (2 w^2)).
template <typename T>
struct SEForm {
  static constexpr int P = 2;

  __device__ static T k(T d, const T* th) {
    const T h = th[0], w = th[1];
    const T iw2 = T(1) / (w * w);
    return (h * h) * dexp(T(-0.5) * d * d * iw2);
  }

  __device__ static void jac(T d, const T* th, T* out) {
    const T h = th[0], w = th[1];
    const T d2 = d * d;
    const T iw2 = T(1) / (w * w);
    const T E = dexp(T(-0.5) * d2 * iw2);
    out[0] = T(2) * h * E;
    out[1] = (h * h) * E * d2 * iw2 / w;
  }

  // upper triangle, row-major: (h,h), (h,w), (w,w)
  __device__ static void hess(T d, const T* th, T* out) {
    const T h = th[0], w = th[1];
    const T d2 = d * d;
    const T iw2 = T(1) / (w * w);
    const T iw3 = iw2 / w;
    const T E = dexp(T(-0.5) * d2 * iw2);
    out[0] = T(2) * E;
    out[1] = T(2) * h * E * d2 * iw3;
    out[2] = (h * h) * E * (d2 * d2 * iw3 * iw3 - T(3) * d2 * iw2 * iw2);
  }
};

// Periodic, theta = (h, w, p):  h^2 exp(-2 sin^2(d / (2p)) / w^2).
template <typename T>
struct PeriodicForm {
  static constexpr int P = 3;

  __device__ static T k(T d, const T* th) {
    const T h = th[0], w = th[1], p = th[2];
    const T s = dsin(d / (T(2) * p));
    return (h * h) * dexp(T(-2) * s * s / (w * w));
  }

  __device__ static void jac(T d, const T* th, T* out) {
    const T h = th[0], w = th[1], p = th[2];
    const T u = d / (T(2) * p);
    const T s = dsin(u);
    const T s2u = dsin(T(2) * u);
    const T iw2 = T(1) / (w * w);
    const T E = dexp(T(-2) * s * s * iw2);
    const T g_w = T(4) * s * s * iw2 / w;
    const T g_p = d * s2u * iw2 / (p * p);
    out[0] = T(2) * h * E;
    out[1] = (h * h) * E * g_w;
    out[2] = (h * h) * E * g_p;
  }

  // upper triangle, row-major: (h,h), (h,w), (h,p), (w,w), (w,p), (p,p)
  __device__ static void hess(T d, const T* th, T* out) {
    const T h = th[0], w = th[1], p = th[2];
    const T u = d / (T(2) * p);
    const T s = dsin(u);
    const T s2u = dsin(T(2) * u);
    const T c2u = dcos(T(2) * u);
    const T iw2 = T(1) / (w * w);
    const T ip = T(1) / p;
    const T E = dexp(T(-2) * s * s * iw2);
    const T h2E = (h * h) * E;
    const T g_w = T(4) * s * s * iw2 / w;
    const T g_p = d * s2u * iw2 * ip * ip;
    const T g_ww = T(-12) * s * s * iw2 * iw2;
    const T g_wp = T(-2) * d * s2u * iw2 / w * ip * ip;
    const T g_pp = -d * (d * c2u * ip + T(2) * s2u) * iw2 * ip * ip * ip;
    out[0] = T(2) * E;
    out[1] = T(2) * h * E * g_w;
    out[2] = T(2) * h * E * g_p;
    out[3] = h2E * (g_w * g_w + g_ww);
    out[4] = h2E * (g_w * g_p + g_wp);
    out[5] = h2E * (g_p * g_p + g_pp);
  }
};

// ARD squared exponential over D-dim inputs, theta = (h, w_1..w_D):
// h^2 exp(-1/2 sq) with sq = sum_d ((x_d - x'_d) / w_d)^2, which the caller
// accumulates one dimension at a time (the Pallas body's order).
template <typename T>
__device__ __forceinline__ T ard_k(T sq, T h) {
  return (h * h) * dexp(T(-0.5) * sq);
}

}  // namespace gp
