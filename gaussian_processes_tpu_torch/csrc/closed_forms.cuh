// Closed-form kernel values and hyperparameter derivatives of the pairwise
// kernels.  B2a and B2b (pairwise.cuh) evaluate the derivative forms below;
// B1 (pairwise.cuh) and B4 (matvec.cuh) evaluate one folded element, the
// same in both (the second half of this file); B5 folds its own values
// (matvec.cuh).
//
// Each form's jac / hess mirrors, expression for expression, the static
// jac_fn / hess_fn of its Python class (models/gaussian.py,
// models/periodic.py, models/matern.py, models/rq.py), so the kernels and
// their plain PyTorch twins evaluate the same arithmetic.  HessValue<V> is
// one value of hess, the upper-triangle entry V; SE's and periodic's fold
// every factor that does not depend on the element into constants once per
// launch, the others evaluate hess and keep value V (HessFromFull); the
// plain PyTorch version is ops/pairwise.py::hessian_plane_folded.
//
// The folded element (LeafValue, TreeValue) takes every constant out of the
// element and gives an exponent and a multiplier per leaf, so a product of
// leaves costs one exponential; a Sum/Product tree of leaves
// (models/composite.py) reaches the kernels as a sum of products expanded
// on the host (TreeProgram).  The D-dimensional ARD-SE kernel
// (models/ard.py) is not a leaf: B6 (ard_pairwise.cu) and B4-ARD
// (ard_matvec.cuh) evaluate it on pre-scaled coordinates.
//
// Compiled without --use_fast_math: the forms' sin, exp and log1p are the
// accurate libm forms, never __sinf / __expf; the folded element takes
// ex2.approx (neg_exp, 2 ulp), lg2.approx (RQ, log1p_base) and a sine
// reduced by hand (sin_reduced) in float32, exp, log and sin in float64.
#pragma once

#include <cuda_runtime.h>

#include "product_common.cuh"

namespace gp {

enum Family : int { kSE = 0, kPeriodic = 1, kMatern32 = 2, kMatern52 = 3, kRQ = 4, kTree = 5 };

__device__ __forceinline__ float dexp(float v) { return expf(v); }
__device__ __forceinline__ double dexp(double v) { return exp(v); }
__device__ __forceinline__ float dfma(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double dfma(double a, double b, double c) { return fma(a, b, c); }
__device__ __forceinline__ float dsin(float v) { return sinf(v); }
__device__ __forceinline__ double dsin(double v) { return sin(v); }
__device__ __forceinline__ float dcos(float v) { return cosf(v); }
__device__ __forceinline__ double dcos(double v) { return cos(v); }
__device__ __forceinline__ float dabs(float v) { return fabsf(v); }
__device__ __forceinline__ double dabs(double v) { return fabs(v); }
__device__ __forceinline__ float dlog1p(float v) { return log1pf(v); }
__device__ __forceinline__ double dlog1p(double v) { return log1p(v); }

// one upper-triangle value V of Form::hess, evaluated with the whole
// triangle and the rest dropped (the compiler removes what V does not use)
template <typename T, typename Form, int V>
struct HessFromFull {
  static_assert(V >= 0 && V < Form::P * (Form::P + 1) / 2, "no such Hessian value");
  T th[Form::P];
  __device__ explicit HessFromFull(const T* params) {
#pragma unroll
    for (int q = 0; q < Form::P; ++q) th[q] = params[q];
  }
  __device__ __forceinline__ T operator()(T d) const {
    T out[Form::P * (Form::P + 1) / 2];
    Form::hess(d, th, out);
    return out[V];
  }
};

// Squared exponential, theta = (h, w):  h^2 exp(-d^2 / (2 w^2)).
template <typename T>
struct SEForm {
  static constexpr int P = 2;

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

  // E = exp(a d^2), a = -1 / (2 w^2).  V = 0 (h,h): 2 E; V = 1 (h,w):
  // c1 d^2 E, c1 = 2h / w^3; V = 2 (w,w): d^2 E (c1 d^2 + c2), c1 = h^2 / w^6,
  // c2 = -3 h^2 / w^4
  template <int V>
  struct HessValue {
    static_assert(V >= 0 && V < 3, "SE's Hessian has three upper-triangle values");
    T a, c1, c2;
    __device__ explicit HessValue(const T* th) {
      const T h = th[0], w = th[1];
      const T iw2 = T(1) / (w * w);
      a = T(-0.5) * iw2;
      c1 = V == 0 ? T(2) : (V == 1 ? T(2) * h * iw2 / w : (h * h) * (iw2 * iw2 * iw2));
      c2 = T(-3) * (h * h) * (iw2 * iw2);
    }
    __device__ __forceinline__ T operator()(T d) const {
      const T d2 = d * d;
      const T E = dexp(a * d2);
      if constexpr (V == 0) {
        return c1 * E;
      } else if constexpr (V == 1) {
        return c1 * (d2 * E);
      } else {
        return (d2 * E) * dfma(c1, d2, c2);
      }
    }
  };
};

// Periodic, theta = (h, w, p):  h^2 exp(-2 sin^2(d / (2p)) / w^2).
template <typename T>
struct PeriodicForm {
  static constexpr int P = 3;

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

  // u = d i2p, i2p = 1 / (2p), s = sin u, E = exp(a s^2), a = -2 / w^2.
  // V = 0 (h,h): 2 E; 1 (h,w): c1 s^2 E, c1 = 8h / w^3; 2 (h,p):
  // c1 d sin(2u) E, c1 = 2h / (w^2 p^2); 3 (w,w): s^2 E (c1 s^2 + c2),
  // c1 = 16 h^2 / w^6, c2 = -12 h^2 / w^4; 4 (w,p): d sin(2u) E (c1 s^2 + c2),
  // c1 = 4 h^2 / (w^5 p^2), c2 = -2 h^2 / (w^3 p^2); 5 (p,p):
  // d E (c1 d sin(2u)^2 + c2 (d cos(2u) / p + 2 sin(2u))), c1 = h^2 / (w^4 p^4),
  // c2 = -h^2 / (w^2 p^3)
  template <int V>
  struct HessValue {
    static_assert(V >= 0 && V < 6, "periodic's Hessian has six upper-triangle values");
    T i2p, ip, a, c1, c2;
    __device__ explicit HessValue(const T* th) {
      const T h = th[0], w = th[1], p = th[2];
      const T iw2 = T(1) / (w * w);
      const T iw = T(1) / w;
      ip = T(1) / p;
      i2p = T(0.5) * ip;
      a = T(-2) * iw2;
      const T h2 = h * h;
      const T ip2 = ip * ip;
      switch (V) {
        case 0: c1 = T(2); c2 = T(0); break;
        case 1: c1 = T(8) * h * iw2 * iw; c2 = T(0); break;
        case 2: c1 = T(2) * h * iw2 * ip2; c2 = T(0); break;
        case 3: c1 = T(16) * h2 * (iw2 * iw2 * iw2); c2 = T(-12) * h2 * (iw2 * iw2); break;
        case 4: c1 = T(4) * h2 * (iw2 * iw2 * iw) * ip2; c2 = T(-2) * h2 * (iw2 * iw) * ip2; break;
        default: c1 = h2 * (iw2 * iw2) * (ip2 * ip2); c2 = -h2 * iw2 * (ip2 * ip); break;
      }
    }
    __device__ __forceinline__ T operator()(T d) const {
      const T u = d * i2p;
      const T s = dsin(u);
      const T s2 = s * s;
      const T E = dexp(a * s2);
      if constexpr (V == 0) {
        return c1 * E;
      } else if constexpr (V == 1) {
        return c1 * (s2 * E);
      } else if constexpr (V == 2) {
        return c1 * (d * dsin(T(2) * u) * E);
      } else if constexpr (V == 3) {
        return (s2 * E) * dfma(c1, s2, c2);
      } else if constexpr (V == 4) {
        return (d * dsin(T(2) * u) * E) * dfma(c1, s2, c2);
      } else {
        const T s2u = dsin(T(2) * u);
        const T c2u = dcos(T(2) * u);
        return (d * E) * dfma(c1 * d, s2u * s2u, c2 * dfma(d * c2u, ip, T(2) * s2u));
      }
    }
  };
};

// sqrt(3) and sqrt(5) as the Matern module writes them
constexpr double kSqrt3 = 1.7320508075688772;
constexpr double kSqrt5 = 2.23606797749979;

// Matern 3/2, theta = (h, w):  h^2 (1 + u) exp(-u), u = sqrt(3) |d| / w.
template <typename T>
struct Matern32Form {
  static constexpr int P = 2;

  __device__ static void jac(T d, const T* th, T* out) {
    const T h = th[0], w = th[1];
    const T u = T(kSqrt3) * dabs(d) / w;
    const T E = dexp(-u);
    out[0] = T(2) * h * (T(1) + u) * E;
    out[1] = (h * h) * u * u * E / w;
  }

  // upper triangle, row-major: (h,h), (h,w), (w,w)
  __device__ static void hess(T d, const T* th, T* out) {
    const T h = th[0], w = th[1];
    const T u = T(kSqrt3) * dabs(d) / w;
    const T E = dexp(-u);
    out[0] = T(2) * (T(1) + u) * E;
    out[1] = T(2) * h * u * u * E / w;
    out[2] = (h * h) * u * u * (u - T(3)) * E / (w * w);
  }

  template <int V>
  using HessValue = HessFromFull<T, Matern32Form<T>, V>;
};

// Matern 5/2, theta = (h, w):  h^2 (1 + u + u^2 / 3) exp(-u),
// u = sqrt(5) |d| / w.
template <typename T>
struct Matern52Form {
  static constexpr int P = 2;

  __device__ static void jac(T d, const T* th, T* out) {
    const T h = th[0], w = th[1];
    const T u = T(kSqrt5) * dabs(d) / w;
    const T E = dexp(-u);
    out[0] = T(2) * h * (T(1) + u + u * u / T(3)) * E;
    out[1] = (h * h) * u * u * (T(1) + u) * E / (T(3) * w);
  }

  // upper triangle, row-major: (h,h), (h,w), (w,w)
  __device__ static void hess(T d, const T* th, T* out) {
    const T h = th[0], w = th[1];
    const T u = T(kSqrt5) * dabs(d) / w;
    const T E = dexp(-u);
    out[0] = T(2) * (T(1) + u + u * u / T(3)) * E;
    out[1] = T(2) * h * u * u * (T(1) + u) * E / (T(3) * w);
    out[2] = (h * h) * u * u * (u * u - T(3) * u - T(3)) * E / (T(3) * w * w);
  }

  template <int V>
  using HessValue = HessFromFull<T, Matern52Form<T>, V>;
};

// Rational quadratic, theta = (h, w, a):  h^2 (1 + z / a)^(-a),
// z = d^2 / (2 w^2).  The derivatives take ln B = log1p(q), q = z / a,
// B^(-a) = exp(-a ln B) and C = z / (aB) - ln B as its series below q =
// 1/16 (terms): at large a, B rounds away q's digits and the difference
// cancels (float32 MLE with RQ drives a to ~1e3).
template <typename T>
struct RQForm {
  static constexpr int P = 3;


  // B, B^(-a), ln B and C = z / (aB) - ln B = -q^2/2 + 2q^3/3 - ... (q^9 in
  // float32, q^16 in float64) below q = 1/16
  __device__ static void terms(T z, T a, T& B, T& Bma, T& lnB, T& C) {
    const T q = z / a;
    lnB = dlog1p(q);
    B = T(1) + q;
    Bma = dexp(-a * lnB);
    constexpr int kTerms = sizeof(T) == 4 ? 9 : 16;
    T s = T(0);
#pragma unroll
    for (int k = kTerms; k > 1; --k) {
      s = dfma(s, q, T(k % 2 == 1 ? 1 : -1) * T(k - 1) / T(k));
    }
    C = q < T(0.0625) ? s * q * q : q / B - lnB;
  }

  __device__ static void jac(T d, const T* th, T* out) {
    const T h = th[0], w = th[1], a = th[2];
    const T z = d * d / (T(2) * w * w);
    T B, Bma, lnB, C;
    terms(z, a, B, Bma, lnB, C);
    const T Bma1 = Bma / B;
    out[0] = T(2) * h * Bma;
    out[1] = T(2) * (h * h) * z * Bma1 / w;
    out[2] = (h * h) * Bma * C;
  }

  // upper triangle, row-major: (h,h), (h,w), (h,a), (w,w), (w,a), (a,a)
  __device__ static void hess(T d, const T* th, T* out) {
    const T h = th[0], w = th[1], a = th[2];
    const T z = d * d / (T(2) * w * w);
    T B, Bma, lnB, C;
    terms(z, a, B, Bma, lnB, C);
    const T Bma1 = Bma / B;
    const T Bma2 = Bma1 / B;
    const T h2 = h * h;
    out[0] = T(2) * Bma;
    out[1] = T(4) * h * z * Bma1 / w;
    out[2] = T(2) * h * Bma * C;
    out[3] = T(2) * h2 * z * Bma2 * (T(2) * (a + T(1)) * z / a - T(3) * B) / (w * w);
    out[4] = T(2) * h2 * z * Bma1 * (C + z / (a * a * B)) / w;  // (a+1)z/(a^2 B) - ln B
    out[5] = h2 * Bma * (C * C + z * z / (a * a * a * B * B));
  }

  template <int V>
  using HessValue = HessFromFull<T, RQForm<T>, V>;
};

// -- the folded element: what B1 and B4 evaluate ------------------------------
//
// Every constant of a leaf is folded out of the element once per block, in
// double from the parameters (Fold::fold), into p0 and p1; the element
// gives an exponent e in neg_exp's base (float32: 2, float64: e) and a
// multiplier m, and the leaf's value is m base^(-e) h^2, h^2 applied once
// (at the store, or per term of a tree with several terms):
//   SE        p0 = s = c / w                  e = t^2, t = d s
//   periodic  p0 = 1 / 2p, p1 = 2c / w        e = g^2, g = sin(d p0) p1 (sin_reduced)
//   Matérn    p0 = s = c' L / w               e = t = |d| s, m = 1 + u (3/2) or
//                                             1 + u (1 + u / 3) (5/2), u = t / L
//   RQ        p0 = s = 1 / (w sqrt(2a)), p1 = a   e = a log_base(1 + t^2), t = d s
// with c^2 = fold_c2 (exp(-q / 2) = base^(-c^2 q)), L = fold_base, c' =
// sqrt(3) or sqrt(5); m = 1 for all but Matérn.  The plain PyTorch version is
// ops/pairwise.py::folded_values.

// c^2 in exp(-q / 2) = base^(-c^2 q): log2(e) / 2 for float32's ex2, 1 / 2
// for float64's exp
template <typename T>
__host__ __device__ constexpr double fold_c2() {
  return sizeof(T) == 4 ? 0.72134752044448170368 : 0.5;
}

// L, the factor that turns e^(-u) into base^(-L u) with neg_exp's base:
// log2(e) for float32's ex2, 1 for float64's exp
template <typename T>
__host__ __device__ constexpr double fold_base() {
  return sizeof(T) == 4 ? 1.4426950408889634 : 1.0;
}

// +-sin(u), the sign of (-1)^k, with no slow path: k = rint(u / pi), r = u -
// k pi through two FMAs (pi as float(pi) plus the rest: Cody-Waite), so
// |r| <= pi / 2 (plus rounding), then sin r as its Taylor series to r^13
// (the next term is under 7e-10 there) on the FMA pipe.  float64 reduces the
// same way and takes sin(r).  sin^2 is what the leaves use.
__device__ __forceinline__ float sin_reduced(float u) {
  const float k = rintf(u * 0.31830987334251404f);
  float r = fmaf(-k, 3.1415927410125732f, u);
  r = fmaf(-k, -8.742278012618954e-08f, r);
  const float r2 = r * r;
  float p = 1.6059043836821613e-10f;
  p = fmaf(p, r2, -2.505210838544172e-08f);
  p = fmaf(p, r2, 2.7557319223985893e-06f);
  p = fmaf(p, r2, -0.0001984126984126984f);
  p = fmaf(p, r2, 0.008333333333333333f);
  p = fmaf(p, r2, -0.16666666666666666f);
  return fmaf(r * r2, p, r);
}
__device__ __forceinline__ double sin_reduced(double u) {
  const double k = rint(u * 0.3183098861837907);
  double r = fma(-k, 3.141592653589793, u);
  r = fma(-k, 1.2246467991473532e-16, r);
  return sin(r);
}

// log_base(1 + q) for q >= 0 (RQ's exponent is a times it).  float32, base 2:
// below q = 1/16 the series q (1 - q / 2 + ... - q^5 / 6) / ln 2 on the FMA
// pipe (the first term left out is under 2^-24 / 7 of the sum), which keeps
// its relative accuracy where B = 1 + q rounds away q's digits and a large a
// multiplies any absolute error; from 1/16 on lg2.approx of B, one MUFU.LG2
// (absolute error about 2^-22), where a log2 B >= a / 11.4.  float64:
// log(1 + q).
__device__ __forceinline__ float log1p_base(float q) {
  float p = -0.24044917348149392f;
  p = fmaf(p, q, 0.28853900817779266f);
  p = fmaf(p, q, -0.36067376022224085f);
  p = fmaf(p, q, 0.48089834696298783f);
  p = fmaf(p, q, -0.7213475204444817f);
  p = fmaf(p, q, 1.4426950408889634f);
  float lg;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(lg) : "f"(1.0f + q));
  return q < 0.0625f ? p * q : lg;
}
__device__ __forceinline__ double log1p_base(double q) { return log(1.0 + q); }

template <typename T>
struct SEFold {
  static constexpr int kFamily = kSE, P = 2;
  static constexpr bool kMult = false;
  __device__ static void fold(const T* th, T& p0, T& p1) {
    p0 = static_cast<T>(sqrt(fold_c2<T>()) / static_cast<double>(th[1]));
    p1 = T(0);
  }
  __device__ static T exponent(T d, T p0, T, T&) {
    const T t = d * p0;
    return t * t;
  }
};

template <typename T>
struct PeriodicFold {
  static constexpr int kFamily = kPeriodic, P = 3;
  static constexpr bool kMult = false;
  __device__ static void fold(const T* th, T& p0, T& p1) {
    p0 = static_cast<T>(0.5 / static_cast<double>(th[2]));
    p1 = static_cast<T>(2.0 * sqrt(fold_c2<T>()) / static_cast<double>(th[1]));
  }
  __device__ static T exponent(T d, T p0, T p1, T&) {
    const T g = sin_reduced(d * p0) * p1;
    return g * g;
  }
};

template <typename T>
struct Matern32Fold {
  static constexpr int kFamily = kMatern32, P = 2;
  static constexpr bool kMult = true;
  __device__ static void fold(const T* th, T& p0, T& p1) {
    p0 = static_cast<T>(kSqrt3 * fold_base<T>() / static_cast<double>(th[1]));
    p1 = T(0);
  }
  __device__ static T exponent(T d, T p0, T, T& m) {
    const T t = dabs(d) * p0;
    m = dfma(t, static_cast<T>(1.0 / fold_base<T>()), T(1));
    return t;
  }
};

template <typename T>
struct Matern52Fold {
  static constexpr int kFamily = kMatern52, P = 2;
  static constexpr bool kMult = true;
  __device__ static void fold(const T* th, T& p0, T& p1) {
    p0 = static_cast<T>(kSqrt5 * fold_base<T>() / static_cast<double>(th[1]));
    p1 = T(0);
  }
  __device__ static T exponent(T d, T p0, T, T& m) {
    const T t = dabs(d) * p0;
    const T u = t * static_cast<T>(1.0 / fold_base<T>());
    m = dfma(u, dfma(u, T(1) / T(3), T(1)), T(1));
    return t;
  }
};

template <typename T>
struct RQFold {
  static constexpr int kFamily = kRQ, P = 3;
  static constexpr bool kMult = false;
  __device__ static void fold(const T* th, T& p0, T& p1) {
    const double w = th[1], a = th[2];
    p0 = static_cast<T>(1.0 / (w * sqrt(2.0 * a)));
    p1 = th[2];
  }
  __device__ static T exponent(T d, T p0, T p1, T&) {
    const T t = d * p0;
    return p1 * log1p_base(t * t);
  }
};

// W elements of a leaf's exponent and multiplier
template <typename Fold, typename T, int W>
__device__ __forceinline__ void leaf_exponents(const T (&d)[W], T p0, T p1, T (&e)[W],
                                               T (&m)[W]) {
#pragma unroll
  for (int w = 0; w < W; ++w) e[w] = Fold::exponent(d[w], p0, p1, m[w]);
}

// -- Sum/Product trees ---------------------------------------------------------

constexpr int kMaxTreeLeaves = 8;  // the most leaves a tree may have (ops/pairwise.py)
constexpr int kMaxTreeTerms = 18;  // the most products 8 leaves expand to: (a+b+c)(d+e+f)(g+h)

// A tree as a sum of products of its leaves, expanded on the host
// (ops/pairwise.py::_tree_flat): leaf l has a Family and an offset, its
// first parameter in the concatenated vector (k1's before k2's), and term t
// is the product of the leaves whose bits `mask[t]` sets.  n_params is the
// leaves' parameters together: the diagonal term, where a launch has one,
// follows them.
struct TreeProgram {
  int n_leaves, n_terms, n_params;
  signed char family[kMaxTreeLeaves];
  signed char offset[kMaxTreeLeaves];
  unsigned char mask[kMaxTreeTerms];
};

__host__ __device__ constexpr int family_params(int family) {
  return family == kPeriodic || family == kRQ ? 3 : 2;
}

// Read a program from its host encoding {n_leaves, family_0, offset_0, ...,
// n_terms, mask_0, ...} (ops/pairwise.py::_tree_program); false on anything
// malformed: a leaf family without a form, an offset that is not the
// running parameter count, more than kMaxTreeLeaves leaves or kMaxTreeTerms
// terms, a mask that is empty or names a leaf past the last, a leaf in no
// term.
inline bool parse_tree(const int* code, TreeProgram* prog) {
  if (code == nullptr || code[0] < 1 || code[0] > kMaxTreeLeaves) return false;
  const int leaves = code[0];
  int params = 0;
  for (int l = 0; l < leaves; ++l) {
    const int family = code[1 + 2 * l], offset = code[2 + 2 * l];
    if (family < kSE || family > kRQ || offset != params) return false;
    prog->family[l] = static_cast<signed char>(family);
    prog->offset[l] = static_cast<signed char>(offset);
    params += family_params(family);
  }
  const int* terms = code + 1 + 2 * leaves;
  if (terms[0] < 1 || terms[0] > kMaxTreeTerms) return false;
  int used = 0;
  for (int t = 0; t < terms[0]; ++t) {
    const int mask = terms[1 + t];
    if (mask <= 0 || mask >= (1 << leaves)) return false;
    prog->mask[t] = static_cast<unsigned char>(mask);
    used |= mask;
  }
  if (used != (1 << leaves) - 1) return false;
  prog->n_leaves = leaves;
  prog->n_terms = terms[0];
  prog->n_params = params;
  return true;
}

// B1's and B4's element for one leaf: W values m base^(-e), scale[0] = h^2
template <typename T, typename Fold>
struct LeafValue {
  static constexpr int kVals = 1;
  T p0, p1;
  double scale[kVals];
  __device__ LeafValue(const T* th, const TreeProgram&) {
    Fold::fold(th, p0, p1);
    const double h = th[0];
    scale[0] = h * h;
  }
  __device__ __forceinline__ int n_params() const { return Fold::P; }
  // the most rows of B4 a thread owns with RC right-hand sides
  __host__ __device__ static constexpr int max_rows(int) { return 8; }
  template <int W>
  __device__ __forceinline__ void eval(const T (&d)[W], T (&v)[W]) const {
#pragma unroll
    for (int w = 0; w < W; ++w) {
      T m = T(1);
      const T e = Fold::exponent(d[w], p0, p1, m);
      v[w] = Fold::kMult ? m * neg_exp(e) : neg_exp(e);
    }
  }
};

// A tree's folded constants, one copy per block in shared memory: each
// leaf's p0, p1 and family, each product's leaf mask and h^2 product c_t
template <typename T>
struct TreeConsts {
  T p0[kMaxTreeLeaves], p1[kMaxTreeLeaves], coef[kMaxTreeTerms];
  int family[kMaxTreeLeaves], mask[kMaxTreeTerms];
  int n_leaves, n_terms;
};

// B1's and B4's element for a tree: sum_t c_t M_t base^(-E_t), per product
// t the sum E_t of its leaves' exponents and the product M_t of their
// multipliers, one neg_exp.  The walk is two loops that are not unrolled,
// over the products and over the set bits of each one's mask, with one
// if-chain over the leaf families inside: the code stays a few hundred
// instructions (unrolled over 8 leaf slots and 18 products it overflowed
// the instruction cache and ran 20x slower), the branches are the same for
// the whole grid, and the constants, indexed at run time, come from shared
// memory (TreeConsts, written by thread 0 before the kernels' first
// __syncthreads), never local memory.  A leaf in several products (a
// product of sums) is evaluated in each.  A tree of one product (as SE x
// periodic) leaves c = prod h^2 to the store (scale[0]); with several
// products each is scaled in the element by c_t in T and scale[0] = 1.
template <typename T>
struct TreeValue {
  static constexpr int kVals = 1;
  const TreeConsts<T>* c;
  int params;  // the leaves' parameters together
  double scale[kVals];
  __device__ TreeValue(const T* th, const TreeProgram& prog) : params(prog.n_params) {
    __shared__ TreeConsts<T> consts;
    c = &consts;
    if (threadIdx.x == 0) {
      consts.n_leaves = prog.n_leaves;
      consts.n_terms = prog.n_terms;
      for (int l = 0; l < prog.n_leaves; ++l) {
        const T* q = th + prog.offset[l];
        consts.family[l] = prog.family[l];
        switch (prog.family[l]) {
          case kSE: SEFold<T>::fold(q, consts.p0[l], consts.p1[l]); break;
          case kPeriodic: PeriodicFold<T>::fold(q, consts.p0[l], consts.p1[l]); break;
          case kMatern32: Matern32Fold<T>::fold(q, consts.p0[l], consts.p1[l]); break;
          case kMatern52: Matern52Fold<T>::fold(q, consts.p0[l], consts.p1[l]); break;
          default: RQFold<T>::fold(q, consts.p0[l], consts.p1[l]); break;
        }
      }
      for (int t = 0; t < prog.n_terms; ++t) {
        consts.mask[t] = prog.mask[t];
        consts.coef[t] = static_cast<T>(term_scale(th, prog, t));
      }
    }
    scale[0] = prog.n_terms == 1 ? term_scale(th, prog, 0) : 1.0;
  }
  // c_t: the h^2 of product t's leaves multiplied in leaf order, in double
  __device__ static double term_scale(const T* th, const TreeProgram& prog, int t) {
    double s = 1.0;
    for (int l = 0; l < prog.n_leaves; ++l) {
      if (prog.mask[t] >> l & 1) {
        const double h = th[prog.offset[l]];
        s *= h * h;
      }
    }
    return s;
  }
  __device__ __forceinline__ int n_params() const { return params; }
  // B4: at most 4 rows a thread (which evaluates them against kTreeCols
  // columns at once, matvec.cuh)
  __host__ __device__ static constexpr int max_rows(int) { return 4; }
  template <int W>
  __device__ __forceinline__ void eval(const T (&d)[W], T (&v)[W]) const {
#pragma unroll
    for (int w = 0; w < W; ++w) v[w] = T(0);
    const int terms = c->n_terms;
#pragma unroll 1
    for (int t = 0; t < terms; ++t) {
      T E[W], M[W];
#pragma unroll
      for (int w = 0; w < W; ++w) {
        E[w] = T(0);
        M[w] = T(1);
      }
#pragma unroll 1
      for (int mask = c->mask[t]; mask != 0; mask &= mask - 1) {
        const int l = __ffs(mask) - 1;
        const int family = c->family[l];
        const T p0 = c->p0[l], p1 = c->p1[l];
        T e[W], m[W];
        if (family == kSE) {
          leaf_exponents<SEFold<T>>(d, p0, p1, e, m);
        } else if (family == kPeriodic) {
          leaf_exponents<PeriodicFold<T>>(d, p0, p1, e, m);
        } else if (family == kMatern32) {
          leaf_exponents<Matern32Fold<T>>(d, p0, p1, e, m);
        } else if (family == kMatern52) {
          leaf_exponents<Matern52Fold<T>>(d, p0, p1, e, m);
        } else {
          leaf_exponents<RQFold<T>>(d, p0, p1, e, m);
        }
#pragma unroll
        for (int w = 0; w < W; ++w) E[w] += e[w];
        if (family == kMatern32 || family == kMatern52) {
#pragma unroll
          for (int w = 0; w < W; ++w) M[w] *= m[w];
        }
      }
      if (terms == 1) {
#pragma unroll
        for (int w = 0; w < W; ++w) v[w] = M[w] * neg_exp(E[w]);
      } else {
        const T ct = c->coef[t];
#pragma unroll
        for (int w = 0; w < W; ++w) v[w] = dfma(ct, M[w] * neg_exp(E[w]), v[w]);
      }
    }
  }
};

// the tree's evaluator, whose loops the kernels keep rolled too
template <typename Eval>
constexpr bool kIsTree = false;
template <typename T>
constexpr bool kIsTree<TreeValue<T>> = true;

}  // namespace gp
