// Closed-form kernel values and hyperparameter derivatives of the pairwise
// kernels (B1, B2a, B2b).  The matrix-free products (B4, B5: matvec.cuh)
// evaluate the same functions with every constant folded out of the element.
//
// Each form's k / jac / hess mirrors, expression for expression, the static
// k_fn / jac_fn / hess_fn of its Python class (models/gaussian.py,
// models/periodic.py, models/matern.py, models/rq.py), so the kernels and
// their plain PyTorch twins evaluate the same arithmetic.  HessValue<V> is
// one value of hess, the upper-triangle entry V; SE's and periodic's fold
// every factor that does not depend on the element into constants once per
// launch, the others evaluate hess and keep value V (HessFromFull); the
// plain PyTorch version is ops/pairwise.py::hessian_plane_folded.
//
// A Sum/Product tree of these leaves (models/composite.py) is a postfix
// program (TreeProgram) passed to a kernel by value; tree_k walks it with a
// switch over the leaf forms that every thread takes the same way.  The
// D-dimensional ARD-SE kernel (models/ard.py) is not a case of the switch:
// B6 (ard_pairwise.cu) and B4-ARD (ard_matvec.cuh) evaluate it on
// pre-scaled coordinates, and it cannot be a tree's leaf.
//
// Compiled without --use_fast_math: sin, exp, pow and log are the accurate
// libm forms, never __sinf / __expf.
#pragma once

#include <cuda_runtime.h>

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
__device__ __forceinline__ float dpow(float b, float e) { return powf(b, e); }
__device__ __forceinline__ double dpow(double b, double e) { return pow(b, e); }
__device__ __forceinline__ float dlog(float v) { return logf(v); }
__device__ __forceinline__ double dlog(double v) { return log(v); }

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

  __device__ static T k(T d, const T* th) {
    const T h = th[0], w = th[1];
    const T u = T(kSqrt3) * dabs(d) / w;
    return (h * h) * (T(1) + u) * dexp(-u);
  }

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

  __device__ static T k(T d, const T* th) {
    const T h = th[0], w = th[1];
    const T u = T(kSqrt5) * dabs(d) / w;
    return (h * h) * (T(1) + u + u * u / T(3)) * dexp(-u);
  }

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
// z = d^2 / (2 w^2).
template <typename T>
struct RQForm {
  static constexpr int P = 3;

  __device__ static T k(T d, const T* th) {
    const T h = th[0], w = th[1], a = th[2];
    const T z = d * d / (T(2) * w * w);
    return (h * h) * dpow(T(1) + z / a, -a);
  }

  __device__ static void jac(T d, const T* th, T* out) {
    const T h = th[0], w = th[1], a = th[2];
    const T z = d * d / (T(2) * w * w);
    const T B = T(1) + z / a;
    const T Bma = dpow(B, -a);
    const T Bma1 = Bma / B;
    const T lnB = dlog(B);
    out[0] = T(2) * h * Bma;
    out[1] = T(2) * (h * h) * z * Bma1 / w;
    out[2] = (h * h) * Bma * (z / (a * B) - lnB);
  }

  // upper triangle, row-major: (h,h), (h,w), (h,a), (w,w), (w,a), (a,a)
  __device__ static void hess(T d, const T* th, T* out) {
    const T h = th[0], w = th[1], a = th[2];
    const T z = d * d / (T(2) * w * w);
    const T B = T(1) + z / a;
    const T Bma = dpow(B, -a);
    const T Bma1 = Bma / B;
    const T Bma2 = Bma1 / B;
    const T lnB = dlog(B);
    const T C = z / (a * B) - lnB;
    const T h2 = h * h;
    out[0] = T(2) * Bma;
    out[1] = T(4) * h * z * Bma1 / w;
    out[2] = T(2) * h * Bma * C;
    out[3] = T(2) * h2 * z * Bma2 * (T(2) * (a + T(1)) * z / a - T(3) * B) / (w * w);
    out[4] = T(2) * h2 * z * Bma1 * ((a + T(1)) * z / (a * a * B) - lnB) / w;
    out[5] = h2 * Bma * (C * C + z * z / (a * a * a * B * B));
  }

  template <int V>
  using HessValue = HessFromFull<T, RQForm<T>, V>;
};

// -- Sum/Product trees ---------------------------------------------------------

constexpr int kMaxTreeLeaves = 8;  // the most leaves a tree may have (ops/pairwise.py)
constexpr int kMaxTreeNodes = 2 * kMaxTreeLeaves - 1;
constexpr int kTreeSum = -1, kTreeProd = -2;

// A tree in postfix order: node i is a leaf (op = its Family, offset = its
// first parameter in the concatenated vector, k1's before k2's) or combines
// the two values below it on the stack (op = kTreeSum or kTreeProd, the
// earlier one being k1).  n_params is the leaves' parameters together: the
// diagonal term, where a launch has one, follows them.
struct TreeProgram {
  int n_nodes;
  int n_params;
  signed char op[kMaxTreeNodes];
  signed char offset[kMaxTreeNodes];
};

__host__ __device__ constexpr int family_params(int family) {
  return family == kPeriodic || family == kRQ ? 3 : 2;
}

// Read a program from its host encoding {n_nodes, op_0, offset_0, op_1, ...}
// (ops/pairwise.py::_tree_program); false on anything malformed: a leaf
// family without a form, an offset out of order, a stack that does not end
// with one value, more than kMaxTreeLeaves leaves.
inline bool parse_tree(const int* code, TreeProgram* prog) {
  if (code == nullptr || code[0] < 1 || code[0] > kMaxTreeNodes) return false;
  prog->n_nodes = code[0];
  int depth = 0, leaves = 0, params = 0;
  for (int i = 0; i < prog->n_nodes; ++i) {
    const int op = code[1 + 2 * i], offset = code[2 + 2 * i];
    if (op == kTreeSum || op == kTreeProd) {
      if (depth < 2) return false;
      --depth;
      prog->offset[i] = 0;
    } else {
      if (op < kSE || op > kRQ || offset != params || ++leaves > kMaxTreeLeaves) return false;
      ++depth;
      params += family_params(op);
      prog->offset[i] = static_cast<signed char>(offset);
    }
    prog->op[i] = static_cast<signed char>(op);
  }
  prog->n_params = params;
  return depth == 1;
}

template <typename T>
__device__ __forceinline__ T leaf_k(int family, T d, const T* th) {
  switch (family) {
    case kSE: return SEForm<T>::k(d, th);
    case kPeriodic: return PeriodicForm<T>::k(d, th);
    case kMatern32: return Matern32Form<T>::k(d, th);
    case kMatern52: return Matern52Form<T>::k(d, th);
    default: return RQForm<T>::k(d, th);
  }
}

// k(d) of the tree: each leaf's k on its slice of th, combined as the
// composite's k_fn combines them (k1 + k2, k1 * k2)
template <typename T>
__device__ T tree_k(const TreeProgram& prog, T d, const T* th) {
  T stack[kMaxTreeLeaves];
  int top = 0;
  for (int i = 0; i < prog.n_nodes; ++i) {
    const int op = prog.op[i];
    if (op == kTreeSum) {
      --top;
      stack[top - 1] = stack[top - 1] + stack[top];
    } else if (op == kTreeProd) {
      --top;
      stack[top - 1] = stack[top - 1] * stack[top];
    } else {
      stack[top++] = leaf_k(op, d, th + prog.offset[i]);
    }
  }
  return stack[0];
}

}  // namespace gp
