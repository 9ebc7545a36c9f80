// B4, B5: matrix-free kernel products.  (B4-ARD, the ARD product, has a
// kernel of its own: ard_matvec.cuh.)
//
// Replaces the Pallas tile bodies of gaussian_processes_tpu/ops/pairwise.py:
//   B4     _matvec_tile_body      out = K(x, x) V, 1-D x: every leaf family
//                                 and Sum/Product trees of them
//   B5     _jacvec_tile_body      out[p] = dK/dtheta_p (x, x) U for every p,
//                                 leaf families only (as the JAX gate)
//
// B4 / B5.  K (and dK/dtheta) is never stored: device memory sees x, V and
// the (P, n, r) output only, so what bounds them on the H100 is arithmetic:
// n^2 closed-form evaluations (one exponential each, plus a sine for
// periodic) and n^2 r (B5: n^2 P r) multiply-adds, all FP32 / FP64 FMAs on
// the CUDA cores: no TF32, the counterpart of the Pallas body's
// Precision.HIGHEST.  With one right-hand side the exponentials set the
// pace: an SM's special-function unit starts 16 ex2 a clock, an eighth of
// its FMA rate, so 65536^2 of them take at least 1.03 ms; from about 4
// right-hand sides on, the FMAs do.  The design keeps the operations and
// the shared-memory loads per element (i, j) few:
//
// * every constant is folded out of the element.  SE:
//   t = (x_i - x_j) s with s = sqrt(log2(e) / 2) / w, E = 2^(-t^2) as one
//   ex2.approx (2 ulp, as exp2f) in float32; s = sqrt(1/2) / w and exp in
//   float64.  B5's two values are E and E t^2.  h^2 (B5: 2h and
//   h^2 / (c^2 w), c^2 = s^2 w^2) multiplies the row's double sums once, at
//   the store.  Periodic: g = sin((x_i - x_j) / 2p) a with a = 2 s,
//   E = 2^(-g^2), the sine reduced by hand (gp::sin_reduced) in B4; B5's
//   values are E, E g^2 and E d sin u cos u from one sincos.  B4's element
//   is closed_forms.cuh's folded one (gp::LeafValue), the same as B1's.
//   The difference is taken first and then scaled: coordinates
//   pre-scaled by s, as B4-ARD takes them, reach +-278 at N = 65536 with
//   100 points per lengthscale, where a float32 ulp of x s moves an entry
//   of K by 1e-4 relative (tests/test_torch_se_products.py holds the form
//   to this);
// * a thread owns ROWS rows (rows t, t + 128, ...; ROWS * P * RC <= 36
//   accumulators, at most 8 / P rows), so every column staged in shared memory
//   (x_j read four columns at a time, its RC right-hand sides as 16-byte
//   broadcast loads) feeds ROWS elements, and the ROWS independent
//   exp -> FMA chains hide each other's latency;
// * the chunk of right-hand sides a block holds is 1, 4, 8, 9 or 16: the
//   stochastic gradient solves and differentiates [y, 8 probes], r = 9,
//   which a chunk of 16 would pad with 7 columns of zeros.
//
// Matern: t = |x_i - x_j| s with s = c L / w (c = sqrt(3), sqrt(5); L =
// log2(e) in float32, 1 in float64), E = base^(-t) = e^(-u) with u = t / L:
// B4's value is the polynomial in u times E, B5's (1 + u) E (5/2: (1 + u +
// u^2 / 3) E) and u^2 E (5/2: u^2 (1 + u) E), at d = 0 exactly 1 and 0.  RQ:
// t = (x_i - x_j) s with s = 1 / (w sqrt(2a)), B = 1 + t^2, B^(-a) =
// base^(-a log_base B): two special-function results an element (B4 takes
// log_base B as a series below B = 17/16 and as lg2.approx above,
// gp::log1p_base; B5 the accurate log2f); B5's values B^(-a), t^2 B^(-a) /
// B and B^(-a) (t^2 / B - ln B).  A tree (gp::TreeValue) is a sum of
// products of the folded leaves, one exponential per product; its element
// is long, so a thread evaluates its ROWS rows (at most 4) against
// kTreeCols columns at once (16 elements per pass of the tree's rolled
// loops) and the column loop stays rolled: unrolled 4 times the code
// overflowed the instruction cache (B4 tree 111 ms at r = 1, against 6.6
// ms rolled; NVIDIA H100 80GB HBM3, 700 W).
//
// On an H100 80GB HBM3 at 700 W, float32, N = 65536 (kernel_timing.py, one
// thread per row and the unfolded forms before -> this design): SE B4
// 2.83 -> 1.18 ms at r = 1 (87% of the special-function floor), 4.27 ->
// 2.45 at r = 8, 6.92 -> 2.38 at r = 9; SE B5 27.4 -> 4.63 ms at r = 9;
// periodic, where the accurate sinf then set the pace, B4 12.1 -> 5.22 ms
// at r = 1 and B5 51.3 -> 11.7 at r = 9.  Blocks per SM, rows per thread,
// the tile width and minimum-blocks launch bounds were swept on the card
// and moved no time by more than 8%.
//
// A block of kThreads threads walks its range of columns j in tiles of
// kTile, staging x_j and V[j, chunk] in shared memory.  A tile's kTile
// products are summed in T, and the tile sums are added across the row in
// double (ard_matvec.cuh says why); the two-level sum costs one add per tile.
// To give 132 SMs enough blocks the column range is split over grid axis z;
// each split writes its partial products to a workspace and a second kernel
// adds them in split order (splits.cuh), so a product gives the same bits on
// every call (no float atomics: CG and its early exit want a deterministic
// operator).  Ragged edges are bounds-checked; flat indices are 64-bit
// (65536^2 > 2^31).
//
// The product kernel's instantiations take a while to compile, so SE's and
// periodic's (19 per element type) live in matvec_f32.cu and matvec_f64.cu
// with the entry points, Matern's and RQ's (29 per type) in matvec_ext_f32.cu
// and matvec_ext_f64.cu, and the tree's (5 per type) in matvec_tree_f32.cu
// and matvec_tree_f64.cu, six sources that the build compiles in parallel.

#pragma once

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "closed_forms.cuh"
#include "product_common.cuh"
#include "splits.cuh"

namespace gp {

// B4 / B5 for Matern 3/2, Matern 5/2, RQ and (B4) trees (matvec_ext_f32.cu,
// matvec_ext_f64.cu): launch_matvec / launch_jacvec below for `family`, or
// cudaErrorInvalidValue for any other family
int launch_matvec_ext(const float* x, const float* v, const float* params, float* out,
                      float* work, int n, int r, int family, const TreeProgram& prog,
                      int splits, cudaStream_t stream);
int launch_matvec_ext(const double* x, const double* v, const double* params, double* out,
                      double* work, int n, int r, int family, const TreeProgram& prog,
                      int splits, cudaStream_t stream);
// B4 for a tree (matvec_tree_f32.cu, matvec_tree_f64.cu)
int launch_matvec_tree(const float* x, const float* v, const float* params, float* out,
                       float* work, int n, int r, const TreeProgram& prog, int splits,
                       cudaStream_t stream);
int launch_matvec_tree(const double* x, const double* v, const double* params, double* out,
                       double* work, int n, int r, const TreeProgram& prog, int splits,
                       cudaStream_t stream);
int launch_jacvec_ext(const float* x, const float* u, const float* params, float* out,
                      float* work, int n, int r, int family, int splits, cudaStream_t stream);
int launch_jacvec_ext(const double* x, const double* u, const double* params, double* out,
                      double* work, int n, int r, int family, int splits, cudaStream_t stream);

}  // namespace gp

namespace {

constexpr int kThreads = 128;     // B4/B5: threads per block
constexpr int kTile = 128;        // B4/B5: columns of K per shared-memory tile
constexpr int kAccBudget = 36;    // B4/B5: accumulators (ROWS * P * RC) a thread holds
constexpr int kMaxRows = 8;       // B4/B5: most rows a thread owns
constexpr int kBlocksPerSm = 16;  // B4/B5: blocks per SM the column splits aim for
constexpr int kTreeCols = 4;      // B4's tree: columns a thread evaluates at once
constexpr int kMaxGrid = 65535;   // grid axes y and z

// -- what one product evaluates per element (i, j) ---------------------------
//
// B4 evaluates the folded element of closed_forms.cuh (gp::LeafValue,
// gp::TreeValue), W rows at a time; B5 the forms below, kVals unscaled values
// per element, with the constant that multiplies each value's row sums.

using gp::fold_base;
using gp::fold_c2;

__device__ __forceinline__ void dsincos(float v, float* s, float* c) { sincosf(v, s, c); }
__device__ __forceinline__ void dsincos(double v, double* s, double* c) { sincos(v, s, c); }
// the logarithm in neg_exp's base: log2 in float32, ln in float64
__device__ __forceinline__ float fold_log(float v) { return log2f(v); }
__device__ __forceinline__ double fold_log(double v) { return log(v); }

// B5, SE: dK/dh = 2h E, dK/dw = h^2 E d^2 / w^3 = h^2 / (c^2 w) E t^2
template <typename T>
struct SEJac {
  static constexpr int kVals = 2;
  T s;
  double scale[kVals];
  __device__ explicit SEJac(const T* th) {
    const double h = th[0], w = th[1];
    s = static_cast<T>(sqrt(fold_c2<T>()) / w);
    scale[0] = 2.0 * h;
    scale[1] = h * h / (fold_c2<T>() * w);
  }
  __device__ __forceinline__ void eval(T xi, T xj, T (&val)[kVals]) const {
    const T t = (xi - xj) * s;
    const T t2 = t * t;
    const T E = neg_exp(t2);
    val[0] = E;
    val[1] = E * t2;
  }
};

// B5, periodic: dK/dh = 2h E, dK/dw = h^2 E 4 sin^2(u) / w^3 =
// h^2 / (c^2 w) E g^2, dK/dp = h^2 E d sin(2u) / (w^2 p^2) =
// 2 h^2 / (w^2 p^2) E d sin(u) cos(u)
template <typename T>
struct PeriodicJac {
  static constexpr int kVals = 3;
  T i2p, a;
  double scale[kVals];
  __device__ explicit PeriodicJac(const T* th) {
    const double h = th[0], w = th[1], p = th[2];
    i2p = static_cast<T>(0.5 / p);
    a = static_cast<T>(2.0 * sqrt(fold_c2<T>()) / w);
    scale[0] = 2.0 * h;
    scale[1] = h * h / (fold_c2<T>() * w);
    scale[2] = 2.0 * h * h / (w * w * p * p);
  }
  __device__ __forceinline__ void eval(T xi, T xj, T (&val)[kVals]) const {
    const T d = xi - xj;
    T sn, cs;
    dsincos(d * i2p, &sn, &cs);
    const T g = sn * a;
    const T g2 = g * g;
    const T E = neg_exp(g2);
    val[0] = E;
    val[1] = E * g2;
    val[2] = E * (d * (sn * cs));
  }
};

// B5, Matern 3/2: dK/dh = 2h (1 + u) E, dK/dw = h^2 / w u^2 E
template <typename T>
struct Matern32Jac {
  static constexpr int kVals = 2;
  T s, iL;
  double scale[kVals];
  __device__ explicit Matern32Jac(const T* th) {
    const double h = th[0], w = th[1];
    s = static_cast<T>(gp::kSqrt3 * fold_base<T>() / w);
    iL = static_cast<T>(1.0 / fold_base<T>());
    scale[0] = 2.0 * h;
    scale[1] = h * h / w;
  }
  __device__ __forceinline__ void eval(T xi, T xj, T (&val)[kVals]) const {
    const T t = gp::dabs(xi - xj) * s;
    const T u = t * iL;
    const T E = neg_exp(t);
    val[0] = (T(1) + u) * E;
    val[1] = (u * u) * E;
  }
};

// B5, Matern 5/2: dK/dh = 2h (1 + u + u^2 / 3) E,
// dK/dw = h^2 / (3w) u^2 (1 + u) E
template <typename T>
struct Matern52Jac {
  static constexpr int kVals = 2;
  T s, iL;
  double scale[kVals];
  __device__ explicit Matern52Jac(const T* th) {
    const double h = th[0], w = th[1];
    s = static_cast<T>(gp::kSqrt5 * fold_base<T>() / w);
    iL = static_cast<T>(1.0 / fold_base<T>());
    scale[0] = 2.0 * h;
    scale[1] = h * h / (3.0 * w);
  }
  __device__ __forceinline__ void eval(T xi, T xj, T (&val)[kVals]) const {
    const T t = gp::dabs(xi - xj) * s;
    const T u = t * iL;
    const T E = neg_exp(t);
    val[0] = gp::dfma(u, gp::dfma(u, T(1) / T(3), T(1)), T(1)) * E;
    val[1] = ((u * u) * (T(1) + u)) * E;
  }
};

// B5, RQ: with z = d^2 / (2 w^2) = a t^2, dK/dh = 2h B^-a,
// dK/dw = 2 h^2 z B^(-a-1) / w = 2 h^2 a / w t^2 B^-a / B,
// dK/da = h^2 B^-a (z / (aB) - ln B) = h^2 B^-a (t^2 / B - ln B)
template <typename T>
struct RQJac {
  static constexpr int kVals = 3;
  T s, a, iL;
  double scale[kVals];
  __device__ explicit RQJac(const T* th) {
    const double h = th[0], w = th[1], ad = th[2];
    s = static_cast<T>(1.0 / (w * sqrt(2.0 * ad)));
    a = th[2];
    iL = static_cast<T>(1.0 / fold_base<T>());
    scale[0] = 2.0 * h;
    scale[1] = 2.0 * h * h * ad / w;
    scale[2] = h * h;
  }
  __device__ __forceinline__ void eval(T xi, T xj, T (&val)[kVals]) const {
    const T t = (xi - xj) * s;
    const T t2 = t * t;
    const T B = T(1) + t2;
    const T lb = fold_log(B);
    const T Ba = neg_exp(a * lb);
    const T q = t2 / B;
    val[0] = Ba;
    val[1] = q * Ba;
    val[2] = Ba * (q - lb * iL);
  }
};

// -- the block shape ----------------------------------------------------------

// RC, the right-hand sides a block holds: the smallest of 1, 4, 8, 9 that
// covers r, else chunks of 16 (of 9 where P * 16 accumulators are too many)
inline int chunk_for(int vals, int r) {
  if (r == 1) return 1;
  if (r <= 4) return 4;
  if (r <= 8) return 8;
  return (r == 9 || vals * 16 > kAccBudget) ? 9 : 16;
}

// ROWS, the rows a thread owns: what the accumulator budget allows, at most
// kMaxRows / P (with more, ptxas spills B5's single-column instantiations)
constexpr int rows_for(int vals, int rc) {
  const int rows = kAccBudget / (vals * rc);
  const int most = kMaxRows / vals;
  return rows < 1 ? 1 : (rows > most ? most : rows);
}

// the rows a thread owns for an evaluator: B4's (one value) at most its
// max_rows, a tree's fewer than a leaf's
template <typename Eval, int RC>
constexpr int eval_rows() {
  if constexpr (Eval::kVals == 1) {
    return rows_for(1, RC) < Eval::max_rows(RC) ? rows_for(1, RC) : Eval::max_rows(RC);
  } else {
    return rows_for(Eval::kVals, RC);
  }
}

// B4's evaluators take the parameters and the program, B5's the parameters
template <typename Eval, typename T>
__device__ __forceinline__ Eval make_eval(const T* params, const gp::TreeProgram& prog) {
  if constexpr (Eval::kVals == 1) {
    return Eval(params, prog);
  } else {
    return Eval(params);
  }
}

// the column splits of a launch: about kBlocksPerSm blocks per SM, with at
// least 4 tiles per split
inline int splits_for(int vals, int n, int r, int sms) {
  const int rc = chunk_for(vals, r);
  const int per_block = kThreads * rows_for(vals, rc);
  const long long blocks =
      static_cast<long long>((n + per_block - 1) / per_block) * ((r + rc - 1) / rc);
  const long long want = (static_cast<long long>(kBlocksPerSm) * sms + blocks - 1) / blocks;
  const long long most = (n + 4 * kTile - 1) / (4 * kTile);
  return static_cast<int>(std::max(1LL, std::min(want, most)));
}

// the row stride of a staged tile of V: RC padded to a whole 16-byte vector
template <typename T, int RC>
__host__ __device__ constexpr int padded_chunk() {
  constexpr int v = vec_elems<T>();
  return RC == 1 ? 1 : (RC + v - 1) / v * v;
}

// -- the product: out[z][p][i][c] = scale_p sum_{j in split z} val_p(i, j) V[j][c]

template <typename T, typename Eval, int RC, int ROWS>
__device__ __forceinline__ void product_body(const T* __restrict__ x, const T* __restrict__ v,
                                             const T* __restrict__ params, T* __restrict__ out,
                                             int n, int r, int cols_per_split,
                                             const gp::TreeProgram& prog) {
  constexpr int kV = Eval::kVals;
  constexpr int RCP = padded_chunk<T, RC>();
  __shared__ __align__(16) T xt[kTile];
  __shared__ __align__(16) T vt[kTile * RCP];
  const Eval ev = make_eval<Eval>(params, prog);
  const int row0 = blockIdx.x * (kThreads * ROWS) + threadIdx.x;
  const int c0 = blockIdx.y * RC;
  const int j_begin = blockIdx.z * cols_per_split;
  const int j_end = min(n, j_begin + cols_per_split);

  T xi[ROWS];  // rows past n compute with row n - 1 and store nothing
#pragma unroll
  for (int q = 0; q < ROWS; ++q) xi[q] = x[min(row0 + q * kThreads, n - 1)];
  double acc[ROWS][kV][RC];
#pragma unroll
  for (int q = 0; q < ROWS; ++q) {
#pragma unroll
    for (int p = 0; p < kV; ++p) {
#pragma unroll
      for (int c = 0; c < RC; ++c) acc[q][p][c] = 0.0;
    }
  }

  for (int jt = j_begin; jt < j_end; jt += kTile) {
    const int cnt = min(kTile, j_end - jt);
    __syncthreads();  // every thread is done with the previous tile
    // columns past cnt are staged as x = 0, V = 0 and add nothing
    for (int e = threadIdx.x; e < kTile; e += kThreads) xt[e] = e < cnt ? x[jt + e] : T(0);
    for (int e = threadIdx.x; e < kTile * RCP; e += kThreads) {
      const int jj = e / RCP;
      const int c = e % RCP;
      vt[e] = (jj < cnt && c < RC && c0 + c < r)
                  ? v[static_cast<size_t>(jt + jj) * r + c0 + c] : T(0);
    }
    __syncthreads();
    T part[ROWS][kV][RC];
#pragma unroll
    for (int q = 0; q < ROWS; ++q) {
#pragma unroll
      for (int p = 0; p < kV; ++p) {
#pragma unroll
        for (int c = 0; c < RC; ++c) part[q][p][c] = T(0);
      }
    }
    if constexpr (gp::kIsTree<Eval>) {
      // a tree: kTreeCols columns' ROWS elements at once, the column loop
      // rolled (the element is long: unrolled it overflowed the
      // instruction cache), x_j and V read from shared memory by index
#pragma unroll 1
      for (int j = 0; j < cnt; j += kTreeCols) {
        T d[kTreeCols * ROWS], k[kTreeCols * ROWS];
#pragma unroll
        for (int u = 0; u < kTreeCols; ++u) {
          const T xj = xt[j + u];
#pragma unroll
          for (int q = 0; q < ROWS; ++q) d[u * ROWS + q] = xi[q] - xj;
        }
        ev.eval(d, k);
#pragma unroll
        for (int u = 0; u < kTreeCols; ++u) {
          T vj[RCP];
          ldv<RCP>(vt + (j + u) * RCP, vj);
#pragma unroll
          for (int q = 0; q < ROWS; ++q) {
#pragma unroll
            for (int c = 0; c < RC; ++c) {
              part[q][0][c] = gp::dfma(k[u * ROWS + q], vj[c], part[q][0][c]);
            }
          }
        }
      }
    } else {
#pragma unroll 1
      for (int j4 = 0; j4 < cnt; j4 += 4) {
        T xj[4];
        T v4[4];
        ldv<4>(xt + j4, xj);
        if constexpr (RC == 1) ldv<4>(vt + j4, v4);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          T vj[RCP];
          if constexpr (RC == 1) {
            vj[0] = v4[u];
          } else {
            ldv<RCP>(vt + (j4 + u) * RCP, vj);
          }
#pragma unroll
          for (int q = 0; q < ROWS; ++q) {
            T val[kV];
            if constexpr (kV == 1) {  // B4: the folded element, one at a time
              const T d[1] = {xi[q] - xj[u]};
              ev.eval(d, val);
            } else {
              ev.eval(xi[q], xj[u], val);
            }
#pragma unroll
            for (int p = 0; p < kV; ++p) {
#pragma unroll
              for (int c = 0; c < RC; ++c) part[q][p][c] = gp::dfma(val[p], vj[c], part[q][p][c]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int q = 0; q < ROWS; ++q) {
#pragma unroll
      for (int p = 0; p < kV; ++p) {
#pragma unroll
        for (int c = 0; c < RC; ++c) acc[q][p][c] += static_cast<double>(part[q][p][c]);
      }
    }
  }
  T* o = out + static_cast<size_t>(blockIdx.z) * kV * n * r;
#pragma unroll
  for (int q = 0; q < ROWS; ++q) {
    const int row = row0 + q * kThreads;
    if (row >= n) break;
#pragma unroll
    for (int p = 0; p < kV; ++p) {
#pragma unroll
      for (int c = 0; c < RC; ++c) {
        if (c0 + c < r) {
          o[(static_cast<size_t>(p) * n + row) * r + c0 + c] =
              static_cast<T>(acc[q][p][c] * ev.scale[p]);
        }
      }
    }
  }
}

template <typename T, typename Eval, int RC, int ROWS>
__global__ void __launch_bounds__(kThreads)
product_kernel(const T* __restrict__ x, const T* __restrict__ v,
               const T* __restrict__ params, T* __restrict__ out, int n, int r,
               int cols_per_split, const __grid_constant__ gp::TreeProgram prog) {
  product_body<T, Eval, RC, ROWS>(x, v, params, out, n, r, cols_per_split, prog);
}

// a tree's product: one block per SM as the launch bound's floor (without
// it ptxas capped the r = 1 instantiation at 128 registers and spilled)
template <typename T, typename Eval, int RC, int ROWS>
__global__ void __launch_bounds__(kThreads, 1)
tree_product_kernel(const T* __restrict__ x, const T* __restrict__ v,
                    const T* __restrict__ params, T* __restrict__ out, int n, int r,
                    int cols_per_split, const __grid_constant__ gp::TreeProgram prog) {
  product_body<T, Eval, RC, ROWS>(x, v, params, out, n, r, cols_per_split, prog);
}

template <typename T, typename Eval, int RC>
int launch_product_rc(const T* x, const T* v, const T* params, T* out, T* work,
                      int n, int r, const gp::TreeProgram& prog, int splits,
                      cudaStream_t stream) {
  constexpr int ROWS = eval_rows<Eval, RC>();
  const int tiles = (n + kTile - 1) / kTile;
  const int tiles_per_split = (tiles + splits - 1) / splits;
  const int used = (tiles + tiles_per_split - 1) / tiles_per_split;
  const dim3 grid((n + kThreads * ROWS - 1) / (kThreads * ROWS), (r + RC - 1) / RC, used);
  if (grid.y > kMaxGrid || grid.z > kMaxGrid) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  T* dst = used == 1 ? out : work;
  if constexpr (gp::kIsTree<Eval>) {
    tree_product_kernel<T, Eval, RC, ROWS><<<grid, kThreads, 0, stream>>>(
        x, v, params, dst, n, r, tiles_per_split * kTile, prog);
  } else {
    product_kernel<T, Eval, RC, ROWS><<<grid, kThreads, 0, stream>>>(
        x, v, params, dst, n, r, tiles_per_split * kTile, prog);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || used == 1) return static_cast<int>(err);
  return static_cast<int>(gp::launch_sum_splits<T>(
      work, out, static_cast<size_t>(Eval::kVals) * n * r, used, stream));
}

// `prog`: the tree of a TreeValue, else unused
template <typename T, typename Eval>
int launch_product(const T* x, const T* v, const T* params, T* out, T* work,
                   int n, int r, const gp::TreeProgram& prog, int splits,
                   cudaStream_t stream) {
  if (n <= 0 || r <= 0 || splits < 1 || (splits > 1 && work == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (chunk_for(Eval::kVals, r)) {
    case 1:
      return launch_product_rc<T, Eval, 1>(x, v, params, out, work, n, r, prog, splits, stream);
    case 4:
      return launch_product_rc<T, Eval, 4>(x, v, params, out, work, n, r, prog, splits, stream);
    case 8:
      return launch_product_rc<T, Eval, 8>(x, v, params, out, work, n, r, prog, splits, stream);
    case 9:
      return launch_product_rc<T, Eval, 9>(x, v, params, out, work, n, r, prog, splits, stream);
    default:
      if constexpr (Eval::kVals * 16 <= kAccBudget) {
        return launch_product_rc<T, Eval, 16>(x, v, params, out, work, n, r, prog, splits,
                                              stream);
      }
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// `prog`: a family kTree program, else unused
template <typename T>
int launch_matvec(const T* x, const T* v, const T* params, T* out, T* work,
                  int n, int r, int family, const gp::TreeProgram& prog, int splits,
                  cudaStream_t stream) {
  switch (family) {
    case gp::kSE:
      return launch_product<T, gp::LeafValue<T, gp::SEFold<T>>>(x, v, params, out, work, n, r,
                                                                prog, splits, stream);
    case gp::kPeriodic:
      return launch_product<T, gp::LeafValue<T, gp::PeriodicFold<T>>>(x, v, params, out, work,
                                                                      n, r, prog, splits, stream);
    default:  // Matern, RQ, trees; anything else is refused there
      return gp::launch_matvec_ext(x, v, params, out, work, n, r, family, prog, splits,
                                   stream);
  }
}

template <typename T>
int launch_jacvec(const T* x, const T* u, const T* params, T* out, T* work,
                  int n, int r, int family, int splits, cudaStream_t stream) {
  const gp::TreeProgram none{};
  switch (family) {
    case gp::kSE:
      return launch_product<T, SEJac<T>>(x, u, params, out, work, n, r, none, splits, stream);
    case gp::kPeriodic:
      return launch_product<T, PeriodicJac<T>>(x, u, params, out, work, n, r, none, splits,
                                               stream);
    default:  // Matern, RQ; anything else is refused there
      return gp::launch_jacvec_ext(x, u, params, out, work, n, r, family, splits, stream);
  }
}

}  // namespace
