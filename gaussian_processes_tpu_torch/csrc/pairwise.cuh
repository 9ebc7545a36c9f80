// B1, B2a, B2b: pairwise covariance and its hyperparameter derivatives.
//
// Replaces the Pallas tile bodies of gaussian_processes_tpu/ops/pairwise.py:
//   B1  _tile_body       K[i, j] = k(x1_i - x2_j; theta) (+ s^2 + jitter on
//                        the global diagonal)
//   B2a _jac_tile_body   dK/dtheta_p, one (n, m) plane per parameter
//   B2b _hess_tile_body  d2K/dtheta_p dtheta_q, all P x P planes or one
//
// Bound on the H100: the HBM write of the output, n * m * sizeof(T) bytes per
// plane (16384^2 f32 = 1.07 GB, about 0.32 ms at 3.35 TB/s).  Each element
// costs one subtraction and a closed form of a few flops and one or two
// transcendentals, far below the card's arithmetic rate, and the inputs are
// two vectors of n + m values.  So the designs keep every output element in
// registers from evaluation to store and make each store coalesce.  The
// hyperparameters are read from device memory through a pointer, so the
// host never synchronises to read them.
//
// B1, B2a, B2b share one layout.  A block of 256 threads covers kDerivRows
// rows by 32 C columns, C = 16 bytes / sizeof(T): the block stages its rows'
// x1 in shared memory, a thread keeps its C columns' x2 in registers and
// walks kDerivRowsPerWarp rows, unrolled, and the C values of a plane's row
// go out as one 16-byte store (per element where m % C != 0 leaves rows
// unaligned).  Ragged edges are masked; the diagonal is row == col on global
// indices (the TPU body needed iota masks for this).
//
// B1 evaluates the folded element of closed_forms.cuh, B4's (LeafValue,
// TreeValue): constants folded once per block, ex2.approx, the hand-reduced
// sine and RQ's log1p_base in float32, no divide in the element, and h^2 at
// the store.  A pivot row 1 x n is one launch, bit for bit the column n x 1.
//
// B2a, B2b: what an element evaluates (Eval) is the P Jacobian values
// (B2a), the P(P+1)/2 upper-triangle Hessian values stored to all P x P
// planes (B2b, every plane from one evaluation of E), or one Hessian value
// (B2b for hessian_pair, whose callers rely on one-slice peak memory), a
// template per upper-triangle entry that evaluates that value's closed form
// alone (closed_forms.cuh, HessValue).  The forms keep the accurate expf /
// sinf.
//
// Chains: the samplers evaluate C parameter vectors at once (the JAX
// package vmaps the Pallas calls).  B1 and B2a take a (C, stride) parameter
// table in one launch, chain c = blockIdx.z reading its row and writing its
// own output at c times the output's size; every chain shares x.  The work
// and the bound are C times one matrix's, and at the samplers' N=500 one
// matrix alone (1 MB) would fill a few dozen blocks of the card.  B2a
// contracted (order 0) is the samplers' gradient: B2a's element over the
// table summed against alpha alpha^T - K^-1, the Jacobian never stored
// (pairwise_jac_contract_kernel below).
//
// Families: B1 evaluates every leaf of closed_forms.cuh and, as kTree, a
// Sum/Product tree of them (TreeValue: the program as a sum of products,
// the kernel's __grid_constant__ parameter), single and over the chain
// table.  B2a and B2b take the leaves only: the JAX package
// builds a tree's derivatives at matrix level from its children
// (models/composite.py).  The kernels are templates over the element's
// evaluator; pairwise.cu instantiates B1 and SE's and periodic's B2,
// pairwise_ext_f32.cu / pairwise_ext_f64.cu the other families' B2, so the
// build compiles them in parallel.

#pragma once

#include <algorithm>
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "closed_forms.cuh"
#include "product_common.cuh"

namespace gp {

// the launch geometry of B2: `chains` parameter rows `stride` apart (the
// Hessian's callers pass one row); for B2a contracted (order 0), the
// contraction's operands: alpha (chains, n), K^-1 (chains, n, n) and the
// scratch of block partials (chains, P, jac_contract_blocks)
struct DerivLaunch {
  int n, m, chains, stride;
  cudaStream_t stream;
  const void* alpha = nullptr;
  const void* inv_K = nullptr;
  void* partial = nullptr;
};

// B2 for Matern 3/2, Matern 5/2 and RQ (pairwise_ext_f32.cu,
// pairwise_ext_f64.cu): as launch_deriv_form below for `family` (order 0,
// B2a contracted, too), or cudaErrorInvalidValue for any other family
int launch_deriv_ext(const float* x1, const float* x2, const float* params, float* out,
                     int family, int order, int value, const DerivLaunch& g);
int launch_deriv_ext(const double* x1, const double* x2, const double* params, double* out,
                     int family, int order, int value, const DerivLaunch& g);

}  // namespace gp

namespace {

constexpr int kMaxGridY = 65535;
constexpr int kDerivWarps = 8;                                  // B1, B2: warps per block
constexpr int kDerivThreads = 32 * kDerivWarps;                 // B1, B2: threads per block
constexpr int kDerivRowsPerWarp = 4;                            // B1, B2: rows each thread walks
constexpr int kDerivRows = kDerivWarps * kDerivRowsPerWarp;     // B1, B2: rows per block
constexpr int kTreeRows = 2;  // B1's tree: rows a thread evaluates at once

// B1's store of one row's C values: scaled, the diagonal term where row ==
// col, one 16-byte store where the row allows
template <typename T, int C>
__device__ __forceinline__ void store_k_row(T* out, const T* val, T scale, T diag, int with_diag,
                                            int row, int m, int col0, int valid, bool vec) {
  T v[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    v[c] = val[c] * scale;
    if (with_diag && row == col0 + c) v[c] += diag;
  }
  stv(out + static_cast<size_t>(row) * m + col0, v, valid, vec);
}

// B1: K[i, j] = scale v(x1_i - x2_j) (+ the diagonal term where row == col)
// for the folded element Eval (closed_forms.cuh: gp::LeafValue, scale h^2;
// gp::TreeValue, scale the product of h^2 of a one-term tree, else 1), in
// B2's layout.  Chain c = blockIdx.z reads row c of the parameter table
// (params + c * stride: the kernel's parameters, then the diagonal term) and
// writes the c-th (n, m) matrix; one matrix is the case gridDim.z = 1.
template <typename T, typename Eval>
__global__ void __launch_bounds__(kDerivThreads, 1)
pairwise_k_kernel(const T* __restrict__ x1, const T* __restrict__ x2,
                  const T* __restrict__ params, T* __restrict__ out, int n, int m,
                  int with_diag, int stride, const __grid_constant__ gp::TreeProgram prog) {
  constexpr int C = vec_elems<T>();
  __shared__ T xr[kDerivRows];
  params += static_cast<size_t>(blockIdx.z) * stride;
  out += static_cast<size_t>(blockIdx.z) * n * m;
  const Eval ev(params, prog);
  const T scale = static_cast<T>(ev.scale[0]);
  const T diag = with_diag ? params[ev.n_params()] : T(0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col0 = blockIdx.x * (32 * C) + lane * C;
  T xc[C];  // columns past m compute with column m - 1 and store nothing
#pragma unroll
  for (int c = 0; c < C; ++c) xc[c] = x2[min(col0 + c, m - 1)];
  const int valid = m - col0;
  const bool vec = m % C == 0;
  for (int rb = blockIdx.y; rb * kDerivRows < n; rb += gridDim.y) {
    const int row_base = rb * kDerivRows;
    __syncthreads();  // every thread is done with the previous rows
    if (threadIdx.x < kDerivRows) xr[threadIdx.x] = x1[min(row_base + threadIdx.x, n - 1)];
    __syncthreads();
    if constexpr (gp::kIsTree<Eval>) {
      // a tree: kTreeRows rows' C elements at once, the row loop rolled
      // (the element is long: unrolled it overflowed the instruction cache)
#pragma unroll 1
      for (int q = 0; q < kDerivRowsPerWarp; q += kTreeRows) {
        T d[kTreeRows * C], v[kTreeRows * C];
#pragma unroll
        for (int g = 0; g < kTreeRows; ++g) {
          const T xi = xr[(q + g) * kDerivWarps + warp];
#pragma unroll
          for (int c = 0; c < C; ++c) d[g * C + c] = xi - xc[c];
        }
        ev.eval(d, v);
#pragma unroll
        for (int g = 0; g < kTreeRows; ++g) {
          const int row = row_base + (q + g) * kDerivWarps + warp;
          if (row < n) {
            store_k_row<T, C>(out, v + g * C, scale, diag, with_diag, row, m, col0, valid, vec);
          }
        }
      }
    } else {
#pragma unroll
      for (int q = 0; q < kDerivRowsPerWarp; ++q) {
        const int ii = q * kDerivWarps + warp;  // the block's warps write neighbouring rows
        const int row = row_base + ii;
        if (row >= n) break;
        const T xi = xr[ii];
        T d[C], v[C];
#pragma unroll
        for (int c = 0; c < C; ++c) d[c] = xi - xc[c];
        ev.eval(d, v);
        store_k_row<T, C>(out, v, scale, diag, with_diag, row, m, col0, valid, vec);
      }
    }
  }
}

// -- B2: what an element evaluates, and which value each output plane takes

// position of (p, q), p <= q, in hess's row-major upper triangle
__host__ __device__ constexpr int tri(int p, int q, int P) {
  return p * P - p * (p - 1) / 2 + (q - p);
}

// B2a (Order 1): the P planes of dK/dtheta; B2b (Order 2): the P x P planes
// of d2K/dtheta2, filled from the upper triangle
template <typename T, typename Form, int Order>
struct FormEval {
  static constexpr int P = Form::P;
  static constexpr int kVals = Order == 1 ? P : P * (P + 1) / 2;
  static constexpr int kPlanes = Order == 1 ? P : P * P;
  __host__ __device__ static constexpr int src(int k) {
    return Order == 1 ? k : (k / P <= k % P ? tri(k / P, k % P, P) : tri(k % P, k / P, P));
  }
  T th[P];
  __device__ explicit FormEval(const T* params) {
#pragma unroll
    for (int q = 0; q < P; ++q) th[q] = params[q];
  }
  __device__ __forceinline__ void eval(T d, T (&val)[kVals]) const {
    if constexpr (Order == 1) {
      Form::jac(d, th, val);
    } else {
      Form::hess(d, th, val);
    }
  }
};

template <typename T, typename Value>
struct PlaneEval {  // B2b: one plane, one closed form
  static constexpr int kVals = 1;
  static constexpr int kPlanes = 1;
  __host__ __device__ static constexpr int src(int) { return 0; }
  Value value;
  __device__ explicit PlaneEval(const T* params) : value(params) {}
  __device__ __forceinline__ void eval(T d, T (&val)[kVals]) const { val[0] = value(d); }
};

// out[k][i][j] = val_src(k)(x1_i - x2_j), k < kPlanes.  One block per SM as
// the launch bound's floor: without it ptxas caps the registers and spills
// (float64's one-plane instantiations)
// Chain c = blockIdx.z reads row c of the parameter table (params + c *
// stride) and writes its kPlanes planes at out + c * kPlanes * n * m; the
// offset keeps a plane's rows 16-byte aligned whenever m % C == 0.
template <typename T, typename Eval>
__global__ void __launch_bounds__(kDerivThreads, 1)
pairwise_deriv_kernel(const T* __restrict__ x1, const T* __restrict__ x2,
                      const T* __restrict__ params, T* __restrict__ out, int n, int m,
                      int stride) {
  constexpr int C = vec_elems<T>();
  constexpr int kV = Eval::kVals;
  __shared__ T xr[kDerivRows];
  const size_t plane = static_cast<size_t>(n) * m;
  params += static_cast<size_t>(blockIdx.z) * stride;
  out += static_cast<size_t>(blockIdx.z) * Eval::kPlanes * plane;
  const Eval ev(params);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col0 = blockIdx.x * (32 * C) + lane * C;
  T xc[C];  // columns past m compute with column m - 1 and store nothing
#pragma unroll
  for (int c = 0; c < C; ++c) xc[c] = x2[min(col0 + c, m - 1)];
  const int valid = m - col0;
  const bool vec = m % C == 0;
  for (int rb = blockIdx.y; rb * kDerivRows < n; rb += gridDim.y) {
    const int row_base = rb * kDerivRows;
    __syncthreads();  // every thread is done with the previous rows
    if (threadIdx.x < kDerivRows) xr[threadIdx.x] = x1[min(row_base + threadIdx.x, n - 1)];
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kDerivRowsPerWarp; ++q) {
      const int ii = q * kDerivWarps + warp;  // the block's warps write neighbouring rows
      const int row = row_base + ii;
      if (row >= n) break;
      const T xi = xr[ii];
      T vals[kV][C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        T val[kV];
        ev.eval(xi - xc[c], val);
#pragma unroll
        for (int p = 0; p < kV; ++p) vals[p][c] = val[p];
      }
      T* o = out + static_cast<size_t>(row) * m + col0;
#pragma unroll
      for (int k = 0; k < Eval::kPlanes; ++k) stv(o + k * plane, vals[Eval::src(k)], valid, vec);
    }
  }
}

// B2's grid: 32 C columns by kDerivRows rows a block, a chain a z index
template <typename T>
dim3 deriv_grid(int n, int m, int chains) {
  constexpr int C = vec_elems<T>();
  return dim3((m + 32 * C - 1) / (32 * C),
              std::min((n + kDerivRows - 1) / kDerivRows, kMaxGridY), chains);
}

template <typename T, typename Eval>
int launch_deriv_eval(const T* x1, const T* x2, const T* params, T* out,
                      const gp::DerivLaunch& g) {
  pairwise_deriv_kernel<T, Eval><<<deriv_grid<T>(g.n, g.m, g.chains), kDerivThreads, 0,
                                   g.stream>>>(x1, x2, params, out, g.n, g.m, g.stride);
  return static_cast<int>(cudaGetLastError());
}

// -- B2a contracted over the chains (order 0) ----------------------------
//
// g[c][p] = 1/2 sum_ij dK_p(x_i - x_j; theta_c) W_ij, W = alpha_c alpha_c^T -
// K_c^-1: the kernel-parameter terms of the chains' gradient, 1/2 alpha^T
// K_p alpha - 1/2 tr(K^-1 K_p), with dK/dtheta never stored
// (models/gp.py::log_marginal_value_and_grad_chains).  It replaces no TPU
// kernel on its own: it fuses B2a over the chains (the JAX package's vmap
// of _pairwise_deriv, gaussian_processes_tpu/ops/pairwise.py:297) with the
// two contractions its value+grad makes of that output
// (gaussian_processes_tpu/models/gp.py:347-348), which on the card wrote
// the Jacobian, copied it twice and read it with GEMVs.
//
// Bound: the read of K^-1, n^2 values a chain (1024 chains at n = 500 in
// float32: 1.02 GB, 0.31 ms at 3.35 TB/s), and n^2 exponentials or sines a
// chain.  dK_p and W are symmetric, so a block walks the upper triangle:
// rows wholly below its columns are skipped and an element above the
// diagonal counts twice, which halves both.  The grid and the element are
// B2a's (FormEval<T, Form, 1>, chain = blockIdx.z); a thread reads its C
// columns of a K^-1 row in one 16-byte load, alpha_i from shared memory
// beside x_i and alpha_j from registers, and keeps P running sums.  Warp
// shuffles, then shared memory, reduce them to one partial a block and
// plane, (chains, P, blocks); a second pass adds a chain's partials in a
// fixed order.  No float atomics: a call repeats bit for bit.
template <typename T, typename Eval>
__global__ void __launch_bounds__(kDerivThreads, 1)
pairwise_jac_contract_kernel(const T* __restrict__ x, const T* __restrict__ params,
                             const T* __restrict__ alpha, const T* __restrict__ inv_K,
                             T* __restrict__ partial, int n, int stride) {
  constexpr int C = vec_elems<T>();
  constexpr int P = Eval::kVals;
  __shared__ T xr[kDerivRows], ar[kDerivRows];
  __shared__ T red[kDerivWarps][P];
  params += static_cast<size_t>(blockIdx.z) * stride;
  alpha += static_cast<size_t>(blockIdx.z) * n;
  inv_K += static_cast<size_t>(blockIdx.z) * n * n;
  const Eval ev(params);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col0 = blockIdx.x * (32 * C) + lane * C;
  const int last_col = min(static_cast<int>(blockIdx.x + 1) * 32 * C, n) - 1;
  T xc[C], ac[C];  // columns past n compute with column n - 1 and weigh 0
#pragma unroll
  for (int c = 0; c < C; ++c) {
    xc[c] = x[min(col0 + c, n - 1)];
    ac[c] = alpha[min(col0 + c, n - 1)];
  }
  const int valid = n - col0;
  const bool vec = n % C == 0;
  T acc[P];
#pragma unroll
  for (int p = 0; p < P; ++p) acc[p] = T(0);
  // rows past the block's last column lie below its part of the diagonal
  for (int rb = blockIdx.y; rb * kDerivRows <= last_col; rb += gridDim.y) {
    const int row_base = rb * kDerivRows;
    __syncthreads();  // every thread is done with the previous rows
    if (threadIdx.x < kDerivRows) {
      const int r = min(row_base + threadIdx.x, n - 1);
      xr[threadIdx.x] = x[r];
      ar[threadIdx.x] = alpha[r];
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kDerivRowsPerWarp; ++q) {
      const int ii = q * kDerivWarps + warp;
      const int row = row_base + ii;
      if (row > last_col) break;  // the warp's rows from here on weigh 0
      const T xi = xr[ii], ai = ar[ii];
      T kinv[C];
      ldg_run(inv_K + static_cast<size_t>(row) * n + col0, kinv, valid, vec);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int col = col0 + c;
        // above the diagonal twice, on it once, below it and past n not at all
        const T wt = col >= n ? T(0) : (col > row ? T(2) : (col == row ? T(1) : T(0)));
        const T w = wt * (ai * ac[c] - kinv[c]);
        T val[P];
        ev.eval(xi - xc[c], val);
#pragma unroll
        for (int p = 0; p < P; ++p) acc[p] += val[p] * w;
      }
    }
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    T s = acc[p];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) red[warp][p] = s;
  }
  __syncthreads();
  if (threadIdx.x < P) {
    T s = red[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < kDerivWarps; ++w) s += red[w][threadIdx.x];
    const size_t blocks = static_cast<size_t>(gridDim.x) * gridDim.y;
    partial[(static_cast<size_t>(blockIdx.z) * P + threadIdx.x) * blocks +
            blockIdx.y * gridDim.x + blockIdx.x] = s;
  }
}

// the second pass: out[i] = 1/2 the sum of row i's `blocks` partials, in order
template <typename T>
__global__ void pairwise_contract_finish_kernel(const T* __restrict__ partial,
                                                T* __restrict__ out, int rows, int blocks) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows) return;
  const T* p = partial + static_cast<size_t>(i) * blocks;
  T s = p[0];
  for (int b = 1; b < blocks; ++b) s += p[b];
  out[i] = T(0.5) * s;
}

template <typename T, typename Eval>
int launch_contract_eval(const T* x, const T* params, T* out, const gp::DerivLaunch& g) {
  const dim3 grid = deriv_grid<T>(g.n, g.n, g.chains);
  pairwise_jac_contract_kernel<T, Eval><<<grid, kDerivThreads, 0, g.stream>>>(
      x, params, static_cast<const T*>(g.alpha), static_cast<const T*>(g.inv_K),
      static_cast<T*>(g.partial), g.n, g.stride);
  const int rows = g.chains * Eval::kVals;
  pairwise_contract_finish_kernel<T><<<(rows + 255) / 256, 256, 0, g.stream>>>(
      static_cast<const T*>(g.partial), out, rows, static_cast<int>(grid.x * grid.y));
  return static_cast<int>(cudaGetLastError());
}

// one Hessian plane: the upper-triangle value V, for V = 0 .. Vals - 1
template <typename T, typename Form, int V, int Vals>
int launch_hess_value(const T* x1, const T* x2, const T* params, T* out, int value,
                      const gp::DerivLaunch& g) {
  if constexpr (V < Vals) {
    if (value == V) {
      return launch_deriv_eval<T, PlaneEval<T, typename Form::template HessValue<V>>>(
          x1, x2, params, out, g);
    }
    return launch_hess_value<T, Form, V + 1, Vals>(x1, x2, params, out, value, g);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// order 0: the Jacobian contracted with g's operands (x1 = x2), out (chains,
// P); order 1: the Jacobian; order 2 and value < 0: every Hessian plane;
// order 2 and value >= 0: the plane of that upper-triangle value
template <typename T, typename Form>
int launch_deriv_form(const T* x1, const T* x2, const T* params, T* out, int order,
                      int value, const gp::DerivLaunch& g) {
  if (order == 0) {
    return launch_contract_eval<T, FormEval<T, Form, 1>>(x1, params, out, g);
  }
  if (order == 1) {
    return launch_deriv_eval<T, FormEval<T, Form, 1>>(x1, x2, params, out, g);
  }
  if (value < 0) {
    return launch_deriv_eval<T, FormEval<T, Form, 2>>(x1, x2, params, out, g);
  }
  return launch_hess_value<T, Form, 0, FormEval<T, Form, 2>::kVals>(x1, x2, params, out,
                                                                     value, g);
}

}  // namespace
