// B4, B5: matrix-free kernel products; B6: the ARD covariance.  (B4-ARD,
// the ARD product, has a kernel of its own: ard_matvec.cuh.)
//
// Replaces the Pallas tile bodies of gaussian_processes_tpu/ops/pairwise.py:
//   B4     _matvec_tile_body      out = K(x, x) V, SE / periodic, 1-D x
//   B5     _jacvec_tile_body      out[p] = dK/dtheta_p (x, x) U for every p
//   B6     _ard_tile_body         K[i, j] for ARD-SE, optional s^2 + jitter
//                                 on the global diagonal
//
// B4 / B5.  K (and dK/dtheta) is never stored: device memory sees x, V and
// the (n, r) output only, so the bound on the H100 is arithmetic, about n^2
// closed-form evaluations (one exp, plus a sin for periodic) and n^2 r
// multiply-adds.  Each element is evaluated
// once and applied to every column of V that the block holds, with FP32 /
// FP64 FMAs on the CUDA cores: no TF32, the counterpart of the Pallas
// body's Precision.HIGHEST.
//
// A block of kRowsMv threads owns kRowsMv consecutive rows, one row per
// thread, and a chunk of RC <= 16 columns of V (grid axis y), so r = m
// right-hand sides work.  It walks its range of columns j in tiles of kTile,
// staging x_j and V[j, chunk] in shared memory; every thread reads the same
// x_j and V[j, c], a broadcast without bank conflicts.  A tile's kTile
// products are summed in T, and the tile sums are added across the row in
// double (ard_matvec.cuh says why); the two-level sum costs one add per tile.
// To give 132 SMs enough blocks at r = 1 the column range is split over grid
// axis z; each split writes its partial products to a workspace and a second
// kernel adds them in split order (splits.cuh), so a product gives the same
// bits on every call (no float atomics: CG and its early exit want a
// deterministic operator).
// Ragged edges are bounds-checked; flat indices are 64-bit (65536^2 > 2^31).
//
// B6 is B1 (pairwise.cu) over D dimensions: a block of kArdCols threads
// spans neighbouring columns, so stores coalesce, and each thread keeps its
// column's D coordinates and 1/w_d in registers.
//
// B6 multiplies by 1/w_d where the Pallas body divides by w_d: one rounding
// of difference per term, inside the stated tolerances.

#include <algorithm>
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "closed_forms.cuh"
#include "splits.cuh"

namespace {

constexpr int kRowsMv = 128;     // B4/B5: threads per block, one row each
constexpr int kTile = 128;       // B4/B5: columns of K per shared-memory tile
constexpr int kMaxArdDim = 16;   // largest D the ARD kernels take
constexpr int kArdCols = 128;    // B6: threads per block, one column each
constexpr int kArdRows = 16;     // B6: rows walked by each thread
constexpr int kMaxGrid = 65535;  // grid axes y and z

// -- what one product evaluates per element (i, j) ---------------------------

// B4: k(x_i - x_j)
template <typename T, typename Form>
struct KEval {
  static constexpr int kVals = 1;
  static constexpr int kDimCap = 1;
  T th[Form::P];
  T xi;
  __device__ KEval(const T* params, int) {
#pragma unroll
    for (int q = 0; q < Form::P; ++q) th[q] = params[q];
  }
  __device__ void set_row(const T* x, int row) { xi = x[row]; }
  __device__ void eval(const T* xj, T* vals) const {
    vals[0] = Form::k(xi - xj[0], th);
  }
};

// B5: dK/dtheta_p (x_i - x_j), p < P
template <typename T, typename Form>
struct JacEval {
  static constexpr int kVals = Form::P;
  static constexpr int kDimCap = 1;
  T th[Form::P];
  T xi;
  __device__ JacEval(const T* params, int) {
#pragma unroll
    for (int q = 0; q < Form::P; ++q) th[q] = params[q];
  }
  __device__ void set_row(const T* x, int row) { xi = x[row]; }
  __device__ void eval(const T* xj, T* vals) const {
    Form::jac(xi - xj[0], th, vals);
  }
};

// -- the product: out[z][q][i][c] = sum_{j in split z} eval_q(i, j) V[j][c] --

template <typename T, typename Eval, int RC>
__global__ void __launch_bounds__(kRowsMv)
product_kernel(const T* __restrict__ x, const T* __restrict__ v,
               const T* __restrict__ params, T* __restrict__ out, int n,
               int dim, int r, int cols_per_split) {
  constexpr int kV = Eval::kVals;
  __shared__ T xs[kTile * Eval::kDimCap];
  __shared__ T vs[kTile * RC];
  Eval ev(params, dim);
  const int row = blockIdx.x * kRowsMv + threadIdx.x;
  const int c0 = blockIdx.y * RC;
  const int j_begin = blockIdx.z * cols_per_split;
  const int j_end = min(n, j_begin + cols_per_split);
  ev.set_row(x, min(row, n - 1));  // rows past n compute and store nothing

  double acc[kV][RC];
#pragma unroll
  for (int q = 0; q < kV; ++q) {
#pragma unroll
    for (int c = 0; c < RC; ++c) acc[q][c] = 0.0;
  }
  for (int jt = j_begin; jt < j_end; jt += kTile) {
    const int cnt = min(kTile, j_end - jt);
    __syncthreads();  // every thread is done with the previous tile
    for (int e = threadIdx.x; e < cnt * dim; e += kRowsMv) {
      xs[e] = x[static_cast<size_t>(jt) * dim + e];
    }
    for (int e = threadIdx.x; e < kTile * RC; e += kRowsMv) {
      const int jj = e / RC;
      const int c = c0 + e % RC;
      vs[e] = (jj < cnt && c < r) ? v[static_cast<size_t>(jt + jj) * r + c] : T(0);
    }
    __syncthreads();
    T part[kV][RC];
#pragma unroll
    for (int q = 0; q < kV; ++q) {
#pragma unroll
      for (int c = 0; c < RC; ++c) part[q][c] = T(0);
    }
    for (int jj = 0; jj < cnt; ++jj) {
      T vals[kV];
      ev.eval(xs + jj * dim, vals);
#pragma unroll
      for (int q = 0; q < kV; ++q) {
#pragma unroll
        for (int c = 0; c < RC; ++c) part[q][c] = gp::dfma(vals[q], vs[jj * RC + c], part[q][c]);
      }
    }
#pragma unroll
    for (int q = 0; q < kV; ++q) {
#pragma unroll
      for (int c = 0; c < RC; ++c) acc[q][c] += static_cast<double>(part[q][c]);
    }
  }
  if (row >= n) return;
  T* o = out + static_cast<size_t>(blockIdx.z) * kV * n * r;
#pragma unroll
  for (int q = 0; q < kV; ++q) {
#pragma unroll
    for (int c = 0; c < RC; ++c) {
      if (c0 + c < r) o[(static_cast<size_t>(q) * n + row) * r + c0 + c] = static_cast<T>(acc[q][c]);
    }
  }
}

template <typename T, typename Eval, int RC>
int launch_product_rc(const T* x, const T* v, const T* params, T* out, T* work,
                      int n, int dim, int r, int splits, cudaStream_t stream) {
  const int tiles = (n + kTile - 1) / kTile;
  const int tiles_per_split = (tiles + splits - 1) / splits;
  const int used = (tiles + tiles_per_split - 1) / tiles_per_split;
  const dim3 grid((n + kRowsMv - 1) / kRowsMv, (r + RC - 1) / RC, used);
  if (grid.y > kMaxGrid || grid.z > kMaxGrid) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  product_kernel<T, Eval, RC><<<grid, kRowsMv, 0, stream>>>(
      x, v, params, used == 1 ? out : work, n, dim, r, tiles_per_split * kTile);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || used == 1) return static_cast<int>(err);
  return static_cast<int>(gp::launch_sum_splits<T>(
      work, out, static_cast<size_t>(Eval::kVals) * n * r, used, stream));
}

// RC, the columns of V a block holds: the smallest of 1, 4, 8, 16 that
// covers r, else the largest in chunks.  B5 holds P values per column; with
// P = 3 it stops at 8, which keeps its two accumulator sets in registers.
template <typename T, typename Eval>
int launch_product(const T* x, const T* v, const T* params, T* out, T* work,
                   int n, int dim, int r, int splits, cudaStream_t stream) {
  if (n <= 0 || r <= 0 || splits < 1 || (splits > 1 && work == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (r == 1) {
    return launch_product_rc<T, Eval, 1>(x, v, params, out, work, n, dim, r, splits, stream);
  }
  if (r <= 4) {
    return launch_product_rc<T, Eval, 4>(x, v, params, out, work, n, dim, r, splits, stream);
  }
  if constexpr (Eval::kVals > 2) {
    return launch_product_rc<T, Eval, 8>(x, v, params, out, work, n, dim, r, splits, stream);
  } else {
    if (r <= 8) {
      return launch_product_rc<T, Eval, 8>(x, v, params, out, work, n, dim, r, splits, stream);
    }
    return launch_product_rc<T, Eval, 16>(x, v, params, out, work, n, dim, r, splits, stream);
  }
}

template <typename T>
int launch_matvec(const T* x, const T* v, const T* params, T* out, T* work,
                  int n, int dim, int r, int family, int splits,
                  cudaStream_t stream) {
  switch (family) {
    case gp::kSE:
      if (dim != 1) break;
      return launch_product<T, KEval<T, gp::SEForm<T>>>(x, v, params, out, work, n, dim,
                                                        r, splits, stream);
    case gp::kPeriodic:
      if (dim != 1) break;
      return launch_product<T, KEval<T, gp::PeriodicForm<T>>>(x, v, params, out, work, n,
                                                              dim, r, splits, stream);
    default:
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch_jacvec(const T* x, const T* u, const T* params, T* out, T* work,
                  int n, int r, int family, int splits, cudaStream_t stream) {
  switch (family) {
    case gp::kSE:
      return launch_product<T, JacEval<T, gp::SEForm<T>>>(x, u, params, out, work, n, 1,
                                                          r, splits, stream);
    case gp::kPeriodic:
      return launch_product<T, JacEval<T, gp::PeriodicForm<T>>>(x, u, params, out, work,
                                                                n, 1, r, splits, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// -- B6 ----------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kArdCols)
pairwise_ard_kernel(const T* __restrict__ x1, const T* __restrict__ x2,
                    const T* __restrict__ params, T* __restrict__ out, int n,
                    int m, int dim, int with_diag) {
  const int col = blockIdx.x * kArdCols + threadIdx.x;
  if (col >= m) return;
  const T h = params[0];
  T iw[kMaxArdDim];
  T xc[kMaxArdDim];
#pragma unroll
  for (int d = 0; d < kMaxArdDim; ++d) {
    iw[d] = d < dim ? T(1) / params[1 + d] : T(0);
    xc[d] = d < dim ? x2[static_cast<size_t>(col) * dim + d] : T(0);
  }
  const T diag = with_diag ? params[1 + dim] : T(0);
  for (int rb = blockIdx.y; rb * kArdRows < n; rb += gridDim.y) {
    const int row0 = rb * kArdRows;
    const int rows = min(kArdRows, n - row0);
    for (int rr = 0; rr < rows; ++rr) {
      const int row = row0 + rr;
      const T* xr = x1 + static_cast<size_t>(row) * dim;
      T sq = T(0);
#pragma unroll
      for (int d = 0; d < kMaxArdDim; ++d) {
        if (d < dim) {
          const T t = (xr[d] - xc[d]) * iw[d];
          sq = gp::dfma(t, t, sq);
        }
      }
      T val = gp::ard_k(sq, h);
      if (with_diag && row == col) val += diag;
      out[static_cast<size_t>(row) * m + col] = val;
    }
  }
}

template <typename T>
int launch_pairwise_ard(const T* x1, const T* x2, const T* params, T* out,
                        int n, int m, int dim, int with_diag,
                        cudaStream_t stream) {
  if (n <= 0 || m <= 0 || dim < 1 || dim > kMaxArdDim) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((m + kArdCols - 1) / kArdCols,
                  std::min((n + kArdRows - 1) / kArdRows, kMaxGrid));
  pairwise_ard_kernel<T><<<grid, kArdCols, 0, stream>>>(x1, x2, params, out, n, m,
                                                        dim, with_diag);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each entry point returns cudaGetLastError() after its launches (0 =
// success).  Pointers are device pointers.  `work` holds `splits` slabs of
// the output (splits * P * n * r values) and may be null when splits == 1.

#define GP_PRODUCT_ENTRIES(SUFFIX, T)                                            \
  int gp_kernel_matvec_##SUFFIX(int device, const void* x, const void* v,        \
                                const void* params, void* out, void* work,       \
                                int n, int dim, int r, int family, int splits,   \
                                void* stream) {                                  \
    cudaError_t err = cudaSetDevice(device);                                     \
    if (err != cudaSuccess) return static_cast<int>(err);                        \
    return launch_matvec<T>(static_cast<const T*>(x), static_cast<const T*>(v),  \
                            static_cast<const T*>(params), static_cast<T*>(out), \
                            static_cast<T*>(work), n, dim, r, family, splits,    \
                            static_cast<cudaStream_t>(stream));                  \
  }                                                                              \
  int gp_kernel_jacvec_##SUFFIX(int device, const void* x, const void* u,        \
                                const void* params, void* out, void* work,       \
                                int n, int r, int family, int splits,            \
                                void* stream) {                                  \
    cudaError_t err = cudaSetDevice(device);                                     \
    if (err != cudaSuccess) return static_cast<int>(err);                        \
    return launch_jacvec<T>(static_cast<const T*>(x), static_cast<const T*>(u),  \
                            static_cast<const T*>(params), static_cast<T*>(out), \
                            static_cast<T*>(work), n, r, family, splits,         \
                            static_cast<cudaStream_t>(stream));                  \
  }                                                                              \
  int gp_pairwise_ard_##SUFFIX(int device, const void* x1, const void* x2,       \
                               const void* params, void* out, int n, int m,      \
                               int dim, int with_diag, void* stream) {           \
    cudaError_t err = cudaSetDevice(device);                                     \
    if (err != cudaSuccess) return static_cast<int>(err);                        \
    return launch_pairwise_ard<T>(                                               \
        static_cast<const T*>(x1), static_cast<const T*>(x2),                    \
        static_cast<const T*>(params), static_cast<T*>(out), n, m, dim,          \
        with_diag, static_cast<cudaStream_t>(stream));                           \
  }

GP_PRODUCT_ENTRIES(f32, float)
GP_PRODUCT_ENTRIES(f64, double)

#undef GP_PRODUCT_ENTRIES

}  // extern "C"
