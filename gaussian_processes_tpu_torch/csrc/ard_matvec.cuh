// B4-ARD: out = K_ARD(x, x) V over (n, D) inputs, D <= 16, any r, with K
// never stored.
//
// Replaces the Pallas body gaussian_processes_tpu/ops/pairwise.py::
// _ard_matvec_tile_body (ARD-SE through _fused_matvec).
//
// Bound on the H100: arithmetic.  Device memory sees x, V and the (n, r)
// output only; the work is n^2 evaluations of h^2 exp(-1/2 sum_d
// ((x_id - x_jd) / w_d)^2), each applied to r columns of V.  The design cuts
// the instructions per element and the shared-memory loads per element:
//
// * the wrapper pre-scales the coordinates once per launch (an O(nD) pass):
//   xs = x * c / w with c = sqrt(log2(e) / 2) in float32, so that
//   k = h^2 exp2(-sum_d (xs_id - xs_jd)^2), a dimension costs one subtract
//   and one FMA, and the exponential is one ex2.approx (2 ulp, as exp2f;
//   on an H100 80GB HBM3 at 700 W, N = 65536, D = 8, r = 8: 5.07 -> 4.58 ms,
//   the product's error unchanged at <1% of its allowance).  float64 takes c = sqrt(1/2) and
//   keeps exp.  h^2 multiplies the row's double sums once, at the end;
// * D is a template parameter (one instantiation per D = 1..16): the
//   coordinate arrays are exactly D long, with no per-dimension guard;
// * a thread owns ROWS rows (rows t, t + 128, ...), so every column staged
//   in shared memory (its D coordinates and its RC right-hand sides, read
//   as 16-byte broadcast loads) feeds ROWS elements, and the ROWS
//   independent exp/FMA chains hide each other's latency.
//
// What keeps the product correct and repeatable is the same as B4's
// (matvec.cuh): a tile's kTile products are summed in T and the tile sums in
// double -- summed in float32 alone, the ~2e4 terms of a row of the
// N = 65536 ARD workload lose ~3e-4 of ||y|| (a float32 sequential sum
// measured on the CPU at N = 8192 lost 1.4e-4), which the f64 residual check
// of the solve would see; the column range is split over grid z with the
// partials added in split order by a second kernel (splits.cuh), never by
// float atomics; flat indices are 64-bit; ragged edges are bounds-checked.
//
// One instantiation per D and RC takes a while to compile, so the float32
// and float64 entry points live in two sources (ard_matvec_f32.cu,
// ard_matvec_f64.cu) that the build compiles in parallel.

#pragma once

#include <cstddef>
#include <utility>

#include <cuda_runtime.h>

#include "product_common.cuh"
#include "splits.cuh"

namespace {

constexpr int kThreads = 128;  // threads per block
constexpr int kTile = 128;     // columns per shared-memory tile
constexpr int kMaxDim = 16;
constexpr int kMaxGrid = 65535;  // grid axes y and z

// out[z][i][c0 + c] = sum_{j in split z} k(i, j) V[j][c0 + c]
template <typename T, int D, int RC, int ROWS>
__global__ void __launch_bounds__(kThreads)
ard_matvec_kernel(const T* __restrict__ xs, const T* __restrict__ v,
                  const T* __restrict__ params, T* __restrict__ out, int n, int r,
                  int cols_per_split) {
  constexpr int DP = padded_dim<T, D>();
  __shared__ __align__(16) T xt[kTile * DP];
  __shared__ __align__(16) T vt[kTile * RC];
  const double h2 = static_cast<double>(params[0]) * params[0];
  const int row0 = blockIdx.x * (kThreads * ROWS) + threadIdx.x;
  const int c0 = blockIdx.y * RC;
  const int j_begin = blockIdx.z * cols_per_split;
  const int j_end = min(n, j_begin + cols_per_split);

  T xi[ROWS][D];  // rows past n compute with row n - 1 and store nothing
#pragma unroll
  for (int q = 0; q < ROWS; ++q) {
    const size_t row = static_cast<size_t>(min(row0 + q * kThreads, n - 1));
#pragma unroll
    for (int d = 0; d < D; ++d) xi[q][d] = xs[row * D + d];
  }
  double acc[ROWS][RC];
#pragma unroll
  for (int q = 0; q < ROWS; ++q) {
#pragma unroll
    for (int c = 0; c < RC; ++c) acc[q][c] = 0.0;
  }

  for (int jt = j_begin; jt < j_end; jt += kTile) {
    const int cnt = min(kTile, j_end - jt);
    __syncthreads();  // every thread is done with the previous tile
    for (int e = threadIdx.x; e < cnt * DP; e += kThreads) {
      const int jj = e / DP;
      const int d = e % DP;
      xt[e] = d < D ? xs[static_cast<size_t>(jt + jj) * D + d] : T(0);
    }
    for (int e = threadIdx.x; e < kTile * RC; e += kThreads) {
      const int jj = e / RC;
      const int c = c0 + e % RC;
      vt[e] = (jj < cnt && c < r) ? v[static_cast<size_t>(jt + jj) * r + c] : T(0);
    }
    __syncthreads();
    T part[ROWS][RC];
#pragma unroll
    for (int q = 0; q < ROWS; ++q) {
#pragma unroll
      for (int c = 0; c < RC; ++c) part[q][c] = T(0);
    }
#pragma unroll 2
    for (int jj = 0; jj < cnt; ++jj) {
      T xj[DP];
      T vj[RC];
      ldv<DP>(xt + jj * DP, xj);
      ldv<RC>(vt + jj * RC, vj);
#pragma unroll
      for (int q = 0; q < ROWS; ++q) {
        T sq = T(0);
#pragma unroll
        for (int d = 0; d < D; ++d) {
          const T t = xi[q][d] - xj[d];
          sq = fma(t, t, sq);
        }
        const T k = neg_exp(sq);
#pragma unroll
        for (int c = 0; c < RC; ++c) part[q][c] = fma(k, vj[c], part[q][c]);
      }
    }
#pragma unroll
    for (int q = 0; q < ROWS; ++q) {
#pragma unroll
      for (int c = 0; c < RC; ++c) acc[q][c] += static_cast<double>(part[q][c]);
    }
  }
  T* o = out + static_cast<size_t>(blockIdx.z) * n * r;
#pragma unroll
  for (int q = 0; q < ROWS; ++q) {
    const int row = row0 + q * kThreads;
    if (row >= n) break;
#pragma unroll
    for (int c = 0; c < RC; ++c) {
      if (c0 + c < r) o[static_cast<size_t>(row) * r + c0 + c] = static_cast<T>(acc[q][c] * h2);
    }
  }
}

// RC, the columns of V a block holds: 1 for r = 1 (the CG solve), 8 up to
// r = 8 (the SLQ probes), else chunks of 16; ROWS, the rows a thread owns:
// 8, 4 and 2, which keeps the double accumulators of ROWS x RC in registers
// (D = 8 in float32: 128, 168 and 168 registers, no spills; on an H100
// 80GB HBM3 at 700 W, ROWS = 8 at r = 1 took 2.83 ms where 4 took 3.14).
template <typename T, int D, int RC>
int launch_rc(const T* xs, const T* v, const T* params, T* out, T* work, int n, int r,
              int splits, cudaStream_t stream) {
  constexpr int ROWS = RC == 1 ? 8 : (RC <= 8 ? 4 : 2);
  const int tiles = (n + kTile - 1) / kTile;
  const int tiles_per_split = (tiles + splits - 1) / splits;
  const int used = (tiles + tiles_per_split - 1) / tiles_per_split;
  const dim3 grid((n + kThreads * ROWS - 1) / (kThreads * ROWS), (r + RC - 1) / RC, used);
  if (grid.y > kMaxGrid || grid.z > kMaxGrid) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ard_matvec_kernel<T, D, RC, ROWS><<<grid, kThreads, 0, stream>>>(
      xs, v, params, used == 1 ? out : work, n, r, tiles_per_split * kTile);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || used == 1) return static_cast<int>(err);
  return static_cast<int>(gp::launch_sum_splits<T>(work, out, static_cast<size_t>(n) * r,
                                                   used, stream));
}

template <typename T, int D>
int launch_dim(const T* xs, const T* v, const T* params, T* out, T* work, int n, int r,
               int splits, cudaStream_t stream) {
  if (r == 1) return launch_rc<T, D, 1>(xs, v, params, out, work, n, r, splits, stream);
  if (r <= 8) return launch_rc<T, D, 8>(xs, v, params, out, work, n, r, splits, stream);
  return launch_rc<T, D, 16>(xs, v, params, out, work, n, r, splits, stream);
}

template <typename T, int... Ds>
int dispatch_dim(int dim, const T* xs, const T* v, const T* params, T* out, T* work, int n,
                 int r, int splits, cudaStream_t stream, std::integer_sequence<int, Ds...>) {
  int status = static_cast<int>(cudaErrorInvalidValue);
  ((dim == Ds + 1
        ? (status = launch_dim<T, Ds + 1>(xs, v, params, out, work, n, r, splits, stream), 0)
        : 0),
   ...);
  return status;
}

template <typename T>
int launch_ard_matvec(int device, const T* xs, const T* v, const T* params, T* out,
                      T* work, int n, int dim, int r, int splits, cudaStream_t stream) {
  if (n <= 0 || r <= 0 || dim < 1 || dim > kMaxDim || splits < 1 ||
      (splits > 1 && work == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return dispatch_dim<T>(dim, xs, v, params, out, work, n, r, splits, stream,
                         std::make_integer_sequence<int, kMaxDim>{});
}

}  // namespace
