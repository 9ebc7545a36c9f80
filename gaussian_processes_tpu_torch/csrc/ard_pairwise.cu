// B6: the ARD-SE covariance K[i, j] = h^2 exp(-1/2 sum_d ((x1_id - x2_jd) /
// w_d)^2) over (n, D) and (m, D) inputs, D <= 16, with an optional
// s^2 + jitter on the global diagonal.
//
// Replaces the Pallas body gaussian_processes_tpu/ops/pairwise.py::
// _ard_tile_body (through _pairwise_ard).
//
// Bound on the H100: the HBM write of K, n m sizeof(T) bytes (16384^2 in
// float32 is 1.07 GB, 0.32 ms at 3.35 TB/s); the (3D + 1) n m operations
// take less than half of that.  At the pivot rows of the pivoted Cholesky
// (1 x 65536) the work is 0.7 us and the launch sets the time.
//
// The arithmetic is B4-ARD's (ard_matvec.cuh), so the pivot rows of the
// preconditioner equal the CG operator's entries to rounding: the factors
// s_d = c / w_d, c = sqrt(log2(e) / 2) in float32 and sqrt(1 / 2) in
// float64, are divided in double and rounded to T once, as
// ops/pairwise.py::ard_scale rounds them, and each coordinate is scaled by
// one rounded multiply (__fmul_rn / __dmul_rn, never contracted), as
// ard_prescale scales it; then sq = sum_d (xs_1d - xs_2d)^2
// one dimension at a time through fma, and k = h^2 2^-sq (one ex2.approx,
// 2 ulp) in float32, h^2 exp(-sq) in float64.  D is a template parameter
// (one instantiation per D = 1..16), so the dimension loop has no guards.
// For x1 is x2 the difference of (j, i) is the negated difference of
// (i, j), so K is bitwise symmetric; on the diagonal it is exactly 0, so
// K[i, i] = h^2 + diag exactly.
//
// h, w and the diagonal term are read through pointers, so a call is one
// launch and nothing else: at the pivot rows, each small op around the
// kernel would cost as much device time as the kernel.
//
// Two layouts keep every thread on output elements:
//
// * tile (n, m >= kSkinny): a block of kThreads threads covers kTileRows rows
//   by kCols = 32 C columns, C = 16 bytes / sizeof(T) (4 in float32, 2 in
//   float64).  The block stages its columns' scaled coordinates transposed,
//   [D][kCols], and its rows' as [kTileRows][DP] in shared memory; a thread
//   keeps its C columns' D coordinates in registers (one 16-byte load per
//   dimension) and walks kRowsPerWarp rows, reading each row's coordinates
//   as broadcast vector loads; the C elements of a row go out as one
//   16-byte store (per element where m % C != 0 leaves rows unaligned),
//   ragged edges masked;
// * flat (min(n, m) < kSkinny: the pivot rows and columns of the pivoted
//   Cholesky, cross-covariances with few test points): a thread owns one
//   element of the flattened n x m output (65536 threads for a pivot row,
//   so the launch's latency is hidden across four blocks per SM), reads
//   both points' coordinates from global memory and stores coalesced; a
//   block divides its D factors once, into shared memory.
//
// Flat indices are 64-bit.

#include <algorithm>
#include <cstddef>
#include <utility>

#include <cuda_runtime.h>

#include "product_common.cuh"

namespace {

constexpr int kMaxDim = 16;
constexpr int kWarps = 8;                          // tile: warps per block
constexpr int kThreads = 32 * kWarps;              // tile: threads per block
constexpr int kRowsPerWarp = 8;                    // tile: rows each thread walks
constexpr int kTileRows = kWarps * kRowsPerWarp;   // tile: rows per block
constexpr int kSkinny = 128;  // below this min(n, m), the flat layout
constexpr int kFlatThreads = 128;
constexpr int kMaxGridY = 65535;
constexpr int kMaxFlatBlocks = 1 << 20;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

// s = c / w, divided in double and rounded once
template <typename T>
__device__ __forceinline__ T ard_factor(double c, T w) {
  return static_cast<T>(c / static_cast<double>(w));
}

// h^2 base^(-sq), the product rounded on its own (no fma with the diagonal)
template <typename T>
__device__ __forceinline__ T ard_value(T h2, T sq) {
  return mul_rn(h2, neg_exp(sq));
}

// one block per SM as the launch bound's floor: without it ptxas caps the
// registers (64 at D = 8 in float32) and spills
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
ard_tile_kernel(const T* __restrict__ x1, const T* __restrict__ x2, const T* __restrict__ hp,
                const T* __restrict__ w, const T* __restrict__ diag_p, T* __restrict__ out,
                int n, int m, double c) {
  constexpr int C = vec_elems<T>();
  constexpr int kCols = 32 * C;
  constexpr int DP = padded_dim<T, D>();
  __shared__ __align__(16) T cs[D * kCols];
  __shared__ __align__(16) T rs[kTileRows * DP];
  __shared__ T sc[D];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col_base = blockIdx.x * kCols;
  const int col0 = col_base + lane * C;
  const T h = *hp;
  const T h2 = h * h;
  const bool with_diag = diag_p != nullptr;
  const T diag = with_diag ? *diag_p : T(0);
  if (threadIdx.x < D) sc[threadIdx.x] = ard_factor(c, w[threadIdx.x]);
  __syncthreads();

  // the block's columns, scaled, transposed; columns past m stage as 0
  const int ccnt = min(kCols, m - col_base);
  for (int e = threadIdx.x; e < kCols * D; e += kThreads) {
    const int jj = e / D;
    const int d = e - jj * D;
    cs[d * kCols + jj] =
        jj < ccnt ? mul_rn(x2[static_cast<size_t>(col_base) * D + e], sc[d]) : T(0);
  }
  __syncthreads();
  T xc[C][D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    T t[C];
    ldv<C>(cs + d * kCols + lane * C, t);
#pragma unroll
    for (int c = 0; c < C; ++c) xc[c][d] = t[c];
  }
  const int valid = m - col0;
  const bool vec = m % C == 0;

  for (int rb = blockIdx.y; rb * kTileRows < n; rb += gridDim.y) {
    const int row_base = rb * kTileRows;
    const int rcnt = min(kTileRows, n - row_base);
    __syncthreads();  // every thread is done with the previous rows
    for (int e = threadIdx.x; e < kTileRows * DP; e += kThreads) {
      const int ii = e / DP;
      const int d = e - ii * DP;
      rs[e] = (ii < rcnt && d < D)
                  ? mul_rn(x1[static_cast<size_t>(row_base + ii) * D + d], sc[d])
                  : T(0);
    }
    __syncthreads();
    // float64 unrolls less: eight rows of its wider coordinates spill
    constexpr int kUnroll = sizeof(T) == 4 ? kRowsPerWarp : 2;
#pragma unroll kUnroll
    for (int q = 0; q < kRowsPerWarp; ++q) {
      const int ii = q * kWarps + warp;  // the block's warps write neighbouring rows
      const int row = row_base + ii;
      if (ii >= rcnt) break;
      T xr[DP];
      ldv<DP>(rs + ii * DP, xr);
      T v[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        T sq = T(0);
#pragma unroll
        for (int d = 0; d < D; ++d) {
          const T t = xr[d] - xc[c][d];
          sq = fma(t, t, sq);
        }
        v[c] = ard_value(h2, sq);
        if (with_diag && row == col0 + c) v[c] += diag;
      }
      stv(out + static_cast<size_t>(row) * m + col0, v, valid, vec);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kFlatThreads)
ard_flat_kernel(const T* __restrict__ x1, const T* __restrict__ x2, const T* __restrict__ hp,
                const T* __restrict__ w, const T* __restrict__ diag_p, T* __restrict__ out,
                int n, int m, double c) {
  __shared__ T sc[D];
  if (threadIdx.x < D) sc[threadIdx.x] = ard_factor(c, w[threadIdx.x]);
  const T h = *hp;
  const T h2 = h * h;
  const bool with_diag = diag_p != nullptr;
  const T diag = with_diag ? *diag_p : T(0);
  __syncthreads();
  T s[D];
#pragma unroll
  for (int d = 0; d < D; ++d) s[d] = sc[d];
  const size_t total = static_cast<size_t>(n) * m;
  const bool narrow = total <= 0xffffffffu;  // 32-bit division where it suffices
  const size_t stride = static_cast<size_t>(gridDim.x) * kFlatThreads;
  for (size_t e = static_cast<size_t>(blockIdx.x) * kFlatThreads + threadIdx.x; e < total;
       e += stride) {
    size_t i;
    if (narrow) {
      i = static_cast<unsigned>(e) / static_cast<unsigned>(m);
    } else {
      i = e / static_cast<size_t>(m);
    }
    const size_t j = e - i * m;
    const T* a = x1 + i * D;
    const T* b = x2 + j * D;
    T sq = T(0);
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const T t = mul_rn(a[d], s[d]) - mul_rn(b[d], s[d]);
      sq = fma(t, t, sq);
    }
    T v = ard_value(h2, sq);
    if (with_diag && i == j) v += diag;
    out[e] = v;
  }
}

template <typename T, int D>
int launch_dim(const T* x1, const T* x2, const T* h, const T* w, const T* diag, T* out, int n,
               int m, double c, cudaStream_t stream) {
  constexpr int C = vec_elems<T>();
  if (std::min(n, m) < kSkinny) {
    const size_t blocks = (static_cast<size_t>(n) * m + kFlatThreads - 1) / kFlatThreads;
    const int grid = static_cast<int>(std::min<size_t>(blocks, kMaxFlatBlocks));
    ard_flat_kernel<T, D><<<grid, kFlatThreads, 0, stream>>>(x1, x2, h, w, diag, out, n, m, c);
  } else {
    const dim3 grid((m + 32 * C - 1) / (32 * C),
                    std::min((n + kTileRows - 1) / kTileRows, kMaxGridY));
    ard_tile_kernel<T, D><<<grid, kThreads, 0, stream>>>(x1, x2, h, w, diag, out, n, m, c);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int... Ds>
int dispatch_dim(int dim, const T* x1, const T* x2, const T* h, const T* w, const T* diag,
                 T* out, int n, int m, double c, cudaStream_t stream,
                 std::integer_sequence<int, Ds...>) {
  int status = static_cast<int>(cudaErrorInvalidValue);
  ((dim == Ds + 1
        ? (status = launch_dim<T, Ds + 1>(x1, x2, h, w, diag, out, n, m, c, stream), 0)
        : 0),
   ...);
  return status;
}

template <typename T>
int launch_pairwise_ard(int device, const void* x1, const void* x2, const void* h,
                        const void* w, const void* diag, void* out, int n, int m, int dim,
                        double c, void* stream) {
  if (n <= 0 || m <= 0 || dim < 1 || dim > kMaxDim) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return dispatch_dim<T>(dim, static_cast<const T*>(x1), static_cast<const T*>(x2),
                         static_cast<const T*>(h), static_cast<const T*>(w),
                         static_cast<const T*>(diag), static_cast<T*>(out), n, m, c,
                         static_cast<cudaStream_t>(stream),
                         std::make_integer_sequence<int, kMaxDim>{});
}

}  // namespace

extern "C" {

// Each entry point returns cudaGetLastError() after its launch (0 =
// success).  Pointers are device pointers: x1 (n, dim) and x2 (m, dim)
// unscaled, h one value, w (dim,), diag one value or null for no diagonal
// term, out (n, m); c is the factor that w_d divides (sqrt(log2(e) / 2) in
// float32, sqrt(1 / 2) in float64).

int gp_pairwise_ard_f32(int device, const void* x1, const void* x2, const void* h,
                        const void* w, const void* diag, void* out, int n, int m, int dim,
                        double c, void* stream) {
  return launch_pairwise_ard<float>(device, x1, x2, h, w, diag, out, n, m, dim, c, stream);
}

int gp_pairwise_ard_f64(int device, const void* x1, const void* x2, const void* h,
                        const void* w, const void* diag, void* out, int n, int m, int dim,
                        double c, void* stream) {
  return launch_pairwise_ard<double>(device, x1, x2, h, w, diag, out, n, m, dim, c, stream);
}

}  // extern "C"
