// B3: lower Cholesky factor of a batch of (128, 128) SPD tiles, one thread
// block per tile, the whole tile held in shared memory; optionally also the
// factor's inverse L^-1, which the blocked factorization needs per panel.
//
// Replaces the Pallas body gaussian_processes_tpu/ops/blocked_cholesky.py::
// _chol_vmem_body, the base panel of the left-looking blocked factorization.
//
// Bound on the H100: latency, not bytes or flops.  A tile is 64 KB (f32) or
// 128 KB (f64) read once and written once, and B^3/3 = 0.7 Mflop; what costs
// is the chain of B dependent column steps.  The design makes that chain as
// short as it can and keeps block-wide barriers out of it:
//
// * the tile is factored right-looking in four 32-column panels, with
//   three block barriers per panel;
// * A: one warp factors the panel's 32 x 32 diagonal block in registers,
//   lane l holding row l.  A column step is one shuffle of the pivot, one
//   reciprocal square root (every row multiplies by it: no divide per row),
//   and the column's multipliers written once to shared memory and read
//   back as broadcast vector loads for the rank-1 update.  The next pivot
//   is formed apart from the rest of its column, so the critical path of a
//   column is shuffle -> rsqrt -> multiply -> FMA -> shuffle, with no block
//   barrier.  (On an H100 80GB HBM3 at 700 W, a panel took 11.4k cycles
//   with 31 shuffles and a branch per entry per column and an IEEE sqrt and
//   divide; 3.5k this way.);
// * B: 128 threads, one row each, solve the rows below the block against it
//   (X = A21 L11^-T) with the block's columns read as broadcast vector
//   loads, and write the panel transposed (k-major) beside the tile;
// * C: the trailing lower triangle takes the rank-32 update as 4 x 4
//   register micro-tiles, one per thread, two 16-byte loads per 16 FMAs;
// * with the inverse, W = L^-1 is carried along as a block forward
//   substitution of the identity: B also solves the panel's rows of W
//   (one thread per column), C subtracts L21 W_p from the rows below.  W is
//   lower triangular, so it lives transposed in the tile's strict upper
//   triangle, and its diagonal is the reciprocals that A computed: the
//   inverse costs no more shared memory than one k-major panel.  Nothing
//   waits on W's update until the next B, so warp 0 factors the next block
//   (A) while the other 15 warps update W (look-ahead).
//
// Rows are padded to B + 1 elements so that row-wise and column-wise
// accesses of a warp fall in distinct banks.  The TPU body's masked column
// extraction existed only because Mosaic cannot index lanes dynamically.
//
// Numerics follow jnp.linalg.cholesky: the strict upper triangle is zero, and
// a tile that is not positive definite (a pivot that is not > 0, NaN
// included) comes back with its whole lower triangle NaN (and so does its
// inverse), never an error.

#include <atomic>
#include <cstddef>

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kTile = 128;
constexpr int kLd = kTile + 1;  // padded row stride in shared memory
constexpr int kThreads = 512;
constexpr int kNB = 32;  // panel width: one warp's lanes
constexpr int kPanels = kTile / kNB;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float quiet_nan(float) { return CUDART_NAN_F; }
__device__ __forceinline__ double quiet_nan(double) { return CUDART_NAN; }

// A pivot d gives L[k][k] and the 1 / L[k][k] that scales its column.
// float32: one MUFU rsqrt and one Newton step (within ~2 ulp of the IEEE
// sqrt and reciprocal, at a third of their latency on the critical path);
// float64: the IEEE sqrt and reciprocal.
__device__ __forceinline__ void pivot(float d, float& lkk, float& inv) {
  float y = rsqrtf(d);
  y = y * fmaf(-0.5f * d * y, y, 1.5f);
  inv = y;
  lkk = d * y;
}
__device__ __forceinline__ void pivot(double d, double& lkk, double& inv) {
  lkk = sqrt(d);
  inv = __drcp_rn(lkk);
}

// four consecutive values at a 16-byte aligned shared-memory address
__device__ __forceinline__ void ld4(const float* p, float (&o)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void ld4(const double* p, double (&o)[4]) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  const double2 b = *reinterpret_cast<const double2*>(p + 2);
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}

// four consecutive values at a 16-byte aligned device-memory address
__device__ __forceinline__ void ldg4(const float* p, float (&o)[4]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void ldg4(const double* p, double (&o)[4]) {
  const double2 a = __ldg(reinterpret_cast<const double2*>(p));
  const double2 b = __ldg(reinterpret_cast<const double2*>(p + 2));
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}

// Dynamic shared memory: the tile s (kTile x kLd), the panel P (k-major:
// P[k * kTile + i] = L[i][c0 + k]) and, with the inverse, Q (k-major:
// Q[k * kTile + c] = W[c0 + k][c]).
template <typename T, bool kInv>
constexpr size_t smem_bytes() {
  return sizeof(T) * (static_cast<size_t>(kTile) * kLd + (kInv ? 2 : 1) * kNB * kTile);
}

// A: warp 0 factors the diagonal block at (c0, c0) in registers, writes it
// back, its column multipliers to U (k-major) and its reciprocal pivots to
// dinv, and flags a pivot that is not > 0.
template <typename T>
__device__ __forceinline__ void factor_block(T* s, T* U, T* dinv, int* not_pd, int c0,
                                             int lane) {
  // Lane l holds row c0 + l; entries right of its diagonal start at 0
  // (the upper triangle) and take garbage that is never read, so the
  // updates below need no predicate per entry.
  T r[kNB];
#pragma unroll
  for (int j = 0; j < kNB; ++j) r[j] = s[(c0 + lane) * kLd + c0 + j];
  T d = __shfl_sync(kFull, r[0], 0);
  T my_inv = T(0);
  bool bad = false;
#pragma unroll
  for (int k = 0; k < kNB; ++k) {
    bad |= !(d > T(0));
    T lkk, inv;
    pivot(d, lkk, inv);
    my_inv = lane == k ? inv : my_inv;
    r[k] = lane == k ? lkk : r[k] * inv;
    if (k + 1 < kNB) {
      // the next pivot first: lane k+1's own multiplier, no round trip
      const T dn = fma(-r[k], r[k], r[k + 1]);
      d = __shfl_sync(kFull, dn, k + 1);
    }
    // the column's multipliers, read back as broadcast vector loads
    U[k * kNB + lane] = lane > k ? r[k] : T(0);
    __syncwarp();
#pragma unroll
    for (int q = (k + 1) / 4; q < kNB / 4; ++q) {
      T u[4];
      ld4(U + k * kNB + 4 * q, u);
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        if (4 * q + b > k) r[4 * q + b] = fma(-r[k], u[b], r[4 * q + b]);
      }
    }
  }
  if (lane == 0 && bad) *not_pd = 1;
  dinv[c0 + lane] = my_inv;
#pragma unroll
  for (int j = 0; j < kNB; ++j) {
    if (j <= lane) s[(c0 + lane) * kLd + c0 + j] = r[j];
  }
}

// B: rows below the block against L11 (L21 = A21 L11^-T), one thread per
// row, written to the tile and to P; with the inverse, the block's rows of W
// (W_p = L11^-1 (I - sum of earlier updates)), one thread per column,
// written to Q and to the tile's upper triangle.
template <typename T, bool kInv>
__device__ __forceinline__ void solve_panel(T* s, T* P, T* Q, const T* U, const T* dinv,
                                            int c0, int tid) {
  const int t0 = c0 + kNB;
  const int below = kTile - t0;
  if (tid < (kInv ? kTile : below)) {
    const bool is_row = tid < below;
    const int i = t0 + tid;           // row of L21
    const int c = tid - below;        // column of W (kInv)
    T x[kNB];
#pragma unroll
    for (int k = 0; k < kNB; ++k) {
      if (is_row) {
        x[k] = s[i * kLd + c0 + k];
      } else {
        const int row = c0 + k;  // W[row][c], stored at s[c][row] above the diagonal
        x[k] = row > c ? s[c * kLd + row] : T(row == c ? 1 : 0);
      }
    }
#pragma unroll
    for (int k = 0; k < kNB; ++k) {
      x[k] *= dinv[c0 + k];
#pragma unroll
      for (int q = (k + 1) / 4; q < kNB / 4; ++q) {
        T u[4];
        ld4(U + k * kNB + 4 * q, u);
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          if (4 * q + b > k) x[4 * q + b] = fma(-x[k], u[b], x[4 * q + b]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kNB; ++k) {
      if (is_row) {
        s[i * kLd + c0 + k] = x[k];
        P[k * kTile + i] = x[k];
      } else {
        Q[k * kTile + c] = x[k];
        if (c0 + k > c) s[c * kLd + c0 + k] = x[k];
      }
    }
  }
}

// C: the trailing lower triangle from t0 takes the rank-32 update
// A22 -= L21 L21^T, thread (ib, jb) its 4 x 4 micro-tile.
template <typename T>
__device__ __forceinline__ void update_trailing(T* s, const T* P, int t0, int ib, int jb) {
  const int i0 = t0 + 4 * ib;
  const int j0 = t0 + 4 * jb;
  const bool diag = ib == jb;
  T acc[4][4];
#pragma unroll
  for (int a4 = 0; a4 < 4; ++a4) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      acc[a4][b] = (!diag || b <= a4) ? s[(i0 + a4) * kLd + j0 + b] : T(0);
    }
  }
#pragma unroll 8
  for (int k = 0; k < kNB; ++k) {
    T pi[4], pj[4];
    ld4(P + k * kTile + i0, pi);
    ld4(P + k * kTile + j0, pj);
#pragma unroll
    for (int a4 = 0; a4 < 4; ++a4) {
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a4][b] = fma(-pi[a4], pj[b], acc[a4][b]);
    }
  }
#pragma unroll
  for (int a4 = 0; a4 < 4; ++a4) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      if (!diag || b <= a4) s[(i0 + a4) * kLd + j0 + b] = acc[a4][b];
    }
  }
}

// The rows of W below the panel take W[t0:, :t0] -= L21 W_p; micro-tile w.
template <typename T>
__device__ __forceinline__ void update_inverse(T* s, const T* P, const T* Q, int t0, int w) {
  const int nc = t0 / 4;
  const int i0 = t0 + 4 * (w / nc);
  const int cc = 4 * (w % nc);
  T acc[4][4];  // acc[a][b] = W[i0 + a][cc + b], stored at s[cc + b][i0 + a]
#pragma unroll
  for (int a4 = 0; a4 < 4; ++a4) {
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a4][b] = s[(cc + b) * kLd + i0 + a4];
  }
#pragma unroll 8
  for (int k = 0; k < kNB; ++k) {
    T pi[4], qc[4];
    ld4(P + k * kTile + i0, pi);
    ld4(Q + k * kTile + cc, qc);
#pragma unroll
    for (int a4 = 0; a4 < 4; ++a4) {
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a4][b] = fma(-pi[a4], qc[b], acc[a4][b]);
    }
  }
#pragma unroll
  for (int a4 = 0; a4 < 4; ++a4) {
#pragma unroll
    for (int b = 0; b < 4; ++b) s[(cc + b) * kLd + i0 + a4] = acc[a4][b];
  }
}

template <typename T, bool kInv>
__global__ void __launch_bounds__(kThreads, 1)
chol_tile_kernel(const T* __restrict__ a, T* __restrict__ l, T* __restrict__ linv) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  T* P = s + kTile * kLd;
  T* Q = P + kNB * kTile;
  __shared__ __align__(16) T U[kNB * kNB];  // U[k * kNB + j] = L[c0 + j][c0 + k], j > k
  __shared__ T dinv[kTile];                 // 1 / L[i][i] (= W[i][i])
  __shared__ int not_pd;

  const size_t base = static_cast<size_t>(blockIdx.x) * kTile * kTile;
  const int tid = threadIdx.x;
  const int lane = tid % 32;

  // the lower triangle of A; the strict upper triangle starts at 0 (W = I)
  {
    // every load in flight at once, 16 bytes at a time
    constexpr int kPer = kTile * kTile / (4 * kThreads);
    T v[kPer][4];
#pragma unroll
    for (int q = 0; q < kPer; ++q) ldg4(a + base + 4 * (tid + q * kThreads), v[q]);
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int e = 4 * (tid + q * kThreads);
      const int i = e / kTile;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int j = e % kTile + b;
        s[i * kLd + j] = j <= i ? v[q][b] : T(0);
      }
    }
  }
  if (tid == 0) not_pd = 0;
  // this thread's 4 x 4 micro-tile (ib, jb), jb <= ib, of a trailing triangle
  int ib = static_cast<int>((sqrtf(8.0f * tid + 1.0f) - 1.0f) * 0.5f);
  while ((ib + 1) * (ib + 2) / 2 <= tid) ++ib;
  while (ib * (ib + 1) / 2 > tid) --ib;
  const int jb = tid - ib * (ib + 1) / 2;
  __syncthreads();

  // Step p: B and C of panel p (none for p = -1), then A of panel p + 1 on
  // warp 0 while the other warps update W with panel p (look-ahead).  One
  // call site of A keeps one copy of its unrolled code.
  for (int p = -1; p < kPanels; ++p) {
    const int t0 = (p + 1) * kNB;  // first row below panel p
    const int mb = (kTile - t0) / 4;
    if (p >= 0) {
      solve_panel<T, kInv>(s, P, Q, U, dinv, p * kNB, tid);
      __syncthreads();
      if (mb == 0) break;
      if (tid < mb * (mb + 1) / 2) update_trailing(s, P, t0, ib, jb);
      __syncthreads();
    }
    if (tid < 32) {
      factor_block(s, U, dinv, &not_pd, t0, lane);
    } else if (kInv && p >= 0 && tid - 32 < mb * (t0 / 4)) {
      update_inverse(s, P, Q, t0, tid - 32);
    }
    __syncthreads();
  }

  const bool fail = not_pd != 0;
  const T nan = quiet_nan(T(0));
  // neighbouring threads take neighbouring columns: the row-wise read of L
  // and the column-wise read of W^T both fall in distinct banks
#pragma unroll 8
  for (int e = tid; e < kTile * kTile; e += kThreads) {
    const int i = e / kTile;
    const int j = e % kTile;
    l[base + e] = j <= i ? (fail ? nan : s[i * kLd + j]) : T(0);
    if (kInv) {
      const T w = j < i ? s[j * kLd + i] : (j == i ? dinv[i] : T(0));
      linv[base + e] = (fail && j <= i) ? nan : w;
    }
  }
}

// Opt in to the tile's dynamic shared memory (above 48 KB a launch is
// refused otherwise) once per kernel and device, not on every launch.
template <typename T, bool kInv>
cudaError_t configure(int device) {
  static std::atomic<unsigned long long> done{0};
  const unsigned long long bit = 1ull << device;
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      chol_tile_kernel<T, kInv>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes<T, kInv>()));
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

template <typename T, bool kInv>
int launch_chol(int device, const T* a, T* l, T* linv, int batch, int tile,
                cudaStream_t stream) {
  if (tile != kTile || batch <= 0 || device < 0 || device >= kMaxDevices) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = configure<T, kInv>(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  chol_tile_kernel<T, kInv><<<batch, kThreads, smem_bytes<T, kInv>(), stream>>>(a, l, linv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch (0 = success).  `a`, `l`
// and `linv` are device pointers to `batch` contiguous row-major (tile, tile)
// matrices.

int gp_chol_tile_f32(int device, const void* a, void* l, int batch, int tile,
                     void* stream) {
  return launch_chol<float, false>(device, static_cast<const float*>(a),
                                   static_cast<float*>(l), nullptr, batch, tile,
                                   static_cast<cudaStream_t>(stream));
}

int gp_chol_tile_f64(int device, const void* a, void* l, int batch, int tile,
                     void* stream) {
  return launch_chol<double, false>(device, static_cast<const double*>(a),
                                    static_cast<double*>(l), nullptr, batch, tile,
                                    static_cast<cudaStream_t>(stream));
}

int gp_chol_tile_inv_f32(int device, const void* a, void* l, void* linv, int batch,
                         int tile, void* stream) {
  return launch_chol<float, true>(device, static_cast<const float*>(a),
                                  static_cast<float*>(l), static_cast<float*>(linv),
                                  batch, tile, static_cast<cudaStream_t>(stream));
}

int gp_chol_tile_inv_f64(int device, const void* a, void* l, void* linv, int batch,
                         int tile, void* stream) {
  return launch_chol<double, true>(device, static_cast<const double*>(a),
                                   static_cast<double*>(l), static_cast<double*>(linv),
                                   batch, tile, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
