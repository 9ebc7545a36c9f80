// B1, B2a, B2b: the entry points, B1 for every family and B2a / B2b for SE
// and periodic, B2a also contracted over a chain table (the kernels and
// their design: pairwise.cuh).

#include "pairwise.cuh"

namespace {

template <typename T, typename Eval>
void launch_k_eval(const T* x1, const T* x2, const T* params, T* out, int n, int m,
                   int chains, int stride, int with_diag, const gp::TreeProgram& prog,
                   cudaStream_t stream) {
  constexpr int C = vec_elems<T>();
  const dim3 grid((m + 32 * C - 1) / (32 * C),
                  std::min((n + kDerivRows - 1) / kDerivRows, kMaxGridY), chains);
  pairwise_k_kernel<T, Eval><<<grid, kDerivThreads, 0, stream>>>(x1, x2, params, out, n, m,
                                                                 with_diag, stride, prog);
}

// `tree`: the host encoding of a family kTree program (closed_forms.cuh,
// parse_tree), else unused
template <typename T>
int launch_k(int device, const void* x1, const void* x2, const void* params, void* out,
             int n, int m, int chains, int stride, int family, const int* tree,
             int with_diag, void* stream) {
  if (n <= 0 || m <= 0 || chains <= 0 || chains > kMaxGridY || stride < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  gp::TreeProgram prog{};
  if (family == gp::kTree && !gp::parse_tree(tree, &prog)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* a = static_cast<const T*>(x1);
  const T* b = static_cast<const T*>(x2);
  const T* th = static_cast<const T*>(params);
  T* o = static_cast<T*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (family) {
    case gp::kSE:
      launch_k_eval<T, gp::LeafValue<T, gp::SEFold<T>>>(a, b, th, o, n, m, chains, stride,
                                                        with_diag, prog, st);
      break;
    case gp::kPeriodic:
      launch_k_eval<T, gp::LeafValue<T, gp::PeriodicFold<T>>>(a, b, th, o, n, m, chains,
                                                              stride, with_diag, prog, st);
      break;
    case gp::kMatern32:
      launch_k_eval<T, gp::LeafValue<T, gp::Matern32Fold<T>>>(a, b, th, o, n, m, chains,
                                                              stride, with_diag, prog, st);
      break;
    case gp::kMatern52:
      launch_k_eval<T, gp::LeafValue<T, gp::Matern52Fold<T>>>(a, b, th, o, n, m, chains,
                                                              stride, with_diag, prog, st);
      break;
    case gp::kRQ:
      launch_k_eval<T, gp::LeafValue<T, gp::RQFold<T>>>(a, b, th, o, n, m, chains, stride,
                                                        with_diag, prog, st);
      break;
    case gp::kTree:
      launch_k_eval<T, gp::TreeValue<T>>(a, b, th, o, n, m, chains, stride, with_diag, prog, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// order 0 (B2a contracted) takes x1 = x2 and the contraction's operands
template <typename T>
int launch_deriv(int device, const void* x1, const void* x2, const void* params, void* out,
                 int n, int m, int chains, int stride, int family, int order, int value,
                 void* stream, const void* alpha = nullptr, const void* inv_K = nullptr,
                 void* partial = nullptr) {
  if (n <= 0 || m <= 0 || chains <= 0 || chains > kMaxGridY || stride < 0 || order < 0 ||
      order > 2 || (order != 2 && value >= 0) ||
      (order == 0 && (x1 != x2 || n != m || !alpha || !inv_K || !partial))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* a = static_cast<const T*>(x1);
  const T* b = static_cast<const T*>(x2);
  const T* th = static_cast<const T*>(params);
  T* o = static_cast<T*>(out);
  const gp::DerivLaunch g{n, m, chains, stride, static_cast<cudaStream_t>(stream),
                          alpha, inv_K, partial};
  switch (family) {
    case gp::kSE:
      return launch_deriv_form<T, gp::SEForm<T>>(a, b, th, o, order, value, g);
    case gp::kPeriodic:
      return launch_deriv_form<T, gp::PeriodicForm<T>>(a, b, th, o, order, value, g);
    default:  // Matern 3/2, Matern 5/2, RQ; anything else is refused there
      return gp::launch_deriv_ext(a, b, th, o, family, order, value, g);
  }
}

}  // namespace

extern "C" {

// Each entry point returns cudaGetLastError() after its launch (0 = success).
// Pointers are device pointers.

// `family` is a gp::Family; for kTree, `tree` is the program's host encoding
// (parse_tree) and params the leaves' parameters in its order
int gp_pairwise_k_f32(int device, const void* x1, const void* x2,
                      const void* params, void* out, int n, int m, int family,
                      const int* tree, int with_diag, void* stream) {
  return launch_k<float>(device, x1, x2, params, out, n, m, 1, 0, family, tree, with_diag,
                         stream);
}

int gp_pairwise_k_f64(int device, const void* x1, const void* x2,
                      const void* params, void* out, int n, int m, int family,
                      const int* tree, int with_diag, void* stream) {
  return launch_k<double>(device, x1, x2, params, out, n, m, 1, 0, family, tree, with_diag,
                          stream);
}

// B1 over a (chains, stride) parameter table, one launch: row c holds chain
// c's P kernel parameters (a tree's leaves' parameters, concatenated) and,
// with `with_diag`, its diagonal term s_c^2 + jitter at column P; out is
// (chains, n, m)
int gp_pairwise_k_chains_f32(int device, const void* x1, const void* x2, const void* table,
                             void* out, int n, int m, int chains, int stride, int family,
                             const int* tree, int with_diag, void* stream) {
  return launch_k<float>(device, x1, x2, table, out, n, m, chains, stride, family, tree,
                         with_diag, stream);
}

int gp_pairwise_k_chains_f64(int device, const void* x1, const void* x2, const void* table,
                             void* out, int n, int m, int chains, int stride, int family,
                             const int* tree, int with_diag, void* stream) {
  return launch_k<double>(device, x1, x2, table, out, n, m, chains, stride, family, tree,
                          with_diag, stream);
}

// B2 takes leaf families only.  Order 1: dK/dtheta, (P, n, m); order 2:
// `value` < 0 gives every plane of d2K/dtheta2, (P, P, n, m), else the
// (n, m) plane of that upper-triangle value (row-major over p <= q)
int gp_pairwise_deriv_f32(int device, const void* x1, const void* x2, const void* params,
                          void* out, int n, int m, int family, int order, int value,
                          void* stream) {
  return launch_deriv<float>(device, x1, x2, params, out, n, m, 1, 0, family, order, value,
                             stream);
}

int gp_pairwise_deriv_f64(int device, const void* x1, const void* x2, const void* params,
                          void* out, int n, int m, int family, int order, int value,
                          void* stream) {
  return launch_deriv<double>(device, x1, x2, params, out, n, m, 1, 0, family, order, value,
                              stream);
}

// B2a over the same table, one launch: chain c's dK/dtheta from the first P
// columns of row c; out is (chains, P, n, m)
int gp_pairwise_jac_chains_f32(int device, const void* x1, const void* x2, const void* table,
                               void* out, int n, int m, int chains, int stride, int family,
                               void* stream) {
  return launch_deriv<float>(device, x1, x2, table, out, n, m, chains, stride, family, 1, -1,
                             stream);
}

int gp_pairwise_jac_chains_f64(int device, const void* x1, const void* x2, const void* table,
                               void* out, int n, int m, int chains, int stride, int family,
                               void* stream) {
  return launch_deriv<double>(device, x1, x2, table, out, n, m, chains, stride, family, 1, -1,
                              stream);
}

// B2a contracted over the same table: out (chains, P) is, for each chain
// c, 1/2 sum_ij dK_p(x_i - x_j; table[c, :P]) (alpha_ci alpha_cj -
// inv_K_cij), dK/dtheta never stored; alpha is (chains, n), inv_K (chains,
// n, n), symmetric (its upper triangle is read), partial a scratch of
// (chains, P, gp_pairwise_jac_contract_blocks(n)) values
int gp_pairwise_jac_contract_chains_f32(int device, const void* x, const void* table,
                                        const void* alpha, const void* inv_K, void* partial,
                                        void* out, int n, int chains, int stride, int family,
                                        void* stream) {
  return launch_deriv<float>(device, x, x, table, out, n, n, chains, stride, family, 0, -1,
                             stream, alpha, inv_K, partial);
}

int gp_pairwise_jac_contract_chains_f64(int device, const void* x, const void* table,
                                        const void* alpha, const void* inv_K, void* partial,
                                        void* out, int n, int chains, int stride, int family,
                                        void* stream) {
  return launch_deriv<double>(device, x, x, table, out, n, n, chains, stride, family, 0, -1,
                              stream, alpha, inv_K, partial);
}

// the blocks of B2a's grid over an (n, n) plane: the partials a chain and
// plane of the contracted case
int gp_pairwise_jac_contract_blocks_f32(int n) {
  const dim3 grid = deriv_grid<float>(n, n, 1);
  return static_cast<int>(grid.x * grid.y);
}

int gp_pairwise_jac_contract_blocks_f64(int n) {
  const dim3 grid = deriv_grid<double>(n, n, 1);
  return static_cast<int>(grid.x * grid.y);
}

}  // extern "C"
