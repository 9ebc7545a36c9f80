// B4, B5 for Matern 3/2, Matern 5/2 and RQ, float32
// (the kernels: matvec.cuh; B4's Sum/Product trees: matvec_tree_f32.cu).

#include "matvec.cuh"

namespace gp {

int launch_matvec_ext(const float* x, const float* v, const float* params, float* out,
                      float* work, int n, int r, int family, const TreeProgram& prog,
                      int splits, cudaStream_t stream) {
  using T = float;
  switch (family) {
    case kMatern32:
      return launch_product<T, LeafValue<T, Matern32Fold<T>>>(x, v, params, out, work, n, r,
                                                            prog, splits, stream);
    case kMatern52:
      return launch_product<T, LeafValue<T, Matern52Fold<T>>>(x, v, params, out, work, n, r,
                                                            prog, splits, stream);
    case kRQ:
      return launch_product<T, LeafValue<T, RQFold<T>>>(x, v, params, out, work, n, r, prog,
                                                      splits, stream);
    case kTree:
      return launch_matvec_tree(x, v, params, out, work, n, r, prog, splits, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int launch_jacvec_ext(const float* x, const float* u, const float* params, float* out,
                      float* work, int n, int r, int family, int splits, cudaStream_t stream) {
  using T = float;
  const TreeProgram none{};
  switch (family) {
    case kMatern32:
      return launch_product<T, Matern32Jac<T>>(x, u, params, out, work, n, r, none, splits,
                                               stream);
    case kMatern52:
      return launch_product<T, Matern52Jac<T>>(x, u, params, out, work, n, r, none, splits,
                                               stream);
    case kRQ:
      return launch_product<T, RQJac<T>>(x, u, params, out, work, n, r, none, splits, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace gp
