// B4 for Sum/Product trees, float64 (the kernels: matvec.cuh, the
// element: closed_forms.cuh's TreeValue), apart so that the build compiles
// it in parallel with the other instantiations.

#include "matvec.cuh"

namespace gp {

int launch_matvec_tree(const double* x, const double* v, const double* params, double* out,
                       double* work, int n, int r, const TreeProgram& prog, int splits,
                       cudaStream_t stream) {
  return launch_product<double, TreeValue<double>>(x, v, params, out, work, n, r, prog,
                                                   splits, stream);
}

}  // namespace gp
