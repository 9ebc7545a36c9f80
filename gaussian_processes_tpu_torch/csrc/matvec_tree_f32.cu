// B4 for Sum/Product trees, float32 (the kernels: matvec.cuh, the
// element: closed_forms.cuh's TreeValue), apart so that the build compiles
// it in parallel with the other instantiations.

#include "matvec.cuh"

namespace gp {

int launch_matvec_tree(const float* x, const float* v, const float* params, float* out,
                       float* work, int n, int r, const TreeProgram& prog, int splits,
                       cudaStream_t stream) {
  return launch_product<float, TreeValue<float>>(x, v, params, out, work, n, r, prog,
                                                 splits, stream);
}

}  // namespace gp
