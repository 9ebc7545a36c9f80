// B4, B5, float64 entry points, with SE's and periodic's kernels (the
// kernels: matvec.cuh; the other families' in matvec_ext_f64.cu).

#include "matvec.cuh"

extern "C" {

// Each entry point returns cudaGetLastError() after its launches (0 =
// success).  Pointers are device pointers.  `work` holds `splits` slabs of
// the output (splits * P * n * r values) and may be null when splits == 1.

// `family` is a gp::Family; for kTree, `tree` is the program's host encoding
// (closed_forms.cuh, parse_tree) and params the leaves' parameters in its
// order
int gp_kernel_matvec_f64(int device, const void* x, const void* v, const void* params,
                         void* out, void* work, int n, int r, int family, const int* tree,
                         int splits, void* stream) {
  gp::TreeProgram prog{};
  if (family == gp::kTree && !gp::parse_tree(tree, &prog)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_matvec<double>(
      static_cast<const double*>(x), static_cast<const double*>(v),
      static_cast<const double*>(params), static_cast<double*>(out), static_cast<double*>(work), n,
      r, family, prog, splits, static_cast<cudaStream_t>(stream));
}

int gp_kernel_jacvec_f64(int device, const void* x, const void* u, const void* params,
                         void* out, void* work, int n, int r, int family, int splits,
                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_jacvec<double>(
      static_cast<const double*>(x), static_cast<const double*>(u),
      static_cast<const double*>(params), static_cast<double*>(out), static_cast<double*>(work), n,
      r, family, splits, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
