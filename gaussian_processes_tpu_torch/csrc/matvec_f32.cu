// B4, B5, float32 entry points, with SE's and periodic's kernels (the
// kernels: matvec.cuh; the other families' in matvec_ext_f32.cu).

#include "matvec.cuh"

extern "C" {

// Each entry point returns cudaGetLastError() after its launches (0 =
// success).  Pointers are device pointers.  `work` holds `splits` slabs of
// the output (splits * P * n * r values) and may be null when splits == 1.

// The column splits of a B4 (vals = 1) or B5 (vals = P) launch on a card of
// `sms` SMs; the same for either element type, so defined here only.
int gp_product_splits(int vals, int n, int r, int sms) {
  return splits_for(vals, n, r, sms);
}

// `family` is a gp::Family; for kTree, `tree` is the program's host encoding
// (closed_forms.cuh, parse_tree) and params the leaves' parameters in its
// order
int gp_kernel_matvec_f32(int device, const void* x, const void* v, const void* params,
                         void* out, void* work, int n, int r, int family, const int* tree,
                         int splits, void* stream) {
  gp::TreeProgram prog{};
  if (family == gp::kTree && !gp::parse_tree(tree, &prog)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_matvec<float>(
      static_cast<const float*>(x), static_cast<const float*>(v),
      static_cast<const float*>(params), static_cast<float*>(out), static_cast<float*>(work), n,
      r, family, prog, splits, static_cast<cudaStream_t>(stream));
}

int gp_kernel_jacvec_f32(int device, const void* x, const void* u, const void* params,
                         void* out, void* work, int n, int r, int family, int splits,
                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_jacvec<float>(
      static_cast<const float*>(x), static_cast<const float*>(u),
      static_cast<const float*>(params), static_cast<float*>(out), static_cast<float*>(work), n,
      r, family, splits, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
