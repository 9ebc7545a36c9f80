// B4-ARD, float64 entry point (the kernel: ard_matvec.cuh).

#include "ard_matvec.cuh"

extern "C" {

// Returns cudaGetLastError() after its launches (0 = success).  `xs` holds
// the pre-scaled (n, dim) coordinates, `params` the amplitude h (one value on
// the device); `work` holds `splits` slabs of the output (splits * n * r
// values) and may be null when splits == 1.

int gp_ard_matvec_f64(int device, const void* xs, const void* v, const void* params,
                      void* out, void* work, int n, int dim, int r, int splits,
                      void* stream) {
  return launch_ard_matvec<double>(device, static_cast<const double*>(xs),
                                   static_cast<const double*>(v),
                                   static_cast<const double*>(params),
                                   static_cast<double*>(out), static_cast<double*>(work), n,
                                   dim, r, splits, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
