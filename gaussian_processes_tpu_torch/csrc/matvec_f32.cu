// B4, B5, float32 entry points (the kernels: matvec.cuh).

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

int gp_kernel_matvec_f32(int device, const void* x, const void* v, const void* params,
                         void* out, void* work, int n, int r, int family, int splits,
                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_matvec<float>(
      static_cast<const float*>(x), static_cast<const float*>(v),
      static_cast<const float*>(params), static_cast<float*>(out), static_cast<float*>(work), n,
      r, family, splits, static_cast<cudaStream_t>(stream));
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
