// B2a, B2b for Matern 3/2, Matern 5/2 and RQ, float64 (the kernels:
// pairwise.cuh).

#include "pairwise.cuh"

namespace gp {

int launch_deriv_ext(const double* x1, const double* x2, const double* params, double* out,
                     int family, int order, int value, const DerivLaunch& g) {
  using T = double;
  switch (family) {
    case kMatern32:
      return launch_deriv_form<T, Matern32Form<T>>(x1, x2, params, out, order, value, g);
    case kMatern52:
      return launch_deriv_form<T, Matern52Form<T>>(x1, x2, params, out, order, value, g);
    case kRQ:
      return launch_deriv_form<T, RQForm<T>>(x1, x2, params, out, order, value, g);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace gp
