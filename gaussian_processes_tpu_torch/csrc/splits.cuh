// The second pass of a column-split matrix-free product (B4, B4-ARD, B5):
// out[i] = sum_z work[z][i], added in split order in double, so a product
// gives the same bits on every call (no float atomics).
#pragma once

#include <algorithm>
#include <cstddef>

#include <cuda_runtime.h>

namespace gp {

template <typename T>
__global__ void sum_splits_kernel(const T* __restrict__ work, T* __restrict__ out,
                                  size_t count, int splits) {
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < count; i += stride) {
    double s = work[i];
    for (int z = 1; z < splits; ++z) s += work[static_cast<size_t>(z) * count + i];
    out[i] = static_cast<T>(s);
  }
}

template <typename T>
cudaError_t launch_sum_splits(const T* work, T* out, size_t count, int splits,
                              cudaStream_t stream) {
  const int threads = 256;
  const size_t blocks = std::min<size_t>((count + threads - 1) / threads, 4096);
  sum_splits_kernel<T><<<static_cast<int>(blocks), threads, 0, stream>>>(work, out, count,
                                                                         splits);
  return cudaGetLastError();
}

}  // namespace gp
