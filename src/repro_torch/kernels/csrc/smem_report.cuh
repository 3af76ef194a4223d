// Shared memory of one compiled kernel, for the tests that hold a
// wrapper's plan against the built library: the dynamic bytes its
// launcher asks for, the static bytes the compiled kernel declares and
// the device's opt-in limit per block. Returns a cudaError_t.
#pragma once

#include <cuda_runtime.h>

template <typename Kernel>
int smem_report(Kernel kernel, int dynamic_bytes, int* dynamic,
                int* static_bytes, int* limit) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  *dynamic = dynamic_bytes;
  *static_bytes = static_cast<int>(attr.sharedSizeBytes);
  return static_cast<int>(cudaDeviceGetAttribute(
      limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev));
}
