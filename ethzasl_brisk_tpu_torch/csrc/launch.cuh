// The launch rule the probe kernels share: opt in to dynamic shared memory
// above 48 KB, launch, and return the launch's error, so that an error leaves
// no trace in cudaGetLastError for the next launch.
#pragma once

#include <cuda_runtime.h>

// Launch with `smem` bytes of dynamic shared memory, opting in above 48 KB.
template <typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), int grid, int threads, int smem,
                   cudaStream_t stream, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return err;
    }
  }
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}
