// The resource query every kernel library exports (cutrace_*_attributes,
// read by ops/_build.py kernel_attributes).
#pragma once

#include <cuda_runtime.h>

namespace cutrace {

// A kernel's resources as compiled, into out[4]: registers a thread, local
// memory bytes a thread (spills and arrays indexed at run time), static
// shared bytes, the most threads a block may have. Returns the CUDA error
// code.
template <typename Kernel>
inline int kernel_attributes(Kernel* kernel, int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = a.maxThreadsPerBlock;
  return 0;
}

}  // namespace cutrace
