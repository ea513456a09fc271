// Registers and residency of kernel A, read by chip_smoke.py. Included at
// the end of a translation unit that defines kernel A's template
// ``composite_fwd_kernel<bool RECT>`` (csrc/composite_fwd.cu, or a copy of an
// earlier design of kernel A built beside it for comparison), after
// composite_common.cuh.
#pragma once

#include <cuda_runtime.h>

// out[0..5]: registers per thread, static shared memory per block (bytes)
// and resident 256-thread blocks per SM of composite_fwd_kernel<false>
// (bucket 1), then the same of composite_fwd_kernel<true> (rects). Returns
// the first CUDA error, or 0.
extern "C" int composite_fwd_attrs(int* out) {
  const void* fns[2] = {(const void*)composite_fwd_kernel<false>,
                        (const void*)composite_fwd_kernel<true>};
  for (int k = 0; k < 2; ++k) {
    cudaFuncAttributes a;
    cudaError_t rc = cudaFuncGetAttributes(&a, fns[k]);
    if (rc != cudaSuccess) return (int)rc;
    out[3 * k] = a.numRegs;
    out[3 * k + 1] = (int)a.sharedSizeBytes;
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3 * k + 2],
                                                       fns[k], gslm::PIX, 0);
    if (rc != cudaSuccess) return (int)rc;
  }
  return 0;
}
