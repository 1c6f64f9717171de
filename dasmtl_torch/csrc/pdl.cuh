// Programmatic dependent launch (Hopper): a kernel launched with
// launch_pdl() may start while the grid before it in the stream is still
// finishing.  It must call wait_prior_grid() before it touches global
// memory: that waits for the earlier grid to complete and its writes to be
// visible, so the results are those of a plain launch.  What it gains is
// the launch itself, which then overlaps the earlier grid's tail
// (PERF.md's kernel table times each kernel with and without it).
// allow_next_grid() lets the NEXT such launch start once this grid's loads
// are in flight; it too waits before touching memory.  A kernel launched
// without the attribute runs both instructions as no-ops.  Stream capture
// records the launch as a programmatic edge, so a CUDA graph keeps it.

#pragma once

#include <cuda_runtime.h>

namespace dasmtl_pdl {

__device__ __forceinline__ void wait_prior_grid() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

__device__ __forceinline__ void allow_next_grid() {
  asm volatile("griddepcontrol.launch_dependents;");
}

// kernel<<<grid, threads, smem, stream>>>(args...), with programmatic
// stream serialization when `pdl`; the launch's cudaError_t.
template <typename... Params, typename... Args>
cudaError_t launch_pdl_smem(void (*kernel)(Params...), dim3 grid,
                            int threads, int smem, cudaStream_t stream,
                            bool pdl, Args... args) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = pdl ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
}

// The same with no dynamic shared memory.
template <typename... Params, typename... Args>
cudaError_t launch_pdl(void (*kernel)(Params...), dim3 grid, int threads,
                       cudaStream_t stream, bool pdl, Args... args) {
  return launch_pdl_smem(kernel, grid, threads, 0, stream, pdl, args...);
}

}  // namespace dasmtl_pdl
