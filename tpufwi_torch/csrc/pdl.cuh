// Programmatic dependent launch (Hopper), shared by the kernel families
// that chain their time steps this way (acoustic2d_kernels.cuh,
// elastic2d_kernels.cuh), and the 4-byte cp.async their fused passes copy
// with. A kernel launched with launch_dep may start
// while the kernel before it on the stream drains; it waits for that
// kernel's completion and memory in dep_wait before it touches memory, and
// lets the next kernel launch in dep_trigger. Launched the ordinary way,
// both are no-ops.

#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void dep_wait() { asm volatile("griddepcontrol.wait;" ::: "memory"); }
__device__ __forceinline__ void dep_trigger() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// launch kernel on st, with dep as a programmatic dependent of the kernel
// before it (its launch overlaps that kernel's drain; dep_wait orders the
// memory), else in plain stream order
template <typename... P, typename... A>
inline void launch_dep(int dep, void (*kernel)(P...), dim3 grid, dim3 block, size_t smem,
                       cudaStream_t st, A... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = dep;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaLaunchKernelEx(&cfg, kernel, args...);
}

// 4-byte global -> shared copy, zero-filled (nothing read) unless ok
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

// this thread's copies complete and visible to it
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

}  // namespace
