// Warp-level pieces of the tensor-core flash-attention kernels on Hopper
// (sm_90a; the warpgroup pieces are in hopper.cuh): shared-memory
// addresses, bf16 packing, reductions over a quad of lanes, and the launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rtt {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Two f32 rounded to bf16 (to nearest even, as XLA's convert), lo in the
// low half: the element of the lower column index, as A fragments want.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Max / sum over the 4 lanes of a quad: the lanes holding one C row.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Launch with a block of `threads`, after raising the dynamic shared-memory
// cap; returns the launch's own error.
template <typename Kernel, typename... Args>
inline cudaError_t launch_block(Kernel kernel, dim3 grid, int threads, size_t smem, void* stream,
                               Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return cudaGetLastError();
}

}  // namespace rtt
