// Helpers shared by the port's tensor-core kernels (tile_mma.cuh and the
// files that include it): the block size, weight widening, the reference's
// activations, and the dynamic shared memory opt-in.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "error.cuh"

namespace dse {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// ELU as the reference kernels write it: exp(min(x, 0)) - 1 below zero.
__device__ __forceinline__ float elu(float x) {
  return x > 0.f ? x : expf(fminf(x, 0.f)) - 1.f;
}

// LeakyReLU as the reference writes it: x where x >= 0, else slope * x.
__device__ __forceinline__ float leaky(float x, float slope) { return x >= 0.f ? x : slope * x; }

// Raises a kernel's dynamic shared memory limit once per instantiation;
// launches above 48 KB are refused without it.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes, size_t* configured) {
  if (bytes <= 48 * 1024 || bytes <= *configured) return cudaSuccess;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) *configured = bytes;
  return err;
}

}  // namespace dse
