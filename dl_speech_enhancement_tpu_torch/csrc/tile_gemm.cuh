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

// Activations between launches are f32 or bf16 (the streams' boundary
// dtype): a kernel widens what it loads to f32, computes in f32 and rounds
// what it stores, to nearest even, as torch's .to(torch.bfloat16) does.
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Four consecutive activations as f32: one 16-byte (f32) or 8-byte (bf16)
// load, aligned to its size.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  return make_float4(__low2float(lo), __high2float(lo), __low2float(hi), __high2float(hi));
}

// Stores four consecutive activations, rounded to T, with one aligned store.
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  uint2 u;
  *reinterpret_cast<__nv_bfloat162*>(&u.x) = __floats2bfloat162_rn(v.x, v.y);
  *reinterpret_cast<__nv_bfloat162*>(&u.y) = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(p) = u;
}

// A GEMM operand as the reference multiplies it with weights of type WT:
// rounded to bf16, to nearest even, where the weights are bf16 (the JAX
// kernels' jnp.dot(a.astype(wd), w, preferred_element_type=f32)), as it is
// where they are f32.
template <typename WT>
__device__ __forceinline__ float mma_operand(float v) {
  if constexpr (sizeof(WT) == 2) return __bfloat162float(__float2bfloat16_rn(v));
  else return v;
}

// ELU as the reference kernels write it: exp(min(x, 0)) - 1 below zero.
__device__ __forceinline__ float elu(float x) {
  return x > 0.f ? x : expf(fminf(x, 0.f)) - 1.f;
}

// LeakyReLU as the reference writes it: x where x >= 0, else slope * x.
__device__ __forceinline__ float leaky(float x, float slope) { return x >= 0.f ? x : slope * x; }

// A function attribute is set for the calling thread's current device only,
// so a launcher keeps what it has set in an array of kMaxDevices entries, one
// for each device.
constexpr int kMaxDevices = 64;

inline cudaError_t current_device(int* dev) {
  cudaError_t err = cudaGetDevice(dev);
  if (err == cudaSuccess && (*dev < 0 || *dev >= kMaxDevices)) err = cudaErrorInvalidDevice;
  return err;
}

// Raises a kernel's dynamic shared memory limit once per instantiation and
// device; launches above 48 KB are refused without it.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes, size_t* configured) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = current_device(&dev);
  if (err != cudaSuccess || bytes <= configured[dev]) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) configured[dev] = bytes;
  return err;
}

// Allows a kernel clusters above 8 blocks, once per instantiation and device.
template <typename Kernel>
inline cudaError_t allow_wide_clusters(Kernel kernel, bool* wide) {
  int dev = 0;
  cudaError_t err = current_device(&dev);
  if (err != cudaSuccess || wide[dev]) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) wide[dev] = true;
  return err;
}

}  // namespace dse
