// fold_copy: the sublane<->lane relayouts of a row-major (rows, width) f32
// matrix,
//
//     fold   (R, C)     -> (R / s, s * C)   s consecutive rows side by side
//     unfold (R, s * C) -> (R * s, C)       the inverse
//
// Replaces the in-kernel reshapes that the TPU probe
// tools/reshape_probe.py::probe tests inside a Pallas kernel (the stacked-region
// kernels' boundary convs, dl_speech_enhancement_tpu/ops/mega_stacked.py). On
// the TPU a value is tiled (8 sublanes x 128 lanes), so moving rows into lanes
// moves data between tiles, and Mosaic lowers it only at some widths. Here a
// row-major matrix keeps every element at the same linear index through either
// reshape, so the function is one flat copy of rows * width floats.
//
// What bounds it: bytes, one read and one write of every element; no
// arithmetic, and at the probe's 40-106 KB the launch itself. Design: each
// thread of a 256-thread block loads one 16-byte vector and stores it (a
// warp's accesses coalesce), so a launch spreads over tens of blocks; the
// last block also copies the tail of fewer than four floats; operands that
// are not 16-byte aligned take a plain grid-stride copy. A copy by 1-D bulk
// asynchronous copies (global -> shared on an mbarrier, then shared ->
// global, one chunk a block) measured slower on the card at every probe
// shape, its two round trips in series (PERF.md, section 6), so the vector
// copy is the one kept.
#include <cstdint>

#include <cuda_runtime.h>

#include "error.cuh"

namespace dse {

constexpr int kVectorThreads = 256;

// Each thread copies one 16-byte vector (a warp's accesses coalesce); the last
// block also copies the tail of fewer than four floats.
__global__ void __launch_bounds__(kVectorThreads)
fold_copy_kernel(const float* __restrict__ x, float* __restrict__ y, long long n) {
  const long long n4 = n / 4;
  const long long v = (long long)blockIdx.x * kVectorThreads + threadIdx.x;
  if (v < n4) reinterpret_cast<float4*>(y)[v] = reinterpret_cast<const float4*>(x)[v];
  if (blockIdx.x == gridDim.x - 1)
    for (long long e = 4 * n4 + threadIdx.x; e < n; e += kVectorThreads) y[e] = x[e];
}

__global__ void __launch_bounds__(256)
fold_copy_unaligned_kernel(const float* __restrict__ x, float* __restrict__ y, long long n) {
  for (long long e = (long long)blockIdx.x * 256 + threadIdx.x; e < n;
       e += (long long)gridDim.x * 256)
    y[e] = x[e];
}

}  // namespace dse

extern "C" int dse_fold_copy(const float* x, float* y, int rows, int width, int s, int unfold,
                             void* stream) {
  if (rows <= 0 || width <= 0 || s <= 0 || (unfold ? width % s : rows % s) != 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n = (long long)rows * width;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) % 16 != 0) {
    const long long blocks = (n + 255) / 256;
    dse::fold_copy_unaligned_kernel<<<(unsigned)(blocks < 1024 ? blocks : 1024), 256, 0, st>>>(
        x, y, n);
    return cudaGetLastError();
  }
  const long long blocks = n / 4 > 0 ? (n / 4 + dse::kVectorThreads - 1) / dse::kVectorThreads : 1;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  dse::fold_copy_kernel<<<(unsigned)blocks, dse::kVectorThreads, 0, st>>>(x, y, n);
  return cudaGetLastError();
}
