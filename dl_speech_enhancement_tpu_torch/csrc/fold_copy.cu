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
// reshape, so the work is one copy.
//
// What bounds it: bytes, one read and one write of every element; no
// arithmetic. Design: one block per run of whole groups (a group is the s
// source rows of one folded row, or the one source row of s unfolded rows), at
// most 8,192 floats a block. The block stages its groups in shared memory by
// source coordinates and writes them by destination coordinates, so each
// element's destination row and column are computed, not assumed; both passes
// walk consecutive addresses with consecutive threads.
#include <cuda_runtime.h>

#include "error.cuh"

namespace dse {

constexpr int kCopyThreads = 256;
constexpr int kCopyFloats = 8192;  // shared memory a block stages: 32 KB

__global__ void __launch_bounds__(kCopyThreads)
fold_copy_kernel(const float* __restrict__ x, float* __restrict__ y, int rows_src,
                 int width_src, int s, int unfold, int groups_per_block) {
  extern __shared__ float tile[];
  // a group: fold, s source rows of width_src -> 1 row of s * width_src;
  // unfold, 1 source row of width_src -> s rows of width_src / s
  const int group = unfold ? width_src : s * width_src;
  const int n_groups = unfold ? rows_src : rows_src / s;
  const int g0 = blockIdx.x * groups_per_block;
  const int n = min(groups_per_block, n_groups - g0);
  const int floats = n * group;
  const int src_row0 = unfold ? g0 : g0 * s;
  for (int e = threadIdx.x; e < floats; e += kCopyThreads) {
    const int r = src_row0 + e / width_src, col = e % width_src;
    tile[e] = x[(size_t)r * width_src + col];
  }
  __syncthreads();
  const int width_dst = unfold ? width_src / s : s * width_src;
  const int dst_row0 = unfold ? g0 * s : g0;
  for (int e = threadIdx.x; e < floats; e += kCopyThreads) {
    const int rd = dst_row0 + e / width_dst, q = e % width_dst;
    // the source element of destination (rd, q), as a local staging index
    const int local = unfold ? (rd / s - g0) * width_src + (rd % s) * width_dst + q
                             : ((rd - g0) * s + q / width_src) * width_src + q % width_src;
    y[(size_t)rd * width_dst + q] = tile[local];
  }
}

}  // namespace dse

extern "C" int dse_fold_copy(const float* x, float* y, int rows, int width, int s, int unfold,
                             void* stream) {
  if (rows <= 0 || width <= 0 || s <= 0 || (unfold ? width % s : rows % s) != 0 ||
      (long long)rows * width > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const int group = unfold ? width : s * width;
  if (group > dse::kCopyFloats) return cudaErrorInvalidValue;
  const int per_block = dse::kCopyFloats / group;
  const int n_groups = unfold ? rows : rows / s;
  const int blocks = (n_groups + per_block - 1) / per_block;
  dse::fold_copy_kernel<<<blocks, dse::kCopyThreads, per_block * group * sizeof(float),
                          static_cast<cudaStream_t>(stream)>>>(x, y, rows, width, s, unfold,
                                                               per_block);
  return cudaGetLastError();
}
