// rvq_assign: the residual-VQ nearest-codeword search of the symAD codec,
// emitting the flattened int32 wire codes,
//
//     r = z[row]
//     for l < L:  dist[k] = |r|^2 - 2 r.E_l[:, k] + |E_l[:, k]|^2
//                 ind     = argmin_k dist (lowest index on ties)
//                 r      -= E_l[:, ind]
//                 codes[row, l] = ind + l*K
//
// with books E (L, D, K) f32 in the JAX package's VQState layout and their
// squared norms (L, K) f32. Replaces the residual-VQ part of the TPU kernel
// dl_speech_enhancement_tpu/ops/mega_kernel.py::make_mega_stream.enc_kernel
// (:418-432), which loops over the L books inside its body with the books
// resident in VMEM.
//
// What bounds it: 2*D*K operations per row and book (1.05 MFLOP per code row
// at D=64, K=1024, L=8) against the 2 MB of books read per launch, so it is
// bound by operations from some 40 rows up and by the books' bytes below.
// Design: the L stages are serial within a row, so one block carries a few
// rows through all of them (one launch, not L). The rows' residuals sit in
// shared memory; each of the 256 threads holds kPerThread codewords at a
// stride of 256, so a warp's reads of a book row E_l[d, :] coalesce, and every
// codeword read from L1/L2 serves all the block's rows. The argmin is a
// warp-shuffle reduction on (dist, index) pairs and then one across the
// warps. The distance is composed as (|r|^2 - 2 r.E) + |E|^2 with rounded,
// uncontracted operations, as the plain version writes it; only the order
// of the r.E sum differs from it.
#include <cuda_runtime.h>

#include <math.h>

#include "error.cuh"

namespace dse {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 4;  // codewords per thread per pass over K
constexpr int kMaxDim = 1024;  // residual rows live in shared memory

// (d, i) beats (bd, bi): smaller distance, or the same one at a lower index
__device__ __forceinline__ bool better(float d, int i, float bd, int bi) {
  return d < bd || (d == bd && i < bi);
}

template <int ROWS>
__global__ void __launch_bounds__(kThreads)
rvq_assign_kernel(const float* __restrict__ z, const float* __restrict__ books,
                  const float* __restrict__ sqnorm, int* __restrict__ codes, int R, int D,
                  int K, int L) {
  extern __shared__ float res[];  // [ROWS][D] residuals
  __shared__ float red_d[ROWS][kWarps];
  __shared__ int red_i[ROWS][kWarps];
  __shared__ float rsq[ROWS];
  __shared__ int pick[ROWS];
  const int r0 = blockIdx.x * ROWS;
  const int rows = min(ROWS, R - r0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int e = tid; e < ROWS * D; e += kThreads)
    res[e] = e / D < rows ? z[(size_t)r0 * D + e] : 0.f;
  __syncthreads();

  for (int l = 0; l < L; ++l) {
    const float* E = books + (size_t)l * D * K;
    const float* N = sqnorm + (size_t)l * K;
    if (tid < ROWS) {
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = __fadd_rn(s, __fmul_rn(res[tid * D + d], res[tid * D + d]));
      rsq[tid] = s;
    }
    __syncthreads();
    float best_d[ROWS];
    int best_i[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      best_d[r] = INFINITY;
      best_i[r] = K;
    }
    for (int k0 = 0; k0 < K; k0 += kThreads * kPerThread) {
      float acc[ROWS][kPerThread];
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int j = 0; j < kPerThread; ++j) acc[r][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float e[kPerThread];
#pragma unroll
        for (int j = 0; j < kPerThread; ++j) {
          const int k = k0 + j * kThreads + tid;
          e[j] = k < K ? E[(size_t)d * K + k] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float rv = res[r * D + d];
#pragma unroll
          for (int j = 0; j < kPerThread; ++j) acc[r][j] = fmaf(rv, e[j], acc[r][j]);
        }
      }
      // this thread's codewords in ascending order, so a strict < keeps the
      // lowest index among equal distances
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        const int k = k0 + j * kThreads + tid;
        if (k < K) {
          const float n = N[k];
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            const float dist = __fadd_rn(__fsub_rn(rsq[r], __fmul_rn(2.f, acc[r][j])), n);
            if (dist < best_d[r]) {
              best_d[r] = dist;
              best_i[r] = k;
            }
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      float d = best_d[r];
      int i = best_i[r];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float od = __shfl_down_sync(0xffffffffu, d, off);
        const int oi = __shfl_down_sync(0xffffffffu, i, off);
        if (better(od, oi, d, i)) {
          d = od;
          i = oi;
        }
      }
      if (lane == 0) {
        red_d[r][warp] = d;
        red_i[r][warp] = i;
      }
    }
    __syncthreads();
    if (tid < ROWS) {
      float d = red_d[tid][0];
      int i = red_i[tid][0];
      for (int w = 1; w < kWarps; ++w)
        if (better(red_d[tid][w], red_i[tid][w], d, i)) {
          d = red_d[tid][w];
          i = red_i[tid][w];
        }
      if (i >= K) i = 0;  // no finite distance: argmin's answer for all-NaN rows
      pick[tid] = i;
      if (tid < rows) codes[(size_t)(r0 + tid) * L + l] = i + l * K;
    }
    __syncthreads();
    for (int e = tid; e < ROWS * D; e += kThreads)
      res[e] = __fsub_rn(res[e], E[(size_t)(e % D) * K + pick[e / D]]);
    __syncthreads();
  }
}

template <int ROWS>
cudaError_t launch(const float* z, const float* books, const float* sqnorm, int* codes, int R,
                   int D, int K, int L, cudaStream_t stream) {
  const int blocks = (R + ROWS - 1) / ROWS;
  rvq_assign_kernel<ROWS><<<blocks, kThreads, sizeof(float) * ROWS * D, stream>>>(
      z, books, sqnorm, codes, R, D, K, L);
  return cudaGetLastError();
}

// Rows per block: few where there are few rows, so that more of the 132 SMs
// share the books' reads; more where there are many, so that each codeword
// read serves more rows.
inline int rows_per_block(int R) { return R <= 2 * 132 ? 2 : R <= 4 * 132 ? 4 : 8; }

}  // namespace dse

extern "C" int dse_rvq_assign(const float* z, const float* books, const float* sqnorm,
                              int* codes, int R, int D, int K, int L, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R <= 0 || D <= 0 || D > dse::kMaxDim || K <= 0 || L <= 0) return cudaErrorInvalidValue;
  switch (dse::rows_per_block(R)) {
    case 2: return dse::launch<2>(z, books, sqnorm, codes, R, D, K, L, s);
    case 4: return dse::launch<4>(z, books, sqnorm, codes, R, D, K, L, s);
    default: return dse::launch<8>(z, books, sqnorm, codes, R, D, K, L, s);
  }
}
