// Block-level tap GEMM shared by the port's three kernels.
//
// Every product of the streaming generator is a causal convolution written as
// a sum of tap matrix products,
//
//     out[m][n] = sum_{j < taps} sum_{c < K} A(m, j, c) * W_j[c][n],
//
// where A(m, j, c) is an input sample picked by the caller (a dilated row of
// a cache-prepended activation, a strided row, a transposed-conv phase row).
// One 256-thread block computes output tiles of BM x BN. For every (tap,
// 32-channel slice) it stages an A tile (through the caller's load functor)
// and a W tile (weights read from global memory, f32 or bf16, widened to f32)
// into shared memory; each thread then accumulates a 4x4 register tile with
// f32 FMAs. Every weight element is read from global memory once per BM rows
// of output, so the weight bytes (the whole model is 30 MB in f32, which the
// 50 MB L2 holds) are amortised over the rows a launch carries.
//
// The products run on the CUDA cores in f32 (the card's 67 TFLOP/s f32 rate),
// not on the tensor cores: activations and sums stay f32 as in the reference.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "error.cuh"

namespace dse {

constexpr int kThreads = 256;
constexpr int kBK = 32;  // input channels staged per step
constexpr int kTM = 4;   // rows per thread
constexpr int kTN = 4;   // columns per thread

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// ELU as the reference kernels write it: exp(min(x, 0)) - 1 below zero.
__device__ __forceinline__ float elu(float x) {
  return x > 0.f ? x : expf(fminf(x, 0.f)) - 1.f;
}

// LeakyReLU as the reference writes it: x where x >= 0, else slope * x.
__device__ __forceinline__ float leaky(float x, float slope) { return x >= 0.f ? x : slope * x; }

template <int BN>
struct Tile {
  static constexpr int kColThreads = BN / kTN;
  static constexpr int BM = kThreads / kColThreads * kTM;  // 128 for BN 32, 64 for BN 64
  static constexpr int LDA = BM + 4;  // padded so staged rows spread over banks
  static constexpr int kSmemFloats = kBK * LDA + kBK * BN;
};

// Host-side twin of Tile<BN> for the entry points.
inline int tile_bn(int n_cols) { return n_cols <= 32 ? 32 : 64; }
inline int tile_bm(int bn) { return bn == 32 ? Tile<32>::BM : Tile<64>::BM; }
inline size_t tile_smem_bytes(int bn) {
  return sizeof(float) * (bn == 32 ? Tile<32>::kSmemFloats : Tile<64>::kSmemFloats);
}

// Computes out rows [m0, m0 + M) and columns [n0, n0 + N) and hands each
// result to epi(m, n, value). load_a(m, j, c0, kk) returns A for row m, tap
// j, channel c0 + kk (< K), where c0 is a multiple of kBK shared by the whole
// step. w_tap(j) points at tap j's (K, ldw) row-major weights. smem holds
// Tile<BN>::kSmemFloats floats. All threads of the block must call it with
// the same scalars; it ends with a barrier, so shared memory written by epi
// is visible to the whole block on return.
//
// The (tap, channel slice) steps are software-pipelined: the next step's A
// and W elements are loaded into registers, raw, before the current step's
// tiles are multiplied, and widened / stored only after, so the loads' latency
// (L2 for weights, shared or distributed shared memory for A) overlaps the
// FMAs.
template <int BN, typename WT, typename LoadA, typename WTap, typename Epi>
__device__ __forceinline__ void tile_gemm(int m0, int M, int n0, int N, int taps, int K,
                                          int ldw, float* smem, LoadA load_a, WTap w_tap,
                                          Epi epi) {
  using T = Tile<BN>;
  constexpr int kAPer = kBK * T::BM / kThreads;  // A elements staged per thread
  constexpr int kWPer = kBK * BN / kThreads;     // W elements staged per thread
  float* As = smem;                 // [kBK][LDA], column-major A tile
  float* Ws = smem + kBK * T::LDA;  // [kBK][BN]
  const int tid = threadIdx.x;
  const int tn = tid % T::kColThreads;
  const int tm = tid / T::kColThreads;
  const int m_end = m0 + M, n_end = n0 + N;
  const int k_slices = (K + kBK - 1) / kBK;
  const int steps = taps * k_slices;
  const WT zero_w = WT(0.f);
  for (int mb = m0; mb < m_end; mb += T::BM) {
    for (int nb = n0; nb < n_end; nb += BN) {
      float ra[kAPer];
      WT rw[kWPer];
      auto fetch = [&](int step) {
        const int j = step / k_slices, c0 = (step - j * k_slices) * kBK;
        const WT* w = w_tap(j);
#pragma unroll
        for (int i = 0; i < kAPer; ++i) {
          const int e = tid + i * kThreads;
          const int gm = mb + e / kBK, kk = e % kBK;
          ra[i] = (gm < m_end && c0 + kk < K) ? load_a(gm, j, c0, kk) : 0.f;
        }
#pragma unroll
        for (int i = 0; i < kWPer; ++i) {
          const int e = tid + i * kThreads;
          const int gn = nb + e % BN, gc = c0 + e / BN;
          rw[i] = (gn < n_end && gc < K) ? w[(size_t)gc * ldw + gn] : zero_w;
        }
      };
      float acc[kTM][kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int q = 0; q < kTN; ++q) acc[i][q] = 0.f;
      fetch(0);
      for (int step = 0; step < steps; ++step) {
        __syncthreads();
#pragma unroll
        for (int i = 0; i < kAPer; ++i) {
          const int e = tid + i * kThreads;
          As[(e % kBK) * T::LDA + e / kBK] = ra[i];
        }
#pragma unroll
        for (int i = 0; i < kWPer; ++i) {
          const int e = tid + i * kThreads;
          Ws[(e / BN) * BN + e % BN] = to_f(rw[i]);
        }
        __syncthreads();
        if (step + 1 < steps) fetch(step + 1);
#pragma unroll
        for (int kk = 0; kk < kBK; ++kk) {
          const float4 a = *reinterpret_cast<const float4*>(As + kk * T::LDA + tm * kTM);
          const float4 b = *reinterpret_cast<const float4*>(Ws + kk * BN + tn * kTN);
          const float av[kTM] = {a.x, a.y, a.z, a.w};
          const float bv[kTN] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int i = 0; i < kTM; ++i)
#pragma unroll
            for (int q = 0; q < kTN; ++q) acc[i][q] = fmaf(av[i], bv[q], acc[i][q]);
        }
      }
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const int gm = mb + tm * kTM + i;
#pragma unroll
        for (int q = 0; q < kTN; ++q) {
          const int gn = nb + tn * kTN + q;
          if (gm < m_end && gn < n_end) epi(gm, gn, acc[i][q]);
        }
      }
    }
  }
  __syncthreads();
}

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
