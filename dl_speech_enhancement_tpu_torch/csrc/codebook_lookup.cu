// codebook_lookup: the receiver's codebook lookup of the symAD codec,
//
//     zq[r, :] = sum_{l < L} books_t[l, codes[r, l] - l*K, :]
//
// from the flattened int32 wire codes (R, L) and the books in codeword-major
// layout (L, K, D) f32, summed over l in ascending order. Replaces the lookup
// at the head of the TPU kernel dl_speech_enhancement_tpu/ops/
// mega_kernel.py::make_mega_stream.dec_kernel (:552-560), which computes it
// as L one-hot matrix products.
//
// What bounds it: bytes. It reads L codewords of D floats per row (the
// selected ones, not the whole 2 MB of books) and writes D floats, with one
// addition per codeword element. Design: one thread per output element, so
// the D threads of a row read each codeword's D contiguous floats together
// and every row's L codes are read once per warp from L1. A code outside its
// layer's range [l*K, (l+1)*K) is not read: it sets a flag in device memory,
// which the entry point reads back once the launch has finished, returning
// kDseBadCode if it is set.
#include <cuda_runtime.h>

#include "error.cuh"

constexpr int kDseBadCode = -1;

namespace dse {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
codebook_lookup_kernel(const int* __restrict__ codes, const float* __restrict__ books_t,
                       float* __restrict__ out, int* __restrict__ bad, int R, int L, int K,
                       int D) {
  const size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (e >= (size_t)R * D) return;
  const int r = (int)(e / D), d = (int)(e % D);
  float s = 0.f;
  for (int l = 0; l < L; ++l) {
    const int c = codes[(size_t)r * L + l] - l * K;
    if (c < 0 || c >= K) {
      *bad = 1;
      continue;
    }
    s = __fadd_rn(s, books_t[((size_t)l * K + c) * D + d]);
  }
  out[e] = s;
}

}  // namespace dse

extern "C" int dse_codebook_lookup(const int* codes, const float* books_t, float* out, int* bad,
                                   int R, int L, int K, int D, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R <= 0 || L <= 0 || K <= 0 || D <= 0 || !bad) return cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(bad, 0, sizeof(int), s);
  if (err != cudaSuccess) return err;
  const size_t n = (size_t)R * D;
  const unsigned blocks = (unsigned)((n + dse::kThreads - 1) / dse::kThreads);
  dse::codebook_lookup_kernel<<<blocks, dse::kThreads, 0, s>>>(codes, books_t, out, bad, R, L,
                                                               K, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  int flag = 0;
  err = cudaMemcpyAsync(&flag, bad, sizeof(int), cudaMemcpyDeviceToHost, s);
  if (err == cudaSuccess) err = cudaStreamSynchronize(s);
  if (err != cudaSuccess) return err;
  return flag ? kDseBadCode : 0;
}
