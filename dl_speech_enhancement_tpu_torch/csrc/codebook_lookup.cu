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
// and every row's L codes are read once per warp from L1.
//
// A code outside its layer's range [l*K, (l+1)*K) is not read: its term is
// zero, as the TPU kernel's one-hot product makes it, and the kernel stores
// the caller's number for this call (`call`, > 0) into `bad`, a word of host
// memory mapped into the card's address space (dse_mapped_word_alloc). The
// word is never cleared. The entry point only launches: no copy, no
// synchronisation; the host reads the word once the call has finished on the
// card (ops/mega_kernel.py::BadCodeWord).
#include <cuda_runtime.h>

#include "error.cuh"

namespace dse {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
codebook_lookup_kernel(const int* __restrict__ codes, const float* __restrict__ books_t,
                       float* __restrict__ out, long long* bad, long long call, int R, int L,
                       int K, int D) {
  const size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (e >= (size_t)R * D) return;
  const int r = (int)(e / D), d = (int)(e % D);
  float s = 0.f;
  for (int l = 0; l < L; ++l) {
    const int c = codes[(size_t)r * L + l] - l * K;
    if (c < 0 || c >= K) {
      *bad = call;
      continue;
    }
    s = __fadd_rn(s, books_t[((size_t)l * K + c) * D + d]);
  }
  out[e] = s;
}

}  // namespace dse

extern "C" int dse_codebook_lookup(const int* codes, const float* books_t, float* out,
                                   long long* bad, long long call, int R, int L, int K, int D,
                                   void* stream) {
  if (R <= 0 || L <= 0 || K <= 0 || D <= 0 || !bad || call <= 0) return cudaErrorInvalidValue;
  const size_t n = (size_t)R * D;
  const unsigned blocks = (unsigned)((n + dse::kThreads - 1) / dse::kThreads);
  dse::codebook_lookup_kernel<<<blocks, dse::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      codes, books_t, out, bad, call, R, L, K, D);
  return cudaGetLastError();
}

// A zeroed 8-byte word of pinned host memory mapped into every card's address
// space: `host` for the host's reads, `dev` for the kernel's store.
extern "C" int dse_mapped_word_alloc(long long** host, long long** dev) {
  cudaError_t err = cudaHostAlloc(reinterpret_cast<void**>(host), sizeof(long long),
                                  cudaHostAllocMapped | cudaHostAllocPortable);
  if (err != cudaSuccess) return err;
  **host = 0;
  err = cudaHostGetDevicePointer(reinterpret_cast<void**>(dev), *host, 0);
  if (err != cudaSuccess) cudaFreeHost(*host);
  return err;
}

extern "C" int dse_mapped_word_free(long long* host) { return cudaFreeHost(host); }
