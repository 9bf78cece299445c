// causal_conv_transpose: the causal transposed conv (k = 2s upsampler) with a
// one-row cache, in phase form,
//
//     y[s*r + p] = b + x_ext[r] @ Wc[cpad - p] + x_ext[r + 1] @ Wc[cpad + s - p],
//     x_ext = [cache (1 row); x],  cpad = k - 1 - s = s - 1,
//
// where Wc is the conv-ready, tap-flipped (k, Cin, Cout) weight
// (dl_speech_enhancement_tpu/nn/conv.py::ConvTranspose1d). Replaces the four
// upsamples that the TPU kernel dl_speech_enhancement_tpu/ops/
// mega_kernel.py::make_mega_stream.dec_kernel evaluates as per-phase matmuls
// re-interleaved with a replication matmul and an iota mask.
//
// B independent streams run in one launch: cache (B, 1, Cin) with stream stride
// `cache_bs` floats, x (B, T, Cin), out (B, T*s, Cout). The GEMM's M dimension
// is B * T; row r is (stream r / T, time r % T), and x_ext[t + 1] of a
// stream's last row is that stream's own x, never the next stream's cache.
// The division r / T is compiled out for one stream (kStreams = false).
//
// Optional fused activation: with `act` = 1 the A loader applies
// LeakyReLU(`slope`) to every element of [cache; x] it loads (the HiFiGAN
// vocoder's LeakyReLU(0.1) before each upsample, ops/vocoder_kernel.py::
// make_mega_vocoder's add_upsample), so a stage's cache stays the tail of its
// raw input. With act = 0 (the generator's upsamples) the arithmetic is the
// plain transposed conv's.
//
// What bounds it: the operations (2*Cin*Cout multiply-adds per output row).
// Design: the grid's z axis is the phase p, so each block's two taps are
// fixed and its GEMM (tile_gemm.cuh) has a shared weight tile; each output
// row s*r + p is written in place, with no interleave pass.
#include "tile_gemm.cuh"

namespace dse {

template <int BN, typename WT, bool kStreams>
__global__ void __launch_bounds__(kThreads)
causal_conv_transpose_kernel(const float* __restrict__ cache, const float* __restrict__ x,
                             const WT* __restrict__ w, const float* __restrict__ bias,
                             float* __restrict__ out, long long cache_bs, int M, int T_in,
                             int Cin, int Cout, int stride, int act, float slope) {
  extern __shared__ __align__(16) float smem[];
  const int p = blockIdx.z;
  const int cpad = stride - 1;
  const WT* w_now = w + (size_t)(cpad - p) * Cin * Cout;
  const WT* w_next = w + (size_t)(cpad + stride - p) * Cin * Cout;
  const int m0 = blockIdx.x * Tile<BN>::BM;
  const int n0 = blockIdx.y * BN;
  tile_gemm<BN, WT>(
      m0, min(Tile<BN>::BM, M - m0), n0, min(BN, Cout - n0), 2, Cin, Cout, smem,
      [&](int r, int j, int c0, int kk) {
        const int b = kStreams ? r / T_in : 0;
        const int e = r - b * T_in + j, c = c0 + kk;
        const float v = e == 0 ? cache[(size_t)b * cache_bs + c]
                               : x[((size_t)b * T_in + e - 1) * Cin + c];
        return act ? leaky(v, slope) : v;
      },
      [&](int j) { return j == 0 ? w_now : w_next; },
      [&](int r, int n, float v) {
        out[((size_t)r * stride + p) * Cout + n] = bias ? v + bias[n] : v;
      });
}

template <int BN, typename WT>
cudaError_t launch(const float* cache, long long cache_bs, const float* x, const void* w,
                   const float* bias, float* out, int M, int T_in, int Cin, int Cout, int stride,
                   int act, float slope, cudaStream_t stream) {
  const dim3 grid((M + Tile<BN>::BM - 1) / Tile<BN>::BM, (Cout + BN - 1) / BN, stride);
  auto kernel = M > T_in ? causal_conv_transpose_kernel<BN, WT, true>
                         : causal_conv_transpose_kernel<BN, WT, false>;
  kernel<<<grid, kThreads, tile_smem_bytes(BN), stream>>>(
      cache, x, static_cast<const WT*>(w), bias, out, cache_bs, M, T_in, Cin, Cout, stride, act,
      slope);
  return cudaGetLastError();
}

}  // namespace dse

extern "C" int dse_causal_conv_transpose(const float* cache, long long cache_bs,
                                         const float* x, const void* w, const float* bias,
                                         float* out, int B, int T_in, int Cin, int Cout,
                                         int stride, int act, float slope, int bf16,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || T_in <= 0 || Cin <= 0 || Cout <= 0 || stride <= 0 ||
      (long long)B * T_in * stride > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const int M = B * T_in;
  const bool narrow = dse::tile_bn(Cout) == 32;
  if (bf16)
    return narrow ? dse::launch<32, __nv_bfloat16>(cache, cache_bs, x, w, bias, out, M, T_in,
                                                   Cin, Cout, stride, act, slope, s)
                  : dse::launch<64, __nv_bfloat16>(cache, cache_bs, x, w, bias, out, M, T_in,
                                                   Cin, Cout, stride, act, slope, s);
  return narrow ? dse::launch<32, float>(cache, cache_bs, x, w, bias, out, M, T_in, Cin, Cout,
                                         stride, act, slope, s)
                : dse::launch<64, float>(cache, cache_bs, x, w, bias, out, M, T_in, Cin, Cout,
                                         stride, act, slope, s);
}
