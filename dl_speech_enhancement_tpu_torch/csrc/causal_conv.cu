// causal_conv: a strided, dilated causal convolution over a cache-prepended
// input,
//
//     y[t] = b + sum_{j < k} x_ext[s*t + j*d] @ W[j],
//     x_ext = [cache ((k-1)*d rows); x]
//
// It serves the encoder input conv (k=7, 1 -> 32), the four strided
// downsamples (k = 2s) and the decoder output conv (k=7, 32 -> 1) of the
// streaming generator. Replaces the boundary convs that the TPU kernels
// dl_speech_enhancement_tpu/ops/mega_kernel.py::make_mega_stream.enc_kernel
// (input conv, downsamples) and .dec_kernel (output conv) evaluate in VMEM,
// and those of the HiFiGAN vocoder, ops/vocoder_kernel.py::make_mega_vocoder
// (input conv, the 1x1 fuse of each stage, and the output conv, which takes
// `act` = 1 for its LeakyReLU(0.01) on load and `tanh_out` for its tanh).
//
// Optional fused activation: with `act` = 1 the A loader applies
// LeakyReLU(`slope`) to every element of [cache; x] it loads, so the caller
// never writes the activated input and a layer's cache stays the tail of its
// raw input; with `tanh_out` the epilogue writes tanh(y). With act = 0 and
// tanh_out = 0 (the generator's convs) the arithmetic is the plain conv's.
//
// B independent streams run in one launch: cache (B, (k-1)*d, Cin) with stream
// stride `cache_bs` floats (rows contiguous), x (B, T, Cin), out (B, T/s, Cout).
// The GEMM's M dimension is B * T/s; the A loader maps row m to (stream m /
// (T/s), time m % (T/s)), so a window reads only its own stream's cache and
// input, and at one frame per dispatch the deep downsamples get B times the
// 4-20 rows of one stream. The division m / (T/s) is an integer division
// per loaded element; it is compiled out for one stream (kStreams = false),
// which then runs the arithmetic of the single-stream kernel.
//
// What bounds it: the downsamples are operation-bound (k*Cin*Cout
// multiply-adds per output row against Cin*s + Cout floats moved); the input
// and output convs are byte-bound (one input or output channel). Design: a
// grid of (row tile, column tile) blocks over the tap GEMM of tile_gemm.cuh.
// The cache and the new input are read through two pointers, so the caller
// never concatenates them, and strided rows are indexed directly (the TPU
// version needed 0/1 selection matmuls and time folding for that).
#include "tile_gemm.cuh"

namespace dse {

template <int BN, typename WT, bool kStreams>
__global__ void __launch_bounds__(kThreads)
causal_conv_kernel(const float* __restrict__ cache, const float* __restrict__ x,
                   const WT* __restrict__ w, const float* __restrict__ bias,
                   float* __restrict__ out, long long cache_bs, int M, int T_out, int Cin,
                   int Cout, int taps, int stride, int dil, int act, float slope,
                   int tanh_out) {
  extern __shared__ __align__(16) float smem[];
  const int P = (taps - 1) * dil;
  const int T_in = T_out * stride;
  const int m0 = blockIdx.x * Tile<BN>::BM;
  const int n0 = blockIdx.y * BN;
  tile_gemm<BN, WT>(
      m0, min(Tile<BN>::BM, M - m0), n0, min(BN, Cout - n0), taps, Cin, Cout, smem,
      [&](int m, int j, int c0, int kk) {
        const int b = kStreams ? m / T_out : 0;
        const int e = (m - b * T_out) * stride + j * dil, c = c0 + kk;
        const float v = e < P ? cache[(size_t)b * cache_bs + (size_t)e * Cin + c]
                              : x[((size_t)b * T_in + e - P) * Cin + c];
        return act ? leaky(v, slope) : v;
      },
      [&](int j) { return w + (size_t)j * Cin * Cout; },
      [&](int m, int n, float v) {
        const float y = bias ? v + bias[n] : v;
        out[(size_t)m * Cout + n] = tanh_out ? tanhf(y) : y;
      });
}

template <int BN, typename WT>
cudaError_t launch(const float* cache, long long cache_bs, const float* x, const void* w,
                   const float* bias, float* out, int M, int T_out, int Cin, int Cout, int taps,
                   int stride, int dil, int act, float slope, int tanh_out,
                   cudaStream_t stream) {
  const dim3 grid((M + Tile<BN>::BM - 1) / Tile<BN>::BM, (Cout + BN - 1) / BN);
  auto kernel = M > T_out ? causal_conv_kernel<BN, WT, true>
                          : causal_conv_kernel<BN, WT, false>;
  kernel<<<grid, kThreads, tile_smem_bytes(BN), stream>>>(
      cache, x, static_cast<const WT*>(w), bias, out, cache_bs, M, T_out, Cin, Cout, taps,
      stride, dil, act, slope, tanh_out);
  return cudaGetLastError();
}

}  // namespace dse

extern "C" int dse_causal_conv(const float* cache, long long cache_bs, const float* x,
                               const void* w, const float* bias, float* out, int B, int T_out,
                               int Cin, int Cout, int taps, int stride, int dil, int act,
                               float slope, int tanh_out, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || T_out <= 0 || Cin <= 0 || Cout <= 0 || taps <= 0 || stride <= 0 || dil <= 0 ||
      (long long)B * T_out * stride > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const int M = B * T_out;
  const bool narrow = dse::tile_bn(Cout) == 32;
  if (bf16)
    return narrow ? dse::launch<32, __nv_bfloat16>(cache, cache_bs, x, w, bias, out, M, T_out,
                                                   Cin, Cout, taps, stride, dil, act, slope,
                                                   tanh_out, s)
                  : dse::launch<64, __nv_bfloat16>(cache, cache_bs, x, w, bias, out, M, T_out,
                                                   Cin, Cout, taps, stride, dil, act, slope,
                                                   tanh_out, s);
  return narrow ? dse::launch<32, float>(cache, cache_bs, x, w, bias, out, M, T_out, Cin, Cout,
                                         taps, stride, dil, act, slope, tanh_out, s)
                : dse::launch<64, float>(cache, cache_bs, x, w, bias, out, M, T_out, Cin, Cout,
                                         taps, stride, dil, act, slope, tanh_out, s);
}
