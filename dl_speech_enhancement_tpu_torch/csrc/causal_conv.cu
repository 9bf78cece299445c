// causal_conv: a strided, dilated causal convolution over a cache-prepended
// input,
//
//     y[t] = b + sum_{j < k} x_ext[s*t + j*d] @ W[j],
//     x_ext = [cache ((k-1)*d rows); x]
//
// It serves the encoder input conv (k=7, 1 -> 32), the four strided
// downsamples (k = 2s), the PQC projector and decoder input conv, and the
// decoder output conv (k=7, 32 -> 1) of the streaming generator. Replaces the
// boundary convs that the TPU kernels
// dl_speech_enhancement_tpu/ops/mega_kernel.py::make_mega_stream.enc_kernel
// (input conv, downsamples, projector) and .dec_kernel (PQC input conv,
// output conv) evaluate in VMEM, and those of the HiFiGAN vocoder,
// ops/vocoder_kernel.py::make_mega_vocoder (input conv, the 1x1 fuse of each
// stage, and the output conv, which takes `act` = 1 for its LeakyReLU(0.01)
// on load and `tanh_out` for its tanh).
//
// With `act` = 1 every element of [cache; x] is passed through
// LeakyReLU(`slope`) as it is read, so a layer's cache stays the tail of its
// raw input; with `tanh_out` the epilogue writes tanh(y).
//
// B independent streams run in one launch: cache (B, (k-1)*d, Cin) with stream
// stride `cache_bs` floats (rows contiguous), x (B, T, Cin), out (B, T/s, Cout).
// The cache and the new input are read through two pointers, so the caller
// never concatenates them. x and out are each f32 or bf16 (the streams'
// boundary dtype, ops/mega_stacked.py; the cache stays f32): every arm widens
// what it loads to f32 and rounds what it stores, so its sums are the f32
// arm's on the same values. The GEMM arm takes f32 or bf16 x into an output
// of its own type, or f32 x into bf16 (a half's first launch); the Cin = 1
// and Cout = 1 arms take every pair (the audio in, the audio out).
//
// Three arms; the host's planner (ops/mega_kernel.py::_conv_plan, pure
// Python, whose shared-memory formula conv_smem_bytes equals
// dse_causal_conv_smem) picks one from the layer's shape and its plan from B x
// T/s. A plan that does not fit is refused here, never replaced.
//
// 1. Cin = 1 (the encoder input conv): byte-bound, 2*k*Cout operations per
//    output row of 4*Cout bytes. Each thread computes 4 adjacent columns of
//    one row from W in shared memory, summing the taps in ascending order,
//    and writes them with one 16-byte store.
// 2. Cout = 1 (the decoder and vocoder output convs): byte-bound by the
//    input, Cin floats a row. A block stages its rows' window of [cache; x]
//    (rows s*t0 .. s*(t0+rows-1) + (k-1)*d) into shared memory once, so each
//    input row feeds k output rows, and one thread reduces one output row's
//    k*Cin products serially in (tap, channel) order.
// 3. GEMM (every other site): operation-bound at many rows, latency-bound at
//    few. Split-TF32 `mma.sync` tiles over fixed 64-term chunks of the
//    reduction, split over a thread-block cluster at few rows and folded in
//    chunk order through distributed shared memory, so a stream's bits
//    depend on the layer alone: conv_gemm.cuh, which causal_conv_transpose.cu
//    shares.
#include "conv_gemm.cuh"

namespace dse {
namespace {

constexpr int kDirectThreads = 256;

template <typename XT>
__device__ __forceinline__ float conv_in(const ConvArgs& a, int b, int e, int c) {
  const int P = (a.taps - 1) * a.dil;
  const float v =
      e < P ? a.cache[(size_t)b * a.cache_bs + (size_t)e * a.Cin + c]
            : to_f(static_cast<const XT*>(a.x)[((size_t)b * a.T_out * a.stride + e - P) * a.Cin +
                                               c]);
  return a.act ? leaky(v, a.slope) : v;
}

// ---------------------------------------------------------------- Cin = 1

template <typename WT, typename XT, typename YT>
__global__ void __launch_bounds__(kDirectThreads)
causal_conv_kernel_cin1(ConvArgs a) {
  extern __shared__ __align__(16) float ws[];  // W (taps, Cout) widened to f32
  const WT* w = static_cast<const WT*>(a.w);
  for (int i = threadIdx.x; i < a.taps * a.Cout; i += kDirectThreads) ws[i] = to_f(w[i]);
  __syncthreads();
  const int groups = (a.Cout + 3) / 4;
  const long long idx = (long long)blockIdx.x * kDirectThreads + threadIdx.x;
  if (idx >= (long long)a.M * groups) return;
  const int m = (int)(idx / groups), n = (int)(idx - (long long)m * groups) * 4;
  const int b = m / a.T_out, t = m - b * a.T_out;
  float y[4] = {0.f, 0.f, 0.f, 0.f};
  for (int j = 0; j < a.taps; ++j) {
    const float v = conv_in<XT>(a, b, t * a.stride + j * a.dil, 0);
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (n + u < a.Cout) y[u] = fmaf(v, ws[j * a.Cout + n + u], y[u]);
  }
  YT* o = static_cast<YT*>(a.out) + (size_t)m * a.Cout + n;
  if (a.Cout % 4 == 0) {
    store4(o, make_float4(conv_out(a, n, y[0]), conv_out(a, n + 1, y[1]),
                          conv_out(a, n + 2, y[2]), conv_out(a, n + 3, y[3])));
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (n + u < a.Cout) o[u] = from_f<YT>(conv_out(a, n + u, y[u]));
  }
}

// ---------------------------------------------------------------- Cout = 1

__host__ __device__ inline int cout1_window_rows(int rows, int stride, int taps, int dil) {
  return (rows - 1) * stride + (taps - 1) * dil + 1;
}

template <typename WT, typename XT, typename YT>
__global__ void __launch_bounds__(kDirectThreads)
causal_conv_kernel_cout1(ConvArgs a, int rows) {
  extern __shared__ __align__(16) float smem_c1[];
  const int ld = a.Cin | 1;  // odd row stride: a warp's 32 rows hit 32 banks
  const int tiles = (a.T_out + rows - 1) / rows;
  const int b = blockIdx.x / tiles, t0 = (blockIdx.x - b * tiles) * rows;
  const int count = min(rows, a.T_out - t0);
  const int wrows = cout1_window_rows(count, a.stride, a.taps, a.dil);
  float* win = smem_c1;
  float* ws = smem_c1 + (size_t)cout1_window_rows(rows, a.stride, a.taps, a.dil) * ld;
  const WT* w = static_cast<const WT*>(a.w);
  for (int i = threadIdx.x; i < a.taps * a.Cin; i += kDirectThreads) ws[i] = to_f(w[i]);
  for (int q = threadIdx.x; q < wrows * a.Cin; q += kDirectThreads) {
    const int r = q / a.Cin, c = q - r * a.Cin;
    win[r * ld + c] = conv_in<XT>(a, b, t0 * a.stride + r, c);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < count; i += kDirectThreads) {
    const float* row = win + (size_t)i * a.stride * ld;
    float acc = 0.f;
    for (int j = 0; j < a.taps; ++j) {
      const float* xr = row + (size_t)j * a.dil * ld;
      const float* wr = ws + j * a.Cin;
#pragma unroll 4
      for (int c = 0; c < a.Cin; ++c) acc = fmaf(xr[c], wr[c], acc);
    }
    static_cast<YT*>(a.out)[(size_t)b * a.T_out + t0 + i] =
        from_f<YT>(conv_out(a, 0, acc));
  }
}

template <typename Kernel>
cudaError_t launch_direct(Kernel kernel, size_t* configured, dim3 grid, size_t smem,
                          cudaStream_t stream, const ConvArgs& a) {
  cudaError_t err = allow_smem(kernel, smem, configured);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kDirectThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename WT, typename XT, typename YT>
cudaError_t launch_conv(const ConvArgs& a, int arm, int tile, int steps_per_block, size_t smem,
                        cudaStream_t s) {
  if (arm == 0) {
    static size_t configured[kMaxDevices] = {};
    const long long threads = (long long)a.M * ((a.Cout + 3) / 4);
    return launch_direct(causal_conv_kernel_cin1<WT, XT, YT>, configured,
                         dim3((unsigned)((threads + kDirectThreads - 1) / kDirectThreads)), smem,
                         s, a);
  }
  if (arm == 1) {
    static size_t configured[kMaxDevices] = {};
    auto kernel = causal_conv_kernel_cout1<WT, XT, YT>;
    cudaError_t err = allow_smem(kernel, smem, configured);
    if (err != cudaSuccess) return err;
    const int B = a.M / a.T_out;
    kernel<<<B * ((a.T_out + tile - 1) / tile), kDirectThreads, smem, s>>>(a, tile);
    return cudaGetLastError();
  }
  // the GEMM arm's pairs: f32 -> f32, bf16 -> bf16, f32 -> bf16
  if constexpr (sizeof(XT) == 2 && sizeof(YT) == 4) return cudaErrorInvalidValue;
  else return launch_conv_gemm<WT, XT, YT, false>(a, tile, steps_per_block, smem, s);
}

template <typename WT>
cudaError_t launch_types(int types, const ConvArgs& a, int arm, int tile, int steps_per_block,
                         size_t smem, cudaStream_t s) {
  switch (types >> 1) {
    case 0: return launch_conv<WT, float, float>(a, arm, tile, steps_per_block, smem, s);
    case 1:
      return launch_conv<WT, __nv_bfloat16, float>(a, arm, tile, steps_per_block, smem, s);
    case 2:
      return launch_conv<WT, float, __nv_bfloat16>(a, arm, tile, steps_per_block, smem, s);
    default:
      return launch_conv<WT, __nv_bfloat16, __nv_bfloat16>(a, arm, tile, steps_per_block, smem,
                                                           s);
  }
}

}  // namespace
}  // namespace dse

// Shared memory one block of the plan (arm, tile, steps_per_block) takes:
// arm 0 (Cin = 1) W as f32; arm 1 (Cout = 1) the window of `tile` output rows
// (odd row stride Cin | 1) and W; arm 2 (GEMM, `tile` an index of
// DSE_CONV_TILES) the (A, W) ring, a stage per step up to kConvStages, and,
// when a cluster splits the steps, `steps_per_block` BM x BN f32 slots.
extern "C" size_t dse_causal_conv_smem(int arm, int tile, int Cin, int Cout, int taps,
                                       int stride, int dil, int steps_per_block, int bf16) {
  if (arm == 0) return sizeof(float) * (size_t)taps * Cout;
  if (arm == 1)
    return sizeof(float) * ((size_t)dse::cout1_window_rows(tile, stride, taps, dil) * (Cin | 1) +
                            (size_t)taps * Cin);
  return dse::conv_gemm_smem(tile, Cin, Cout, taps, steps_per_block, bf16);
}

// `types`: bit 0 bf16 weights (else f32), bit 1 bf16 x, bit 2 bf16 out.
extern "C" int dse_causal_conv(const float* cache, long long cache_bs, const void* x,
                               const void* w, const float* bias, void* out, int B, int T_out,
                               int Cin, int Cout, int taps, int stride, int dil, int act,
                               float slope, int tanh_out, int types, int arm, int tile,
                               int steps_per_block, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bf16 = types & 1;
  if (types & ~7) return cudaErrorInvalidValue;
  if (B <= 0 || T_out <= 0 || Cin <= 0 || Cout <= 0 || taps <= 0 || stride <= 0 || dil <= 0 ||
      (long long)B * T_out * stride > 0x7fffffffLL ||
      (long long)B * T_out * (Cout + 3) > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const int S = dse::conv_steps(taps, Cin);
  const bool ok = arm == 0 ? Cin == 1
                  : arm == 1 ? Cout == 1 && tile >= 1 && tile <= dse::kDirectThreads
                  : arm == 2 && dse::conv_gemm_plan_ok(tile, steps_per_block, S);
  const size_t smem = dse_causal_conv_smem(arm, tile, Cin, Cout, taps, stride, dil,
                                           steps_per_block, bf16);
  if (!ok || smem > 232448) return cudaErrorInvalidValue;
  const dse::ConvArgs a{cache, cache_bs, x, w, bias, out, B * T_out, T_out, Cin, Cout,
                        taps, stride, dil, act, tanh_out, slope};
  if (bf16) return dse::launch_types<__nv_bfloat16>(types, a, arm, tile, steps_per_block, smem, s);
  return dse::launch_types<float>(types, a, arm, tile, steps_per_block, smem, s);
}
