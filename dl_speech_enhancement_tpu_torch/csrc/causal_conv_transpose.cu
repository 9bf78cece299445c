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
// re-interleaved with a replication matmul and an iota mask, and those of the
// HiFiGAN vocoder (ops/vocoder_kernel.py::make_mega_vocoder's add_upsample).
//
// B independent streams run in one launch: cache (B, 1, Cin) with stream stride
// `cache_bs` floats, x (B, T, Cin), out (B, T*s, Cout); x and out both f32 or
// both bf16 (the streams' boundary dtype, widened as staged and rounded as
// stored: conv_gemm.cuh), the cache f32. With `act` = 1 every
// element of [cache; x] is passed through LeakyReLU(`slope`) as it is staged
// (the vocoder's LeakyReLU(0.1) before each upsample), so a stage's cache
// stays the tail of its raw input.
//
// What bounds it: the operations (2*Cin*Cout multiply-adds per output row) at
// many rows, latency at few (one frame: 4 input rows a stream at the first
// upsample, 1,024 terms a sum). Design: phase p is exactly a causal conv of
// 2 taps, stride 1 and dilation 1 over the one-row cache, whose rows are
// written at stride s, offset p; so every phase runs on causal_conv's GEMM
// arm (conv_gemm.cuh: split-TF32 `mma.sync` tiles, the 2*Cin terms cut into
// fixed 64-term chunks, a thread-block cluster splitting the chunks at few
// rows and folding them in chunk order through distributed shared memory)
// with the phases on grid.y, each reading its tap pair in place from Wc and
// writing its rows in place, with no interleave pass. A stream's bits depend
// on the layer alone, whatever B, T or the plan. The plan (tile, steps per
// block) comes from the host's planner (ops/mega_kernel.py::_upsample_plan,
// pure Python, whose shared-memory formula equals
// dse_causal_conv_transpose_smem); a plan that does not fit is refused here,
// never replaced.
#include "conv_gemm.cuh"

// Shared memory one block of the plan (tile, steps_per_block) takes: the
// GEMM arm's at 2 taps of Cin channels.
extern "C" size_t dse_causal_conv_transpose_smem(int tile, int Cin, int Cout,
                                                 int steps_per_block, int bf16) {
  return dse::conv_gemm_smem(tile, Cin, Cout, 2, steps_per_block, bf16);
}

// `types`: bit 0 bf16 weights (else f32), bit 1 bf16 x and out (else f32).
extern "C" int dse_causal_conv_transpose(const float* cache, long long cache_bs,
                                         const void* x, const void* w, const float* bias,
                                         void* out, int B, int T_in, int Cin, int Cout,
                                         int stride, int act, float slope, int types, int tile,
                                         int steps_per_block, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bf16 = types & 1;
  if (types & ~3) return cudaErrorInvalidValue;
  if (B <= 0 || T_in <= 0 || Cin <= 0 || Cout <= 0 || stride <= 0 || stride > 65535 ||
      (long long)B * T_in * stride > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const size_t smem = dse_causal_conv_transpose_smem(tile, Cin, Cout, steps_per_block, bf16);
  if (!dse::conv_gemm_plan_ok(tile, steps_per_block, dse::conv_steps(2, Cin)) || smem > 232448)
    return cudaErrorInvalidValue;
  // each phase: a 2-tap conv over the one-row cache, stride 1, dilation 1
  const dse::ConvArgs a{cache, cache_bs, x, w, bias, out, B * T_in, T_in, Cin, Cout, 2, 1, 1,
                        act, 0, slope, stride};
  using bf = __nv_bfloat16;
  switch (types) {
    case 0: return dse::launch_conv_gemm<float, float, float, true>(a, tile, steps_per_block,
                                                                   smem, s);
    case 1: return dse::launch_conv_gemm<bf, float, float, true>(a, tile, steps_per_block, smem,
                                                                s);
    case 2: return dse::launch_conv_gemm<float, bf, bf, true>(a, tile, steps_per_block, smem, s);
    default: return dse::launch_conv_gemm<bf, bf, bf, true>(a, tile, steps_per_block, smem, s);
  }
}
