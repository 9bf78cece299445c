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
// both bf16 (the streams' boundary dtype; bf16 x is staged as bf16 and
// widened as read, its low TF32 pass skipped, and the output rounded as
// stored: conv_gemm.cuh), the cache f32. With bf16 weights each input
// element is rounded to bf16 after its activation, as the reference rounds
// it, so every product is bf16 by bf16 in one TF32 pass. With `act` = 1 every
// element of [cache; x] is passed through LeakyReLU(`slope`) (the vocoder's
// LeakyReLU(0.1) before each upsample), so a stage's cache stays the tail of
// its raw input.
//
// What bounds it: the operations (2*Cin*Cout multiply-adds per output row) at
// many rows, latency at few (one frame: 4 input rows a stream at the first
// upsample, 1,024 terms a sum). Design: phase p is exactly a causal conv of
// 2 taps, stride 1 and dilation 1 over the one-row cache, whose rows are
// written at stride s, offset p; so every phase runs on causal_conv's GEMM
// arm (conv_gemm.cuh: TF32 `mma.sync` tiles, the 2*Cin terms cut into
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

// Shared memory one block of the plan (tile, steps_per_block) takes for
// `types` (bit 0 bf16 weights, bit 1 bf16 x and out) at T_in input rows a
// stream: the GEMM arm's at 2 taps of Cin channels, stride 1, dilation 1.
extern "C" size_t dse_causal_conv_transpose_smem(int tile, int Cin, int Cout,
                                                 int steps_per_block, int types, int T_in) {
  const int x_bf16 = (types >> 1) & 1;
  int bm = 0, bn, threads;
  dse::conv_tile_dims(tile, &bm, &bn, &threads);
  return dse::conv_gemm_smem(
      tile, Cin, Cout, 2, steps_per_block, types & 1, x_bf16,
      x_bf16 ? dse::conv_side_rows(bm, T_in, dse::conv_cache_rows(2, 1, 1)) : 0);
}

// `types`: bit 0 bf16 weights (else f32), bit 1 bf16 x and out (else f32),
// bits 2-3 the vocoder's rounding (bf16 weights only): 1 each product
// rounded to bf16 before the bias, as JAX K4 rounds `yp.astype(wd)`
// (ops/vocoder_kernel.py:324); 2 each output after it, as JAX K5 rounds
// before its tiling matmul (ops/vocoder_stacked.py:253).
extern "C" int dse_causal_conv_transpose(const float* cache, long long cache_bs,
                                         const void* x, const void* w, const float* bias,
                                         void* out, int B, int T_in, int Cin, int Cout,
                                         int stride, int act, float slope, int types, int tile,
                                         int steps_per_block, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int round_mode = types >> 2;
  if (types & ~15 || round_mode == 3 || (round_mode && !(types & 1))) return cudaErrorInvalidValue;
  if (B <= 0 || T_in <= 0 || Cin <= 0 || Cout <= 0 || stride <= 0 || stride > 65535 ||
      (long long)B * T_in * stride > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const size_t smem = dse_causal_conv_transpose_smem(tile, Cin, Cout, steps_per_block, types & 3,
                                                     T_in);
  if (!dse::conv_gemm_plan_ok(tile, steps_per_block, dse::conv_steps(2, Cin), (types & 3) == 3) ||
      smem > 232448)
    return cudaErrorInvalidValue;
  // each phase: a 2-tap conv over the one-row cache, stride 1, dilation 1
  const dse::ConvArgs a{cache, cache_bs, x, w, bias, out, B * T_in, T_in, Cin, Cout, 2, 1, 1,
                        act, 0, slope, stride, round_mode};
  using bf = __nv_bfloat16;
  switch (types & 3) {
    case 0: return dse::launch_conv_gemm<float, float, float, true>(a, tile, steps_per_block,
                                                                   smem, s);
    case 1: return dse::launch_conv_gemm<bf, float, float, true>(a, tile, steps_per_block, smem,
                                                                s);
    case 2: return dse::launch_conv_gemm<float, bf, bf, true>(a, tile, steps_per_block, smem, s);
    default: return dse::launch_conv_gemm<bf, bf, bf, true>(a, tile, steps_per_block, smem, s);
  }
}
