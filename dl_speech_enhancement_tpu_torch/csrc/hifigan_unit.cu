// hifigan_unit: one dilation unit of a grouped HiFiGAN residual block, for B
// streams in one launch,
//
//     h   = leaky(b1 + conv1_d(leaky(x_ext1)))      grouped, k taps, dilation d
//     out = (acc + (x + b2 + conv2_1(h_ext))) * out_scale   grouped, k taps, dilation 1
//     x_ext1 = [cache1 ((k-1)*d rows); x],  h_ext = [cache2 (k-1 rows); h]
//
// with LeakyReLU(slope) (0.1 in HiFiGAN); `acc` (B, T, groups*c) is optional
// (absent: 0, and out_scale 1 leaves the unit's output as it is). Replaces the
// unit bodies of the TPU kernels dl_speech_enhancement_tpu/ops/
// vocoder_kernel.py::make_mega_vocoder (add_resunit / add_resunit_packed /
// add_resunit_chunked; and add_mrf's block sum and mean, :667-714) and of ops/
// vocoder_stacked.py::make_stacked_vocoder (r_body).
//
// The accumulate epilogue is the MultiReceptiveField stage (v0/v3 receivers):
// its output is the mean of n blocks over the same entrance. Block 0's last
// unit writes the running sum, each later block's last unit adds its output to
// it, and the last one scales by 1/n: the JAX order (acc + y, then / n) at no
// extra launch. Those pack groups into
// block-diagonal 128-lane matmuls because Mosaic pads every operand to 128
// lanes; here each group is its own dense GEMM.
//
// Groups: group g computes output channels [g*c, (g+1)*c) from input channels
// [g*s, g*s + c) with s = `in_gstride`: s = c for a unit whose input has
// groups*c channels, s = 0 for the first unit of a MultiGroupConv1d, whose
// input x has c channels and is read by every group (the reference's
// jnp.tile(x, (1, 1, groups)) done by the loader, with the residual add
// reading x the same way). Weights are (k, c, groups*c), the JAX package's
// grouped layout, so group g's columns are a column tile of the tap GEMM.
//
// Caches: cache1 (B, (k-1)*d, Cin) is the tail of the raw unit input (leaky is
// applied on load), so the caller's next cache1 is a view of x. cache2 (B,
// k-1, groups*c) holds conv2's window rows of h as the reference caches them
// (activated, and zeros at stream start). The kernel writes the next cache2,
// the last k-1 rows of h_ext, into `new_cache2`. (A single raw-input cache
// would recompute conv2's history from conv1 and give it leaky(b1) instead of
// zeros at stream start.)
//
// What bounds it: the operations, 2*k*c*c multiply-adds per row and group per
// conv against ~(Cin + groups*c) floats moved per row; at one frame per
// dispatch stage 0 has 20 rows x 3 groups, so only a few blocks run and the
// launch and the serial GEMM steps set its time. Design: one block per
// (stream, row tile, group), so a tile never spans two streams. GEMM 1
// (tile_gemm.cuh) computes the tile's h rows plus the k-1 rows before them
// (recomputed by the neighbouring tile, as the residual chain recomputes its
// halo) into shared memory, taking rows before the stream's start from cache2;
// GEMM 2 reads h from shared memory and adds the bias and the raw-x residual
// in its epilogue. The host picks the tile (ops/vocoder_kernel.py::_unit_plan).
#include "tile_gemm.cuh"

namespace dse {

template <int BN, typename WT>
__global__ void __launch_bounds__(kThreads)
hifigan_unit_kernel(const float* __restrict__ cache1, long long c1_bs,
                    const float* __restrict__ cache2, long long c2_bs,
                    const float* __restrict__ x, const WT* __restrict__ w1,
                    const float* __restrict__ b1, const WT* __restrict__ w2,
                    const float* __restrict__ b2, const float* __restrict__ acc,
                    float out_scale, float* __restrict__ out,
                    float* __restrict__ new_cache2, int T, int c, int groups, int in_gstride,
                    int Cin, int taps, int dil, int tile, float slope) {
  extern __shared__ __align__(16) float smem[];
  float* stage = smem;
  float* H = smem + Tile<BN>::kSmemFloats;  // h_ext rows [t0, t0 + count + k - 1) x c
  const int n_tiles = (T + tile - 1) / tile;
  const int g = blockIdx.x % groups;
  const int b = (blockIdx.x / groups) / n_tiles;
  const int t0 = (blockIdx.x / groups - b * n_tiles) * tile;
  const int count = min(tile, T - t0);
  const int ctx2 = taps - 1;
  const int P1 = (taps - 1) * dil;
  const int gc = groups * c;
  const int n0 = g * c;
  const int ch0 = g * in_gstride;
  const int hs = t0 - ctx2;  // h row of H's first row; rows < 0 come from cache2
  cache1 += (size_t)b * c1_bs;
  cache2 += (size_t)b * c2_bs;
  x += (size_t)b * T * Cin;
  out += (size_t)b * T * gc;
  if (acc) acc += (size_t)b * T * gc;

  tile_gemm<BN, WT>(
      0, count + ctx2, n0, c, taps, c, gc, stage,
      [&](int m, int j, int c0, int kk) {
        const int tp = hs + m;
        if (tp < 0) return 0.f;  // this H row is taken from cache2
        const int e = tp + j * dil, ch = ch0 + c0 + kk;
        return leaky(e < P1 ? cache1[(size_t)e * Cin + ch] : x[(size_t)(e - P1) * Cin + ch],
                     slope);
      },
      [&](int j) { return w1 + (size_t)j * c * gc; },
      [&](int m, int n, float v) {
        const int tp = hs + m;
        H[m * c + n - n0] = tp >= 0 ? leaky(b1 ? v + b1[n] : v, slope)
                                    : cache2[(size_t)(tp + ctx2) * gc + n];
      });

  if (t0 + count == T) {  // the stream's last tile holds the next cache2
    float* nc = new_cache2 + (size_t)b * ctx2 * gc + n0;
    for (int e = threadIdx.x; e < ctx2 * c; e += kThreads) {
      const int r = e / c;
      nc[(size_t)r * gc + e - r * c] = H[(count + r) * c + e - r * c];
    }
  }

  tile_gemm<BN, WT>(
      0, count, n0, c, taps, c, gc, stage,
      [&](int m, int j, int c0, int kk) { return H[(m + j) * c + c0 + kk]; },
      [&](int j) { return w2 + (size_t)j * c * gc; },
      [&](int m, int n, float v) {
        const int t = t0 + m;
        const float y = x[(size_t)t * Cin + ch0 + n - n0] + (b2 ? v + b2[n] : v);
        out[(size_t)t * gc + n] = (acc ? acc[(size_t)t * gc + n] + y : y) * out_scale;
      });
}

template <int BN, typename WT>
cudaError_t launch(const float* cache1, long long c1_bs, const float* cache2, long long c2_bs,
                   const float* x, const void* w1, const float* b1, const void* w2,
                   const float* b2, const float* acc, float out_scale, float* out,
                   float* new_cache2, int B, int T, int c,
                   int groups, int in_gstride, int Cin, int taps, int dil, int tile, float slope,
                   size_t smem, cudaStream_t stream) {
  static size_t configured = 0;
  auto kernel = hifigan_unit_kernel<BN, WT>;
  cudaError_t err = allow_smem(kernel, smem, &configured);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * ((T + tile - 1) / tile) * groups);
  kernel<<<grid, kThreads, smem, stream>>>(
      cache1, c1_bs, cache2, c2_bs, x, static_cast<const WT*>(w1), b1,
      static_cast<const WT*>(w2), b2, acc, out_scale, out, new_cache2, T, c, groups, in_gstride,
      Cin, taps, dil, tile, slope);
  return cudaGetLastError();
}

}  // namespace dse

// Shared memory one block needs for a tile of `tile` output rows.
extern "C" size_t dse_hifigan_unit_smem(int tile, int c, int taps) {
  return dse::tile_smem_bytes(dse::tile_bn(c)) + (size_t)(tile + taps - 1) * c * sizeof(float);
}

extern "C" int dse_hifigan_unit(const float* cache1, long long c1_bs, const float* cache2,
                                long long c2_bs, const float* x, const void* w1, const float* b1,
                                const void* w2, const float* b2, const float* acc,
                                float out_scale, float* out, float* new_cache2, int B, int T,
                                int c, int groups, int tiled, int taps, int dil, int tile,
                                float slope, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || T <= 0 || c <= 0 || groups <= 0 || taps <= 1 || dil <= 0 || tile <= 0 ||
      (long long)B * ((T + tile - 1) / tile) * groups > 0x7fffffffLL ||
      (long long)B * T * groups * c > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const size_t smem = dse_hifigan_unit_smem(tile, c, taps);
  if (smem > 232448) return cudaErrorInvalidValue;
  const int in_gstride = tiled ? 0 : c;
  const int Cin = tiled ? c : groups * c;
  const bool narrow = dse::tile_bn(c) == 32;
  if (bf16)
    return narrow ? dse::launch<32, __nv_bfloat16>(
                        cache1, c1_bs, cache2, c2_bs, x, w1, b1, w2, b2, acc, out_scale, out,
                        new_cache2, B, T, c, groups, in_gstride, Cin, taps, dil, tile, slope,
                        smem, s)
                  : dse::launch<64, __nv_bfloat16>(
                        cache1, c1_bs, cache2, c2_bs, x, w1, b1, w2, b2, acc, out_scale, out,
                        new_cache2, B, T, c, groups, in_gstride, Cin, taps, dil, tile, slope,
                        smem, s);
  return narrow ? dse::launch<32, float>(cache1, c1_bs, cache2, c2_bs, x, w1, b1, w2, b2, acc,
                                         out_scale, out, new_cache2, B, T, c, groups,
                                         in_gstride, Cin, taps, dil, tile, slope, smem, s)
                : dse::launch<64, float>(cache1, c1_bs, cache2, c2_bs, x, w1, b1, w2, b2, acc,
                                         out_scale, out, new_cache2, B, T, c, groups,
                                         in_gstride, Cin, taps, dil, tile, slope, smem, s);
}
