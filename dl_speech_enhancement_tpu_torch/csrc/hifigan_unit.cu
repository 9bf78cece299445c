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
// vocoder_stacked.py::make_stacked_vocoder (r_body). Those keep a stage's
// weights in ~16 MB of VMEM and pack groups into block-diagonal 128-lane
// matmuls because Mosaic pads every operand to 128 lanes; here each group is
// its own dense GEMM, spread over a thread-block cluster.
//
// The accumulate epilogue is the MultiReceptiveField stage (v0/v3 receivers):
// its output is the mean of n blocks over the same entrance. Block 0's last
// unit writes the running sum, each later block's last unit adds its output to
// it, and the last one scales by 1/n: the JAX order (acc + y, then / n) at no
// extra launch.
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
// the last k-1 rows of h_ext, into `new_cache2`.
//
// What bounds it: the operations, 2*k*c*c multiply-adds per row and group per
// conv against ~(Cin + groups*c) floats moved per row. At one frame per
// dispatch stage 0 has only 20 rows at c = 256, so the card is filled by
// splitting columns, and a block's time is its serial chain of tensor-core
// steps. Design: one cluster of n blocks (n = 1, 2, 4, 8) per (stream, row
// tile, group); a tile never spans two streams. Block r of the cluster owns
// the group's columns [r*c/n, (r+1)*c/n):
// - it stages the tile's leaky input window (tile + k - 1 rows of h, each
//   reaching back (k-1)*d rows) into shared memory with cp.async;
// - GEMM 1 (tile_mma.cuh) computes its columns of h for the tile's rows and
//   the k - 1 rows before them (recomputed by the neighbouring tile), taking
//   rows before the stream's start from cache2, and writes its slice of the
//   next cache2;
// - after cluster.sync() it copies the peers' h columns once through
//   distributed shared memory, so GEMM 2 reads the whole h window locally;
// - GEMM 2 computes its output columns with the bias, residual and
//   accumulate epilogue.
// Columns are split, never the channel sum, and the sum's order is fixed by
// (tap, channel), so every (tile, cluster) plan gives the same bits. The host
// picks the plan (ops/vocoder_kernel.py::_unit_plan, whose shared-memory
// formula unit_smem_bytes equals dse_hifigan_unit_smem).
#include <cooperative_groups.h>

#include "tile_mma.cuh"

namespace cg = cooperative_groups;

namespace dse {

constexpr int kMaxUnitCluster = 8;

__host__ __device__ inline int round16(int n) { return (n + 15) / 16 * 16; }
// Row stride of the windows: c rounded up to 8 (zeros past c), plus 4 so
// that the 8 rows of an A fragment start in 8 different bank quads.
__host__ __device__ inline int unit_lda(int c) { return (c + 7) / 8 * 8 + 4; }
// Rows of the staged input window and of the h window for a tile of `tile` rows.
__host__ __device__ inline int unit_x_rows(int tile, int taps, int dil) {
  return round16(tile + taps - 1) + (taps - 1) * dil;
}
__host__ __device__ inline int unit_h_rows(int tile, int taps) {
  return round16(tile) + taps - 1;
}
inline int unit_nf(int nc) { return nc <= 8 ? 1 : nc <= 16 ? 2 : nc <= 32 ? 4 : 8; }
// Row fragments per warp: 2 once GEMM 1's window outgrows one chunk of 1.
inline int unit_wm(int tile, int taps, int nf) {
  return round16(tile + taps - 1) > 16 * (kWarps / (nf < 4 ? nf : 4)) ? 2 : 1;
}

template <int NF, int WM, typename WT>
__global__ void __launch_bounds__(kThreads, 1)
hifigan_unit_kernel(const float* __restrict__ cache1, long long c1_bs,
                    const float* __restrict__ cache2, long long c2_bs,
                    const float* __restrict__ x, const WT* __restrict__ w1,
                    const float* __restrict__ b1, const WT* __restrict__ w2,
                    const float* __restrict__ b2, const float* __restrict__ acc,
                    float out_scale, float* __restrict__ out,
                    float* __restrict__ new_cache2, int T, int c, int groups, int in_gstride,
                    int Cin, int taps, int dil, int tile, float slope) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n_blocks = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int nc = c / n_blocks;  // columns of the group this block computes
  const int col0 = rank * nc;
  const int lda = unit_lda(c), kp = lda - 4;
  WT* ring = reinterpret_cast<WT*>(smem);
  float* X = reinterpret_cast<float*>(smem + ring_bytes<NF, WT>());  // leaky input window
  float* H = X + (size_t)unit_x_rows(tile, taps, dil) * lda;  // h_ext rows [t0-k+1, t0+count)
  const int n_tiles = (T + tile - 1) / tile;
  const int cl = blockIdx.x / n_blocks;
  const int g = cl % groups;
  const int b = (cl / groups) / n_tiles;
  const int t0 = (cl / groups - b * n_tiles) * tile;
  const int count = min(tile, T - t0);
  const int ctx2 = taps - 1;
  const int P1 = (taps - 1) * dil;
  const int M1 = count + ctx2;  // h rows GEMM 1 computes
  const int gc = groups * c;
  const int n0 = g * c + col0;  // this block's first output column
  const int ch0 = g * in_gstride;
  const int hs = t0 - ctx2;  // h row of H's first row; rows < 0 come from cache2
  cache1 += (size_t)b * c1_bs;
  cache2 += (size_t)b * c2_bs;
  x += (size_t)b * T * Cin;
  out += (size_t)b * T * gc;
  if (acc) acc += (size_t)b * T * gc;

  // The input window: row i is x_ext1 row hs + i (zeros outside the stream
  // and in the channel padding), all c channels of the group.
  const int x_elems = (round16(M1) + P1) * kp;
  const bool x_vec = ((reinterpret_cast<uintptr_t>(cache1) | reinterpret_cast<uintptr_t>(x)) %
                          16 == 0 && c1_bs % 4 == 0 && Cin % 4 == 0 && ch0 % 4 == 0);
  for (int q = threadIdx.x * (x_vec ? 4 : 1); q < x_elems; q += kThreads * (x_vec ? 4 : 1)) {
    const int i = q / kp, ch = q - i * kp, e = hs + i;
    const bool ok = ch < c && e >= 0 && e < P1 + T;
    const float* src = !ok ? x
                       : e < P1 ? cache1 + (size_t)e * Cin + ch0 + ch
                                : x + (size_t)(e - P1) * Cin + ch0 + ch;
    if (x_vec)  // 4 channels at once: c is a multiple of 4
      cp_async<16>(X + i * lda + ch, src, ok ? 16 : 0);
    else
      cp_async<4>(X + i * lda + ch, src, ok ? 4 : 0);
  }
  cp_async_commit();
  if (kp != c)  // GEMM 2 reads h's channel padding: zeros
    for (int q = threadIdx.x; q < unit_h_rows(tile, taps) * (kp - c); q += kThreads)
      H[(q / (kp - c)) * lda + c + q % (kp - c)] = 0.f;

  mma_tap_gemm<NF, WM, WT>(
      M1, taps, dil, c, X, lda, w1 + n0, (long long)c * gc, gc, nc, ring,
      [&] {  // each thread activates the window elements it copied
        for (int q = threadIdx.x * (x_vec ? 4 : 1); q < x_elems;
             q += kThreads * (x_vec ? 4 : 1)) {
          float* v = X + (q / kp) * lda + q % kp;
          for (int u = 0; u < (x_vec ? 4 : 1); ++u) v[u] = leaky(v[u], slope);
        }
      },
      [&](int m, int n, float v) {
        const int tp = hs + m;
        H[m * lda + col0 + n] = tp >= 0 ? leaky(b1 ? v + b1[n0 + n] : v, slope)
                                        : cache2[(size_t)(tp + ctx2) * gc + n0 + n];
      });
  cluster.sync();  // every block's h columns are in its shared memory

  if (t0 + count == T) {  // the stream's last tile holds the next cache2
    float* nc2 = new_cache2 + (size_t)b * ctx2 * gc + n0;
    for (int e = threadIdx.x; e < ctx2 * nc; e += kThreads) {
      const int r = e / nc;
      nc2[(size_t)r * gc + e - r * nc] = H[(count + r) * lda + col0 + e - r * nc];
    }
  }
  const int vecs = nc / 4;  // float4 per row of a peer's slice
  for (int e = threadIdx.x; e < (n_blocks - 1) * M1 * vecs; e += kThreads) {
    const int p = e / (M1 * vecs), rest = e - p * M1 * vecs;
    const int peer = p < rank ? p : p + 1;
    const int m = rest / vecs, off = m * lda + peer * nc + (rest - m * vecs) * 4;
    const float* src = cluster.map_shared_rank(H, peer);
    *reinterpret_cast<float4*>(H + off) = *reinterpret_cast<const float4*>(src + off);
  }
  cluster.sync();  // the whole h window is local; no block reads a peer from here on

  mma_tap_gemm<NF, WM, WT>(
      count, taps, 1, c, H, lda, w2 + n0, (long long)c * gc, gc, nc, ring, [] {},
      [&](int m, int n, float v) {
        const int t = t0 + m;
        const float y = x[(size_t)t * Cin + ch0 + col0 + n] + (b2 ? v + b2[n0 + n] : v);
        const size_t o = (size_t)t * gc + n0 + n;
        out[o] = (acc ? acc[o] + y : y) * out_scale;
      });
}

template <int NF, int WM, typename WT>
cudaError_t launch(const float* cache1, long long c1_bs, const float* cache2, long long c2_bs,
                   const float* x, const void* w1, const float* b1, const void* w2,
                   const float* b2, const float* acc, float out_scale, float* out,
                   float* new_cache2, int B, int T, int c, int groups, int in_gstride, int Cin,
                   int taps, int dil, int tile, int cluster, float slope, size_t smem,
                   cudaStream_t stream) {
  static size_t configured = 0;
  auto kernel = hifigan_unit_kernel<NF, WM, WT>;
  cudaError_t err = allow_smem(kernel, smem, &configured);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * ((T + tile - 1) / tile) * groups * cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, cache1, c1_bs, cache2, c2_bs, x,
                           static_cast<const WT*>(w1), b1, static_cast<const WT*>(w2), b2, acc,
                           out_scale, out, new_cache2, T, c, groups, in_gstride, Cin, taps, dil,
                           tile, slope);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename WT>
cudaError_t launch_plan(int nf, int wm, const float* cache1, long long c1_bs, const float* cache2,
                        long long c2_bs, const float* x, const void* w1, const float* b1,
                        const void* w2, const float* b2, const float* acc, float out_scale,
                        float* out, float* new_cache2, int B, int T, int c, int groups,
                        int in_gstride, int Cin, int taps, int dil, int tile, int cluster,
                        float slope, size_t smem, cudaStream_t s) {
  auto go = [&](auto kernel_launch) {
    return kernel_launch(cache1, c1_bs, cache2, c2_bs, x, w1, b1, w2, b2, acc, out_scale, out,
                         new_cache2, B, T, c, groups, in_gstride, Cin, taps, dil, tile, cluster,
                         slope, smem, s);
  };
  switch (nf * 2 + wm - 1) {
    case 2: return go(launch<1, 1, WT>);
    case 3: return go(launch<1, 2, WT>);
    case 4: return go(launch<2, 1, WT>);
    case 5: return go(launch<2, 2, WT>);
    case 8: return go(launch<4, 1, WT>);
    case 9: return go(launch<4, 2, WT>);
    case 16: return go(launch<8, 1, WT>);
    default: return go(launch<8, 2, WT>);
  }
}

}  // namespace dse

// Shared memory one block needs for a tile of `tile` output rows when a
// cluster of `cluster` blocks splits the c columns of a group: the W ring,
// the input window and the h window.
extern "C" size_t dse_hifigan_unit_smem(int tile, int c, int taps, int dil, int cluster,
                                        int bf16) {
  const int nf = dse::unit_nf(c / cluster);
  const size_t ring = (size_t)dse::kStages * dse::kKC * (8 * nf + 8) * (bf16 ? 2 : 4);
  return ring + sizeof(float) * (size_t)dse::unit_lda(c) *
                    (dse::unit_x_rows(tile, taps, dil) + dse::unit_h_rows(tile, taps));
}

extern "C" int dse_hifigan_unit(const float* cache1, long long c1_bs, const float* cache2,
                                long long c2_bs, const float* x, const void* w1, const float* b1,
                                const void* w2, const float* b2, const float* acc,
                                float out_scale, float* out, float* new_cache2, int B, int T,
                                int c, int groups, int tiled, int taps, int dil, int tile,
                                int cluster, float slope, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || T <= 0 || c <= 0 || c % 4 != 0 || groups <= 0 || taps <= 1 || dil <= 0 ||
      tile <= 0 || cluster < 1 || cluster > dse::kMaxUnitCluster || c % cluster != 0 ||
      (c / cluster) % 4 != 0 || c / cluster > 64 ||
      (reinterpret_cast<uintptr_t>(w1) | reinterpret_cast<uintptr_t>(w2)) % 16 != 0 ||
      (long long)B * ((T + tile - 1) / tile) * groups * cluster > 0x7fffffffLL ||
      (long long)B * T * groups * c > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const size_t smem = dse_hifigan_unit_smem(tile, c, taps, dil, cluster, bf16);
  if (smem > 232448) return cudaErrorInvalidValue;
  const int in_gstride = tiled ? 0 : c;
  const int Cin = tiled ? c : groups * c;
  const int nf = dse::unit_nf(c / cluster);
  const int wm = dse::unit_wm(tile, taps, nf);
  if (bf16)
    return dse::launch_plan<__nv_bfloat16>(nf, wm, cache1, c1_bs, cache2, c2_bs, x, w1, b1, w2,
                                           b2, acc, out_scale, out, new_cache2, B, T, c, groups,
                                           in_gstride, Cin, taps, dil, tile, cluster, slope,
                                           smem, s);
  return dse::launch_plan<float>(nf, wm, cache1, c1_bs, cache2, c2_bs, x, w1, b1, w2, b2, acc,
                                 out_scale, out, new_cache2, B, T, c, groups, in_gstride, Cin,
                                 taps, dil, tile, cluster, slope, smem, s);
}
