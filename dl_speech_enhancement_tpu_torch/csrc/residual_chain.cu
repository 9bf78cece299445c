// residual_chain: three chained causal residual units, fused.
//
// Replaces the TPU kernel dl_speech_enhancement_tpu/ops/stream_kernel.py::
// fused_residual_chain (and the chain math inside ops/mega_kernel.py's
// enc_kernel / dec_kernel). Each unit is ELU -> k=7 causal conv at dilation
// d -> ELU -> 1x1 conv -> residual add, on a cache-prepended input:
//
//     x_ext = [cache (halo rows); x (T rows)],  halo = 6 * (d0 + d1 + d2)
//     h     = ELU( sum_j ELU(x_ext)[t + j*d] @ W1[u][j] )
//     x_ext = x_ext[6d:] + h @ W2[u]
//
// What bounds it: the operations. At the streaming shapes it does 48*C^2 f32
// multiply-adds per output row against 8*C bytes of activation traffic, far
// above the card's f32 balance point, and its weights (<= 2.4 MB per chain in
// f32) stay in L2 across blocks.
//
// B independent streams run in one launch: cache (B, halo, C) with stream
// stride `cache_bs` floats (rows contiguous, so a cache may be a view into the
// previous activation), x and out (B, T, C). Each stream's halo comes from its
// own cache and no window crosses a stream: a tile never spans two streams.
//
// Design: one thread-block cluster per (stream, output time tile). The tile
// plus its halo is loaded once into shared memory and the three units run there, each
// as two block GEMMs (tile_gemm.cuh) after one pass that writes E = ELU(X);
// the residual stream X, E and the conv output H never leave shared memory,
// and only the tile's final rows are written back. The halo is recomputed by
// neighbouring tiles, so tiles should be long, but at C=256 the halo alone is
// 78 KB in f32. So the cluster's blocks split the channels: block r keeps
// channels [r*C/n, (r+1)*C/n) of X, E and H, computes those output columns,
// and reads the other blocks' channel
// slices of the A operand through distributed shared memory. That divides
// each block's shared memory by the cluster size (longer tiles, less halo
// recompute) and spreads one tile over up to 8 SMs (the real-time path has
// only 20 rows at C=256). The host picks the tile and cluster size
// (ops/stream_kernel.py::_chain_plan).
#include <cooperative_groups.h>

#include "tile_gemm.cuh"

namespace cg = cooperative_groups;

namespace dse {

constexpr int kTaps = 7;
constexpr int kMaxCluster = 8;

template <int BN, typename WT>
__global__ void __launch_bounds__(kThreads)
residual_chain_kernel(const float* __restrict__ cache, const float* __restrict__ x,
                      const WT* __restrict__ w1, const WT* __restrict__ w2,
                      float* __restrict__ out, long long cache_bs, int T, int C, int d0,
                      int d1, int d2, int tile) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n_blocks = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int nc = C / n_blocks;  // channels this block keeps and computes
  const int c_base = rank * nc;
  const int dil[3] = {d0, d1, d2};
  const int halo = (kTaps - 1) * (d0 + d1 + d2);
  const int n_tiles = (T + tile - 1) / tile;
  const int b = (blockIdx.x / n_blocks) / n_tiles;  // this cluster's stream
  const int t0 = (blockIdx.x / n_blocks - b * n_tiles) * tile;
  cache += (size_t)b * cache_bs;
  x += (size_t)b * T * C;
  out += (size_t)b * T * C;
  const int count = min(tile, T - t0);
  const int rows = count + halo;
  float* stage = smem;
  float* X = smem + Tile<BN>::kSmemFloats;    // residual stream, (tile + halo) x nc
  float* E = X + (tile + halo) * nc;          // ELU(X) of the current unit, same shape
  float* H = E + (tile + halo) * nc;          // ELU(conv1 output), (tile + halo - 6*d0) x nc

  for (int e = threadIdx.x; e < rows * nc; e += kThreads) {
    const int r = e / nc, c = c_base + e - r * nc;
    const int g = t0 + r;
    X[e] = g < halo ? cache[(size_t)g * C + c] : x[(size_t)(g - halo) * C + c];
  }

  int off = 0, R = rows;
  for (int u = 0; u < 3; ++u) {
    const int d = dil[u], pad = (kTaps - 1) * d, M = R - pad;
    const WT* w1u = w1 + (size_t)u * kTaps * C * C;
    const WT* w2u = w2 + (size_t)u * C * C;
    for (int e = threadIdx.x; e < R * nc; e += kThreads) E[e] = elu(X[off * nc + e]);
    cluster.sync();  // every block's E slice is complete; H is no longer read
    tile_gemm<BN, WT>(
        0, M, c_base, nc, kTaps, C, C, stage,
        [&](int m, int j, int c0, int kk) {
          const int owner = c0 / nc;
          const float* src = cluster.map_shared_rank(E, owner);
          return src[(m + j * d) * nc + (c0 - owner * nc) + kk];
        },
        [&](int j) { return w1u + (size_t)j * C * C; },
        [&](int m, int n, float v) { H[m * nc + (n - c_base)] = elu(v); });
    cluster.sync();  // every block's H slice is complete; E is no longer read
    tile_gemm<BN, WT>(
        0, M, c_base, nc, 1, C, C, stage,
        [&](int m, int, int c0, int kk) {
          const int owner = c0 / nc;
          const float* src = cluster.map_shared_rank(H, owner);
          return src[m * nc + (c0 - owner * nc) + kk];
        },
        [&](int) { return w2u; },
        [&](int m, int n, float v) { X[(off + pad + m) * nc + (n - c_base)] += v; });
    off += pad;
    R = M;
  }

  for (int e = threadIdx.x; e < count * nc; e += kThreads) {
    const int r = e / nc, c = e - r * nc;
    out[(size_t)(t0 + r) * C + c_base + c] = X[(halo + r) * nc + c];
  }
  cluster.sync();  // no block leaves while another may read its H
}

template <int BN, typename WT>
cudaError_t launch(const float* cache, long long cache_bs, const float* x, const void* w1,
                   const void* w2, float* out, int B, int T, int C, int d0, int d1, int d2,
                   int tile, int cluster, size_t smem, cudaStream_t stream) {
  static size_t configured = 0;
  auto kernel = residual_chain_kernel<BN, WT>;
  cudaError_t err = allow_smem(kernel, smem, &configured);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * ((T + tile - 1) / tile) * cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, cache, x, static_cast<const WT*>(w1),
                           static_cast<const WT*>(w2), out, cache_bs, T, C, d0, d1, d2, tile);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace dse

// Shared memory one block needs for a tile of `tile` output rows when a
// cluster of `cluster` blocks splits the C channels.
extern "C" size_t dse_residual_chain_smem(int tile, int C, int cluster, int d0, int d1,
                                          int d2) {
  const int nc = C / cluster;
  const int halo = (dse::kTaps - 1) * (d0 + d1 + d2);
  const size_t rows = 2 * (size_t)(tile + halo) + (size_t)(tile + halo - (dse::kTaps - 1) * d0);
  return dse::tile_smem_bytes(dse::tile_bn(nc)) + rows * nc * sizeof(float);
}

// Rows of one block GEMM tile when a block computes C / cluster columns.
extern "C" int dse_residual_chain_block_rows(int C, int cluster) {
  return dse::tile_bm(dse::tile_bn(C / cluster));
}

extern "C" int dse_residual_chain(const float* cache, long long cache_bs, const float* x,
                                  const void* w1, const void* w2, float* out, int B, int T,
                                  int C, int d0, int d1, int d2, int tile, int cluster, int bf16,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || T <= 0 || tile <= 0 || C <= 0 || cluster < 1 || cluster > dse::kMaxCluster ||
      C % cluster != 0 || (cluster > 1 && (C / cluster) % dse::kBK != 0) ||
      (long long)B * ((T + tile - 1) / tile) * cluster > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const size_t smem = dse_residual_chain_smem(tile, C, cluster, d0, d1, d2);
  if (smem > 232448) return cudaErrorInvalidValue;
  const bool narrow = dse::tile_bn(C / cluster) == 32;
  if (bf16)
    return narrow ? dse::launch<32, __nv_bfloat16>(cache, cache_bs, x, w1, w2, out, B, T, C, d0,
                                                   d1, d2, tile, cluster, smem, s)
                  : dse::launch<64, __nv_bfloat16>(cache, cache_bs, x, w1, w2, out, B, T, C, d0,
                                                   d1, d2, tile, cluster, smem, s);
  return narrow ? dse::launch<32, float>(cache, cache_bs, x, w1, w2, out, B, T, C, d0, d1, d2,
                                         tile, cluster, smem, s)
                : dse::launch<64, float>(cache, cache_bs, x, w1, w2, out, B, T, C, d0, d1, d2,
                                         tile, cluster, smem, s);
}
