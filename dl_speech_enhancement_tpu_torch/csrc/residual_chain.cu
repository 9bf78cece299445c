// residual_chain: three chained causal residual units, fused.
//
// Replaces the TPU kernel dl_speech_enhancement_tpu/ops/stream_kernel.py::
// fused_residual_chain (and the chain math inside ops/mega_kernel.py's
// enc_kernel / dec_kernel and their batched forms). Each unit is ELU -> k=7
// causal conv at dilation d -> ELU -> 1x1 conv -> residual add, on a
// cache-prepended input:
//
//     x_ext = [cache (halo rows); x (T rows)],  halo = 6 * (d0 + d1 + d2)
//     h     = ELU( sum_j ELU(x_ext)[t + j*d] @ W1[u][j] )
//     x_ext = x_ext[6d:] + h @ W2[u]
//
// B independent streams run in one launch: cache (B, halo, C) with stream
// stride `cache_bs` floats (rows contiguous, so a cache may be a view into the
// previous activation), x and out (B, T, C). Each stream's halo comes from its
// own cache and no window crosses a stream: a tile never spans two streams.
// x and out are f32 or bf16 (AT, the streams' boundary dtype: bf16 halves the
// activations' traffic between launches; ops/mega_stacked.py): the kernel
// widens x to f32 as it loads it (bf16 rows staged by cp.async, then widened)
// and rounds only the rows it writes, so every sum is the f32 arm's on the
// same values. The cache stays f32.
//
// Weights are f32 or bf16 (WT). With bf16 weights the reference multiplies
// bf16 by bf16: it rounds E = ELU(X) before conv1 and ELU(conv1) before conv2
// to bf16 (JAX ops/stream_kernel.py:78,84), and so does this kernel, whose
// windows, scratch and H slice then hold bf16 (half the f32 arm's bytes) and
// whose products are bf16 `mma.sync.m16n8k16` (tile_mma.cuh). The residual
// stream X, the sums and the output stay f32.
//
// What bounds it on an H100: at many rows the operations, 48*C^2 multiply-adds
// per output row (plus the halo rows a tile recomputes) against 8*C bytes of
// activation traffic, at the tensor-core rate of its arm (bf16, or split
// TF32 with f32 weights); its weights (<= 3.1 MB a chain in bf16) stay in
// L2. At one frame a dispatch (20 rows a stream at C = 256, 100 at C = 128)
// the grid holds a few blocks, and the time is each block's serial chain of
// tensor-core steps, barriers and L2 reads: measured on the card, a step is
// bound by the instructions a warp issues (operand loads, the operand split,
// the mma), not by the weights' latency.
//
// Design: one thread-block cluster of n = 1, 2, 4, 8 or 16 blocks per
// (stream, output time tile); block r owns output channels [r*C/n,
// (r+1)*C/n), at most 64. The tile plus its halo is loaded once; the residual
// stream X (the block's own channels) never leaves shared memory across the
// three units, and only the tile's final rows are written back. Per unit:
// - each block writes E = ELU(X) of its channels into the cluster's scratch
//   in device memory, arrives at a cluster barrier, and, once its first
//   weight tiles are in flight, waits there and fills a local full-width
//   window of E from the scratch with cp.async through L2 (reading the
//   peers' shared memory through distributed shared memory instead measured
//   several times slower);
// - conv1 (7 taps) computes its channels of H = ELU(conv) from that window
//   and writes them to the scratch;
// - after the second barrier it fills the window with H the same way, and
//   conv2 (1x1) adds its channels into X.
// With one block the window is filled from the block's own X and H. No
// product reads a peer: both GEMMs take A from the local window.
// The GEMMs are tile_mma.cuh's mma_tap_gemm with the warps along the rows
// (each warp loads an A fragment once for all its columns): bf16
// `mma.sync.m16n8k16` with bf16 weights, split-TF32 `mma.sync.m16n8k8` (3
// passes) with f32, weights through a 4-stage `cp.async` ring of (tap,
// 64-channel) tiles, the reduction cut into (tap, 64-channel) chunks (one
// tap's C channels at C < 64) whose values are folded into the f32 running
// sum in chunk order. A chunk's cut and the fold's order depend on C alone,
// so every output element is the same sequence of f32 operations whatever
// the plan (tile, cluster), B or T; the warp tiling (16-row fragments a warp, picked per
// GEMM from its rows) only says which warp computes which rows. The halo is
// recomputed by neighbouring tiles, so tiles should be long, but the
// full-width window takes ~4*(tile + 92)*C bytes (2* with bf16 weights);
// the host weighs the two (ops/stream_kernel.py::_chain_plan, pure Python;
// its chain_smem_bytes equals dse_residual_chain_smem, its
// chain_scratch_floats dse_residual_chain_scratch).
#include <cooperative_groups.h>

#include <type_traits>

#include "async_copy.cuh"
#include "tile_mma.cuh"

namespace cg = cooperative_groups;

namespace dse {
// Internal linkage: the launchers' static state stays this library's when
// another build of the file is loaded in the same process
// (tools/chain_timing.py --parent).
namespace {

constexpr int kTaps = 7;
constexpr int kMaxChainCluster = 16;
constexpr int kMaxChainCols = 64;  // output channels a block computes at most

__host__ __device__ inline int chain_round16(int n) { return (n + 15) / 16 * 16; }
// Row stride of the A window: f32, C rounded up to 8 (zeros past C), plus 4
// so that the 8 rows of an A fragment start in 8 different bank quads; bf16,
// C rounded up to 16, plus 8, so that the 8 16-byte rows of an ldmatrix
// matrix fall in 8 different bank quads.
__host__ __device__ inline int chain_lda(int C, int bf16) {
  return bf16 ? (C + 15) / 16 * 16 + 8 : (C + 7) / 8 * 8 + 4;
}
inline int chain_nf(int nc) { return nc <= 8 ? 1 : nc <= 16 ? 2 : nc <= 32 ? 4 : 8; }

// Rows of the A window for a tile of `tile` output rows: unit u's conv1
// reads its output rows rounded up to 16 plus its reach, 6 * d_u.
__host__ __device__ inline int chain_window_rows(int tile, int d0, int d1, int d2) {
  const int dil[3] = {d0, d1, d2};
  int R = tile + (kTaps - 1) * (d0 + d1 + d2), rows = 0;
  for (int u = 0; u < 3; ++u) {
    const int pad = (kTaps - 1) * dil[u], need = chain_round16(R - pad) + pad;
    rows = need > rows ? need : rows;
    R -= pad;
  }
  return rows;
}

// Shared memory of one block: the W ring, the block's f32 X slice (tile +
// halo rows), the A window and its H slice (the first unit's conv1 rows),
// the last two in the weights' type.
inline size_t chain_smem(int tile, int C, int cluster, int d0, int d1, int d2, int bf16) {
  const int nc = C / cluster;
  const int halo = (kTaps - 1) * (d0 + d1 + d2);
  const size_t e = bf16 ? 2 : 4;  // bytes of a window element
  const size_t ring = (size_t)kStages * kKC * (8 * chain_nf(nc) + 8) * e;
  const size_t x = sizeof(float) * (size_t)(tile + halo) * nc;
  const size_t h = e * (size_t)(tile + halo - (kTaps - 1) * d0) * nc;
  return ring + x + h + e * (size_t)chain_window_rows(tile, d0, d1, d2) * chain_lda(C, bf16);
}

// Elements of one cluster's scratch (in the weights' type): the E rows of a
// tile (tile + halo) and its H rows (the first unit's conv1 rows), C each.
__host__ __device__ inline size_t chain_scratch_elems(int tile, int C, int d0, int d1, int d2) {
  const int halo = (kTaps - 1) * (d0 + d1 + d2);
  return (size_t)(2 * (tile + halo) - (kTaps - 1) * d0) * C;
}

// Copies 16 bytes from global memory to shared memory through L2 only, so
// that no stale L1 line of an earlier unit's scratch is read.
__device__ __forceinline__ void cp_async_l2(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

// Four consecutive elements of a slice: 16 bytes of f32, 8 of bf16.
template <typename E>
using Quad = std::conditional_t<sizeof(E) == 4, float4, uint2>;

// Writes ELU(X) rows [row0, row0 + rows) of this block's f32 slice `src` (nc
// a row) into columns [col0, col0 + nc) of `dst` (row stride ld), rounded to
// E: the cluster's scratch in device memory, or, for a cluster of one
// block, the A window itself.
template <typename E>
__device__ __forceinline__ void publish_elu(E* dst, int ld, int col0, const float* src, int row0,
                                            int rows, int nc) {
  for (int q = threadIdx.x * 4; q < rows * nc; q += kThreads * 4) {
    const int r = q / nc, c = q - r * nc;
    const float4 t = *reinterpret_cast<const float4*>(src + (size_t)row0 * nc + q);
    store4(dst + (size_t)r * ld + col0 + c, make_float4(elu(t.x), elu(t.y), elu(t.z), elu(t.w)));
  }
}

// Copies rows [0, rows) of this block's H slice (nc a row) into columns
// [0, nc) of the A window (a cluster of one block).
template <typename E>
__device__ __forceinline__ void publish_h(E* dst, int ld, const E* src, int rows, int nc) {
  for (int q = threadIdx.x * 4; q < rows * nc; q += kThreads * 4) {
    const int r = q / nc, c = q - r * nc;
    *reinterpret_cast<Quad<E>*>(dst + (size_t)r * ld + c) =
        *reinterpret_cast<const Quad<E>*>(src + q);
  }
}

// Fills rows [0, rows) of the A window from the cluster's scratch (rows of
// C elements), every copy in flight at once, and waits for them and for the
// weight tiles committed before. Rows of 16-byte multiples go by cp.async
// through L2; bf16 rows of C % 8 = 4 by 8-byte loads that bypass L1.
template <typename E>
__device__ __forceinline__ void fetch(E* A, int lda, const E* scratch, int rows, int C) {
  if (C * sizeof(E) % 16 == 0) {
    constexpr int kPer = 16 / sizeof(E);
    const int per_row = C / kPer;
    for (int q = threadIdx.x; q < rows * per_row; q += kThreads) {
      const int r = q / per_row, c = (q - r * per_row) * kPer;
      cp_async_l2(A + (size_t)r * lda + c, scratch + (size_t)r * C + c);
    }
  } else {
    const int per_row = C / 4;
    for (int q = threadIdx.x; q < rows * per_row; q += kThreads) {
      const int r = q / per_row, c = (q - r * per_row) * 4;
      *reinterpret_cast<uint2*>(A + (size_t)r * lda + c) =
          __ldcg(reinterpret_cast<const uint2*>(scratch + (size_t)r * C + c));
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
}

// One conv of a unit on the tensor cores: mma_tap_gemm with the warps along
// the rows first, each holding all of the block's columns (half of them at
// 64 columns), and as many 16-row fragments a warp (1, 2 or 4) as cover the
// M rows in one pass where its registers allow: at most 4 fragments in all
// with split TF32 (its chains'), 8 with bf16, whose chains are half as many.
// A step's barrier is then paid for more rows. That only says which warp
// computes which rows.
template <int NF, typename WT, typename E, typename Epi, typename Prologue>
__device__ __forceinline__ void chain_gemm(int M, int taps, int d, int C, const E* A,
                                           int lda, const WT* w, long long w_tap, int nc,
                                           WT* ring, Epi epi, Prologue prologue) {
  using T = MmaTile<NF, 1, true>;
  constexpr int kMaxFrags = sizeof(E) == 2 ? 8 : 4;
  const int per_warp = ((M + 15) / 16 + T::kWarpsM - 1) / T::kWarpsM;
  auto none = [] {};
  if (per_warp <= 1 || 2 * T::kWN > kMaxFrags) {
    mma_tap_gemm<NF, 1, WT, true>(M, taps, d, C, A, lda, w, w_tap, C, nc, ring, none, epi,
                                  prologue);
  } else if (per_warp <= 2 || 4 * T::kWN > kMaxFrags) {
    if constexpr (2 * T::kWN <= kMaxFrags)
      mma_tap_gemm<NF, 2, WT, true>(M, taps, d, C, A, lda, w, w_tap, C, nc, ring, none, epi,
                                    prologue);
  } else {
    if constexpr (4 * T::kWN <= kMaxFrags)
      mma_tap_gemm<NF, 4, WT, true>(M, taps, d, C, A, lda, w, w_tap, C, nc, ring, none, epi,
                                    prologue);
  }
}

template <int NF, typename WT, typename AT>
__global__ void __launch_bounds__(kThreads, 1)
residual_chain_kernel(const float* __restrict__ cache, long long cache_bs,
                      const AT* __restrict__ x, const WT* __restrict__ w1,
                      const WT* __restrict__ w2, AT* __restrict__ out,
                      WT* __restrict__ scratch, int T, int C, int d0, int d1, int d2,
                      int tile) {
  using E = WT;  // the windows' type: what the products multiply
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_blocks = (int)cg::this_cluster().num_blocks();
  const int rank = (int)cg::this_cluster().block_rank();
  const bool shared = n_blocks > 1;  // the window is built from the cluster's scratch
  const int nc = C / n_blocks;       // channels this block keeps and computes
  const int c_base = rank * nc;
  constexpr int kBf16 = sizeof(E) == 2;
  const int lda = chain_lda(C, kBf16);
  const int dil[3] = {d0, d1, d2};
  const int halo = (kTaps - 1) * (d0 + d1 + d2);
  const int n_tiles = (T + tile - 1) / tile;
  const int cl = blockIdx.x / n_blocks;
  const int b = cl / n_tiles;  // this cluster's stream
  const int t0 = (cl - b * n_tiles) * tile;
  cache += (size_t)b * cache_bs;
  x += (size_t)b * T * C;
  out += (size_t)b * T * C;
  const int count = min(tile, T - t0);
  const int rows = count + halo;
  const int window_rows = chain_window_rows(tile, d0, d1, d2);
  WT* ring = reinterpret_cast<WT*>(smem);
  float* X = reinterpret_cast<float*>(smem + ring_bytes<NF, WT>());  // (tile + halo) x nc
  E* A = reinterpret_cast<E*>(X + (size_t)(tile + halo) * nc);  // window, rows x lda
  E* H = A + (size_t)window_rows * lda;  // conv1's output slice, M x nc (one block)
  // this cluster's scratch: E rows (tile + halo), then H rows, C elements each
  E* sE = shared ? scratch + (size_t)cl * chain_scratch_elems(tile, C, d0, d1, d2) : nullptr;
  E* sH = shared ? sE + (size_t)(tile + halo) * C : nullptr;

  // X: rows t0 .. t0 + rows of this stream's x_ext, this block's channels:
  // the f32 cache rows and f32 x rows by cp.async into X, bf16 x rows by
  // cp.async into the (not yet used) A window, widened into X after.
  const bool vec = reinterpret_cast<uintptr_t>(cache) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % (4 * sizeof(AT)) == 0 && cache_bs % 4 == 0;
  AT* stage = reinterpret_cast<AT*>(A);  // bf16 x: row r of the slice at r * nc
  for (int q = threadIdx.x * 4; q < rows * nc; q += kThreads * 4) {
    const int r = q / nc, c = c_base + q - r * nc, g = t0 + r;
    if (sizeof(AT) == 2 && g >= halo) {
      const AT* src = x + (size_t)(g - halo) * C + c;
      if (vec) {
        cp_async<8>(stage + q, src, 8);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) X[q + u] = to_f(src[u]);
      }
      continue;
    }
    const float* src = g < halo ? cache + (size_t)g * C + c
                                : reinterpret_cast<const float*>(x) + (size_t)(g - halo) * C + c;
    if (vec) {
      cp_async<16>(X + q, src, 16);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) cp_async<4>(X + q + u, src + u, 4);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (sizeof(AT) == 2 && vec) {  // widen the staged bf16 rows (each thread its own)
    for (int q = max(halo - t0, 0) * nc + threadIdx.x * 4; q < rows * nc; q += kThreads * 4)
      *reinterpret_cast<float4*>(X + q) = load4(stage + q);
    __syncthreads();  // the A window is free again
  }
  const int kp = lda - (kBf16 ? 8 : 4);
  if (kp != C)  // the window's channel padding stays zero: it adds nothing
    for (int q = threadIdx.x; q < window_rows * (kp - C); q += kThreads)
      A[(q / (kp - C)) * lda + C + q % (kp - C)] = E(0.f);

  int off = 0, R = rows;
  for (int u = 0; u < 3; ++u) {
    const int d = dil[u], pad = (kTaps - 1) * d, M = R - pad;
    if (shared) publish_elu(sE, C, c_base, X, off, R, nc);
    cluster_arrive();  // E is published; this block reads the H scratch no more
    chain_gemm<NF, WT>(
        M, kTaps, d, C, A, lda, w1 + (size_t)u * kTaps * C * C + c_base, (long long)C * C, nc,
        ring,
        [&](int m, int n, float v) {
          if (shared)
            sH[(size_t)m * C + c_base + n] = from_f<E>(elu(v));
          else
            H[m * nc + n] = from_f<E>(elu(v));
        },
        [&] {
          cluster_wait();
          if (shared)
            fetch(A, lda, sE, R, C);
          else
            publish_elu(A, lda, 0, X, off, R, nc);
        });
    cluster_arrive();  // H is published; this block reads the E scratch no more
    chain_gemm<NF, WT>(
        M, 1, 0, C, A, lda, w2 + (size_t)u * C * C + c_base, 0, nc, ring,
        [&](int m, int n, float v) { X[(off + pad + m) * nc + n] += v; },
        [&] {
          cluster_wait();
          if (shared)
            fetch(A, lda, sH, M, C);
          else
            publish_h(A, lda, H, M, nc);
        });
    off += pad;
    R = M;
  }

  for (int q = threadIdx.x * 4; q < count * nc; q += kThreads * 4) {
    const int r = q / nc, c = q - r * nc;
    store4(out + (size_t)(t0 + r) * C + c_base + c,
           *reinterpret_cast<const float4*>(X + (size_t)(halo + r) * nc + c));
  }
}

template <int NF, typename WT, typename AT>
cudaError_t launch(const float* cache, long long cache_bs, const void* x, const void* w1,
                   const void* w2, void* out, float* scratch, int B, int T, int C, int d0,
                   int d1, int d2, int tile, int cluster, size_t smem, cudaStream_t stream) {
  static size_t configured[kMaxDevices] = {};
  static bool wide[kMaxDevices] = {};  // clusters above 8 blocks allowed
  auto kernel = residual_chain_kernel<NF, WT, AT>;
  cudaError_t err = allow_smem(kernel, smem, configured);
  if (err != cudaSuccess) return err;
  if (cluster > 8) {
    err = allow_wide_clusters(kernel, wide);
    if (err != cudaSuccess) return err;
  }
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
  err = cudaLaunchKernelEx(&cfg, kernel, cache, cache_bs, static_cast<const AT*>(x),
                           static_cast<const WT*>(w1), static_cast<const WT*>(w2),
                           static_cast<AT*>(out), reinterpret_cast<WT*>(scratch), T, C, d0, d1,
                           d2, tile);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename WT, typename AT>
cudaError_t launch_nf(int nf, const float* cache, long long cache_bs, const void* x,
                      const void* w1, const void* w2, void* out, float* scratch, int B, int T,
                      int C, int d0, int d1, int d2, int tile, int cluster, size_t smem,
                      cudaStream_t s) {
  auto go = [&](auto kernel_launch) {
    return kernel_launch(cache, cache_bs, x, w1, w2, out, scratch, B, T, C, d0, d1, d2, tile,
                         cluster, smem, s);
  };
  switch (nf) {
    case 1: return go(launch<1, WT, AT>);
    case 2: return go(launch<2, WT, AT>);
    case 4: return go(launch<4, WT, AT>);
    default: return go(launch<8, WT, AT>);
  }
}

template <typename WT>
cudaError_t launch_act(int act_bf16, int nf, const float* cache, long long cache_bs,
                       const void* x, const void* w1, const void* w2, void* out, float* scratch,
                       int B, int T, int C, int d0, int d1, int d2, int tile, int cluster,
                       size_t smem, cudaStream_t s) {
  if (act_bf16)
    return launch_nf<WT, __nv_bfloat16>(nf, cache, cache_bs, x, w1, w2, out, scratch, B, T, C,
                                        d0, d1, d2, tile, cluster, smem, s);
  return launch_nf<WT, float>(nf, cache, cache_bs, x, w1, w2, out, scratch, B, T, C, d0, d1,
                              d2, tile, cluster, smem, s);
}

}  // namespace
}  // namespace dse

// Shared memory one block needs for a tile of `tile` output rows when a
// cluster of `cluster` blocks splits the C channels, with bf16 (1) or f32
// (0) weights: the W ring, the block's X slice, the A window and the H
// slice (the last two bf16 with bf16 weights).
extern "C" size_t dse_residual_chain_smem(int tile, int C, int cluster, int d0, int d1, int d2,
                                          int bf16) {
  return dse::chain_smem(tile, C, cluster, d0, d1, d2, bf16);
}

// Floats of scratch in device memory one cluster takes, with bf16 (1) or f32
// (0) weights (the scratch then holds bf16 or f32): none for a cluster of
// one block.
extern "C" size_t dse_residual_chain_scratch(int tile, int C, int cluster, int d0, int d1,
                                             int d2, int bf16) {
  return cluster > 1 ? dse::chain_scratch_elems(tile, C, d0, d1, d2) / (bf16 ? 2 : 1) : 0;
}

// `scratch` holds dse_residual_chain_scratch floats for each of the
// B * ceil(T / tile) clusters (may be null for a cluster of one block).
// `types`: bit 0 bf16 weights (else f32), bit 1 bf16 x and out (else f32).
extern "C" int dse_residual_chain(const float* cache, long long cache_bs, const void* x,
                                  const void* w1, const void* w2, void* out, float* scratch,
                                  int B, int T, int C, int d0, int d1, int d2, int tile,
                                  int cluster, int types, void* stream) {
  const int bf16 = types & 1, act_bf16 = (types >> 1) & 1;
  if (types & ~3) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || T <= 0 || tile <= 0 || C <= 0 || C % 4 != 0 || d0 <= 0 || d1 <= 0 || d2 <= 0 ||
      cluster < 1 || cluster > dse::kMaxChainCluster || (cluster & (cluster - 1)) != 0 ||
      C % cluster != 0 || (C / cluster) % 4 != 0 || C / cluster > dse::kMaxChainCols ||
      (cluster > 1 && scratch == nullptr) ||
      (reinterpret_cast<uintptr_t>(w1) | reinterpret_cast<uintptr_t>(w2) |
       reinterpret_cast<uintptr_t>(out) | reinterpret_cast<uintptr_t>(scratch)) % 16 != 0 ||
      (long long)B * ((T + tile - 1) / tile) * cluster > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const size_t smem = dse_residual_chain_smem(tile, C, cluster, d0, d1, d2, bf16);
  if (smem > 232448) return cudaErrorInvalidValue;
  const int nf = dse::chain_nf(C / cluster);
  if (bf16)
    return dse::launch_act<__nv_bfloat16>(act_bf16, nf, cache, cache_bs, x, w1, w2, out,
                                          scratch, B, T, C, d0, d1, d2, tile, cluster, smem, s);
  return dse::launch_act<float>(act_bf16, nf, cache, cache_bs, x, w1, w2, out, scratch, B, T, C,
                                d0, d1, d2, tile, cluster, smem, s);
}
