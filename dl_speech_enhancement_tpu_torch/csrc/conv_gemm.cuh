// The GEMM arm of causal_conv.cu, shared with causal_conv_transpose.cu.
//
//     out[row(m)][n] = b[n] + sum_{g < taps*Cin} A[m][g] * W_p[g][n],
//     A[m][j*Cin + c] = x_ext[s*t + j*d][c] of row m's stream, time t
//
// causal_conv (phases = 1): W_0 is the (taps*Cin, Cout) weight and row(m) =
// m. causal_conv_transpose (phases = its stride s, a 2-tap, stride 1,
// dilation 1 conv over a one-row cache): phase p = blockIdx.y reads the tap
// pair (Wc[s-1-p], Wc[2s-1-p]) of the conv-ready (2s, Cin, Cout) weight,
// tap 1 lying s taps after tap 0, and writes row(m) = s*m + p, so the
// phases are stored interleaved in place.
//
// Products are split-TF32 `mma.sync.m16n8k8` (tile_mma.cuh's split_tf32:
// a_hi*w + a_lo*w with bf16 weights, which TF32 holds exactly; a_hi*w_hi +
// a_lo*w_hi + a_hi*w_lo with f32 weights). The reduction's taps*Cin terms,
// in (tap, channel) order, are cut into fixed chunks of 64 (one step each),
// so the cut depends on (taps, Cin) alone. The tensor core's own sum inside
// an mma is not specified to round to nearest, so a step sums its 8-term
// slices into fresh fragments (the passes in the order above), and the
// step's value is folded into the f32 running sum with a round-to-nearest
// add, in step order. A block computes a BM x BN output tile over rows that
// may span streams: each row's (stream, time) is worked out once, and every
// step stages that row's terms, of its own stream, through cp.async into a
// ring of kConvStages (A, W) tiles. At few rows (one frame: 4-20 rows a
// stream at the deep sites) the blocks of one thread-block cluster take
// consecutive runs of the steps (`steps_per_block`, the plan's only say in
// the sum): block 0 keeps the running sum of its run, the others each
// step's value, in shared memory, and after cluster.sync() every block folds
// a share of the tile through distributed shared memory in step order. So
// every output element is the same sequence of f32 adds whatever the plan,
// B or T, and a stream's bits depend on the layer alone.
//
// With `act` = 1 every staged element of [cache; x] is passed through
// LeakyReLU(`slope`), so a layer's cache stays the tail of its raw input;
// with `tanh_out` the epilogue writes tanh(y).
//
// x is f32 or bf16 (XT) and out f32 or bf16 (YT): the streams' boundary
// dtype (ops/mega_stacked.py). The cache stays f32. bf16 rows of x are widened
// to f32 by the threads' own 8-byte loads as they are staged (cp.async copies
// bytes and cannot widen), so the A tile and every sum are the f32 arm's on
// the same values; the epilogue rounds what it stores.
#pragma once

#include <cooperative_groups.h>

#include <algorithm>

#include "tile_mma.cuh"

namespace cg = cooperative_groups;

namespace dse {
// Internal linkage: the launchers' static state (the shared memory each
// kernel was allowed) stays this library's when another build of the file
// is loaded in the same process (tools/conv_timing.py --variant, --parent).
namespace {

constexpr int kConvStages = 3;   // (A, W) ring depth of the GEMM arm
constexpr int kConvLda = kKC + 4;  // A row stride: 8 fragment rows hit 8 bank quads
constexpr int kMaxConvCluster = 8;
// The source of the A tile's zero fill (cp.async of 0 bytes reads nothing).
__device__ __align__(16) float kConvZeros[4];

struct ConvArgs {
  const float* cache;
  long long cache_bs;
  const void* x;    // XT
  const void* w;
  const float* bias;
  void* out;        // YT
  int M, T_out, Cin, Cout, taps, stride, dil, act, tanh_out;
  float slope;
  int phases = 1;  // a transposed conv's stride: its phases, on grid.y
};

__device__ __forceinline__ float conv_out(const ConvArgs& a, int n, float v) {
  const float y = a.bias ? v + a.bias[n] : v;
  return a.tanh_out ? tanhf(y) : y;
}

// Blocks an SM that a 256-thread tile is compiled for (registers a thread at
// most 65536 / (256 * this)); tools/conv_timing.py --variant builds others.
#ifndef DSE_CONV_MIN_BLOCKS_256
#define DSE_CONV_MIN_BLOCKS_256 2
#endif

// WMW x WNW warps, each FM 16-row by FN 8-column fragments: the block tile
// is BM = 16*FM*WMW rows by BN = 8*FN*WNW columns.
template <int WMW, int WNW, int FM, int FN>
struct ConvTile {
  static constexpr int kThreads = 32 * WMW * WNW;
  static constexpr int BM = 16 * FM * WMW;
  static constexpr int BN = 8 * FN * WNW;
  static constexpr int LDW = BN + 8;  // padded W row: B fragments hit distinct banks
  // Two 256-thread blocks an SM (at most 128 registers a thread): a step is
  // mostly latency, which a second block's warps hide.
  static constexpr int kMinBlocks = kThreads == 256 ? DSE_CONV_MIN_BLOCKS_256 : 1;
};

// The tiles the planner may pick, by index (ops/mega_kernel.py::_CONV_TILES).
#define DSE_CONV_TILES(X) \
  X(0, 1, 2, 1, 1)        \
  X(1, 1, 4, 1, 1)        \
  X(2, 2, 4, 1, 2)        \
  X(3, 2, 4, 2, 2)        \
  X(4, 4, 2, 1, 2)        \
  X(5, 8, 1, 1, 4)
constexpr int kConvTiles = 6;

__host__ __device__ inline void conv_tile_dims(int tile, int* bm, int* bn, int* threads) {
  int wm = 1, wn = 2, fm = 1, fn = 1;
#define DSE_DIMS(i, a, b, c, d) \
  if (tile == i) wm = a, wn = b, fm = c, fn = d;
  DSE_CONV_TILES(DSE_DIMS)
#undef DSE_DIMS
  *bm = 16 * fm * wm;
  *bn = 8 * fn * wn;
  *threads = 32 * wm * wn;
}

// The reduction's fixed chunks: its taps*Cin terms in (tap, channel) order,
// kKC at a time (ops/mega_kernel.py::conv_chunks).
__host__ __device__ inline int conv_steps(int taps, int Cin) {
  return (taps * Cin + kKC - 1) / kKC;
}

// Whether (tile, steps_per_block) is a plan the arm takes for S steps.
inline bool conv_gemm_plan_ok(int tile, int steps_per_block, int S) {
  return tile >= 0 && tile < kConvTiles && steps_per_block >= 1 && steps_per_block <= S &&
         (S + steps_per_block - 1) / steps_per_block <= kMaxConvCluster;
}

// Shared memory of one block of the plan (tile, steps_per_block): the (A, W)
// ring, a stage per step up to kConvStages, and, when a cluster splits the
// steps, `steps_per_block` BM x BN f32 slots.
inline size_t conv_gemm_smem(int tile, int Cin, int Cout, int taps, int steps_per_block,
                             int bf16) {
  int bm, bn, threads;
  conv_tile_dims(tile, &bm, &bn, &threads);
  const int S = conv_steps(taps, Cin);
  const size_t ring = std::min(kConvStages, steps_per_block) *
                      (sizeof(float) * (size_t)bm * kConvLda +
                       (size_t)kKC * (bn + 8) * (bf16 ? 2 : 4));
  return ring + (steps_per_block < S ? sizeof(float) * (size_t)steps_per_block * bm * bn : 0);
}

// The kernels' body; each .cu file's kernel below carries the name that the
// profiler's time is summed under (<wrapper>_kernel).
template <int WMW, int WNW, int FM, int FN, typename WT, typename XT, typename YT,
          bool kPhased>
__device__ __forceinline__ void conv_gemm_body(ConvArgs a, int steps_per_block, int a_vec,
                                               int w_vec) {
  using T = ConvTile<WMW, WNW, FM, FN>;
  constexpr int NT = T::kThreads, BM = T::BM, BN = T::BN, LDW = T::LDW;
  constexpr int kAChunks = BM * kKC / 4;        // 4-term A chunks a step
  constexpr int kWChunks = kKC * BN / 4;        // 4-column W chunks a step
  constexpr int kAPer = (kAChunks + NT - 1) / NT;
  constexpr int kWPer = (kWChunks + NT - 1) / NT;
  constexpr int kAStage = BM * kConvLda;        // floats
  constexpr int kWStage = kKC * LDW;            // weights
  static_assert(NT % (kKC / 4) == 0, "a thread's A chunks share their terms");
  extern __shared__ __align__(16) unsigned char smem[];
  // A block of q <= kConvStages - 1 steps loads them all before its first
  // product, so its ring needs only q stages.
  const int ring = min(kConvStages, steps_per_block);
  float* As = reinterpret_cast<float*>(smem);
  WT* Ws = reinterpret_cast<WT*>(smem + sizeof(float) * ring * kAStage);
  float* slots = reinterpret_cast<float*>(smem + sizeof(float) * ring * kAStage +
                                          sizeof(WT) * ring * kWStage);
  cg::cluster_group cluster = cg::this_cluster();
  const int n_blocks = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const WT* w = static_cast<const WT*>(a.w);
  const int p = kPhased ? (int)blockIdx.y : 0;
  if constexpr (kPhased) w += (size_t)(a.phases - 1 - p) * a.Cin * a.Cout;  // Wc[s - 1 - p]
  const int col_tiles = (a.Cout + BN - 1) / BN;
  const int tile = blockIdx.x / n_blocks;
  const int m0 = (tile / col_tiles) * BM, n0 = (tile % col_tiles) * BN;
  const int K = a.taps * a.Cin;
  const int S = conv_steps(a.taps, a.Cin);
  const int s_begin = rank * steps_per_block;
  const int s_end = min(S, s_begin + steps_per_block);
  const int P = (a.taps - 1) * a.dil;
  const int T_in = a.T_out * a.stride;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gid = lane / 4, tig = lane % 4;
  const int m_w = (warp / WNW) * 16 * FM, n_w = (warp % WNW) * 8 * FN;
  const int cc = (tid % (kKC / 4)) * 4;  // this thread's 4 terms of every A row it stages

  // This thread's A chunks: the same rows of the tile every step, each row's
  // stream and first input row worked out once.
  int a_b[kAPer], a_e0[kAPer];
#pragma unroll
  for (int i = 0; i < kAPer; ++i) {
    const int q = tid + i * NT, m = m0 + q / (kKC / 4);
    const int b = m / a.T_out;
    a_b[i] = q < kAChunks && m < a.M ? b : -1;
    a_e0[i] = (m - b * a.T_out) * a.stride;
  }
  const XT* x = static_cast<const XT*>(a.x);
  // x_ext[s*t + j*d][c] of A chunk i's row: in the cache (f32) where e < P,
  // else in x (XT); only f32 rows are copied by cp.async
  auto a_e = [&](int i, int j) { return a_e0[i] + j * a.dil; };
  auto a_src = [&](int i, int j, int c) {
    const int e = a_e(i, j), b = max(a_b[i], 0);
    return (e < P ? a.cache + (size_t)b * a.cache_bs + (size_t)e * a.Cin
                  : reinterpret_cast<const float*>(x) + ((size_t)b * T_in + e - P) * a.Cin) + c;
  };
  auto x_src = [&](int i, int j, int c) {
    return x + ((size_t)max(a_b[i], 0) * T_in + a_e(i, j) - P) * a.Cin + c;
  };
  constexpr bool kWiden = sizeof(XT) == 2;
  auto store = [&](int m, int n, float v) {
    const size_t row = kPhased ? (size_t)m * a.phases + p : (size_t)m;
    static_cast<YT*>(a.out)[row * a.Cout + n] = from_f<YT>(conv_out(a, n, v));
  };

  // Stages step `step`'s A (BM rows x its terms, zeros past them up to a
  // multiple of 8) and W (its terms' rows, BN columns) into ring stage `stage`.
  auto load = [&](int step, int stage) {
    if (step < s_end) {
      const int g0 = step * kKC, kn = min(kKC, K - g0), kn8 = (kn + 7) / 8 * 8;
      float* ad = As + stage * kAStage;
      if (cc < kn8) {
        const int g = g0 + cc, j = g / a.Cin, c = g - j * a.Cin;
#pragma unroll
        for (int i = 0; i < kAPer; ++i) {
          const int q = tid + i * NT;
          if (kAChunks % NT != 0 && q >= kAChunks) break;
          float* dst = ad + (q / (kKC / 4)) * kConvLda + cc;
          if (a_vec) {  // Cin % 4 == 0: the 4 terms are 4 channels of one tap
            const bool ok = a_b[i] >= 0 && cc < kn;
            if (kWiden && ok && a_e(i, j) >= P)
              *reinterpret_cast<float4*>(dst) = load4(x_src(i, j, c));
            else
              cp_async<16>(dst, ok ? a_src(i, j, c) : kConvZeros, ok ? 16 : 0);
          } else {
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int ju = (g + u) / a.Cin, cu = g + u - ju * a.Cin;
              const bool ok = a_b[i] >= 0 && cc + u < kn;
              if (kWiden && ok && a_e(i, ju) >= P)
                dst[u] = to_f(*x_src(i, ju, cu));
              else
                cp_async<4>(dst + u, ok ? a_src(i, ju, cu) : kConvZeros, ok ? 4 : 0);
            }
          }
        }
      }
      WT* wd = Ws + stage * kWStage;
      const WT* wsrc = w + (size_t)g0 * a.Cout + n0;  // W is (taps * Cin, Cout)
#pragma unroll
      for (int i = 0; i < kWPer; ++i) {
        const int q = tid + i * NT;
        if (kWChunks % NT != 0 && q >= kWChunks) break;
        const int r = q / (BN / 4), col = (q % (BN / 4)) * 4;
        if (r >= kn8) continue;
        WT* dst = wd + r * LDW + col;
        // a phase's tap 1 lies s taps after its tap 0
        const WT* src = kPhased ? w + ((size_t)(g0 + r) + (size_t)((g0 + r) / a.Cin) *
                                           (a.phases - 1) * a.Cin) * a.Cout + n0 + col
                                : wsrc + (size_t)r * a.Cout + col;
        if (w_vec) {
          const bool ok = r < kn && n0 + col < a.Cout;
          cp_async<4 * (int)sizeof(WT)>(dst, ok ? src : w, ok ? 4 * (int)sizeof(WT) : 0);
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u) dst[u] = r < kn && n0 + col + u < a.Cout ? src[u] : WT(0.f);
        }
      }
    }
    cp_async_commit();
  };

  float acc[FM][FN][4];
#pragma unroll
  for (int mi = 0; mi < FM; ++mi)
#pragma unroll
    for (int f = 0; f < FN; ++f)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][f][i] = 0.f;
  bool live[FM];  // fragments of this warp that hold rows < M
#pragma unroll
  for (int mi = 0; mi < FM; ++mi) live[mi] = m0 + m_w + 16 * mi < a.M;

#pragma unroll
  for (int i = 0; i < kConvStages - 1; ++i) load(s_begin + i, i);
  int stage = 0;
  for (int step = s_begin; step < s_end; ++step) {
    const int kn = min(kKC, K - step * kKC), k8 = (kn + 7) / 8;
    cp_async_wait<kConvStages - 2>();
    if (a.act && cc < k8 * 8) {  // each thread activates the A elements it copied
      float* ad = As + stage * kAStage;
#pragma unroll
      for (int i = 0; i < kAPer; ++i) {
        const int q = tid + i * NT;
        if (kAChunks % NT != 0 && q >= kAChunks) break;
        float* v = ad + (q / (kKC / 4)) * kConvLda + cc;
#pragma unroll
        for (int u = 0; u < 4; ++u) v[u] = leaky(v[u], a.slope);
      }
    }
    __syncthreads();  // this step's tiles are in; the stage loaded next is free
    load(step + kConvStages - 1, (stage + kConvStages - 1) % kConvStages);
    const float* at = As + stage * kAStage;
    const WT* wt = Ws + stage * kWStage;
    float part[FM][FN][4];
#pragma unroll
    for (int mi = 0; mi < FM; ++mi)
#pragma unroll
      for (int f = 0; f < FN; ++f)
#pragma unroll
        for (int i = 0; i < 4; ++i) part[mi][f][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKC / 8; ++kk) {
      if (kk >= k8) break;
      uint32_t bh[FN][2], bl[FN][2];
#pragma unroll
      for (int f = 0; f < FN; ++f) {
        const int n = n_w + f * 8 + gid;
        const float w0 = to_f(wt[(kk * 8 + tig) * LDW + n]);
        const float w1 = to_f(wt[(kk * 8 + tig + 4) * LDW + n]);
        if constexpr (sizeof(WT) == 2) {  // bf16 weights are exact in TF32
          bh[f][0] = __float_as_uint(w0);
          bh[f][1] = __float_as_uint(w1);
        } else {
          split_tf32(w0, bh[f][0], bl[f][0]);
          split_tf32(w1, bh[f][1], bl[f][1]);
        }
      }
#pragma unroll
      for (int mi = 0; mi < FM; ++mi) {
        if (!live[mi]) continue;
        const float* ap = at + (m_w + mi * 16 + gid) * kConvLda + kk * 8 + tig;
        uint32_t hi[4], lo[4];
        split_tf32(ap[0], hi[0], lo[0]);
        split_tf32(ap[8 * kConvLda], hi[1], lo[1]);
        split_tf32(ap[4], hi[2], lo[2]);
        split_tf32(ap[8 * kConvLda + 4], hi[3], lo[3]);
#pragma unroll
        for (int f = 0; f < FN; ++f) {
          mma_tf32(part[mi][f], hi, bh[f][0], bh[f][1]);
          mma_tf32(part[mi][f], lo, bh[f][0], bh[f][1]);
          if constexpr (sizeof(WT) == 4) mma_tf32(part[mi][f], hi, bl[f][0], bl[f][1]);
        }
      }
    }
    const bool keep = rank == 0;  // block 0 keeps the running sum; the others each step
#pragma unroll
    for (int mi = 0; mi < FM; ++mi)
#pragma unroll
      for (int f = 0; f < FN; ++f)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float v = part[mi][f][i];
          if (keep) {
            acc[mi][f][i] += v;
          } else {
            const int m = m_w + 16 * mi + gid + (i >= 2 ? 8 : 0);
            const int n = n_w + f * 8 + tig * 2 + (i & 1);
            slots[((step - s_begin) * BM + m) * BN + n] = v;
          }
        }
    stage = stage + 1 == kConvStages ? 0 : stage + 1;
  }
  cp_async_wait<0>();

  if (n_blocks == 1) {
#pragma unroll
    for (int mi = 0; mi < FM; ++mi)
#pragma unroll
      for (int f = 0; f < FN; ++f)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int m = m0 + m_w + 16 * mi + gid + (i >= 2 ? 8 : 0);
          const int n = n0 + n_w + f * 8 + tig * 2 + (i & 1);
          if (m < a.M && n < a.Cout) store(m, n, acc[mi][f][i]);
        }
    return;
  }
  if (rank == 0) {
#pragma unroll
    for (int mi = 0; mi < FM; ++mi)
#pragma unroll
      for (int f = 0; f < FN; ++f)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int m = m_w + 16 * mi + gid + (i >= 2 ? 8 : 0);
          const int n = n_w + f * 8 + tig * 2 + (i & 1);
          slots[m * BN + n] = acc[mi][f][i];
        }
  }
  cluster.sync();  // every block's sums are in its shared memory
  for (int e = rank * NT + tid; e < BM * BN; e += n_blocks * NT) {
    const int m = m0 + e / BN, n = n0 + e % BN;
    float t = *cluster.map_shared_rank(slots + e, 0);
    for (int r = 1; r < n_blocks; ++r) {
      const float* peer = cluster.map_shared_rank(slots, r);
      const int count = min(S, (r + 1) * steps_per_block) - r * steps_per_block;
      for (int i = 0; i < count; ++i) t += peer[i * BM * BN + e];
    }
    if (m < a.M && n < a.Cout) store(m, n, t);
  }
  cluster.sync();  // no block leaves while a peer reads its shared memory
}

template <int WMW, int WNW, int FM, int FN, typename WT, typename XT, typename YT>
__global__ void __launch_bounds__(32 * WMW * WNW, ConvTile<WMW, WNW, FM, FN>::kMinBlocks)
causal_conv_kernel_gemm(ConvArgs a, int steps_per_block, int a_vec, int w_vec) {
  conv_gemm_body<WMW, WNW, FM, FN, WT, XT, YT, false>(a, steps_per_block, a_vec, w_vec);
}

template <int WMW, int WNW, int FM, int FN, typename WT, typename XT, typename YT>
__global__ void __launch_bounds__(32 * WMW * WNW, ConvTile<WMW, WNW, FM, FN>::kMinBlocks)
causal_conv_transpose_kernel(ConvArgs a, int steps_per_block, int a_vec, int w_vec) {
  conv_gemm_body<WMW, WNW, FM, FN, WT, XT, YT, true>(a, steps_per_block, a_vec, w_vec);
}

template <int WMW, int WNW, int FM, int FN, typename WT, typename XT, typename YT,
          bool kPhased>
cudaError_t launch_gemm(const ConvArgs& a, int steps_per_block, int a_vec, int w_vec,
                        size_t smem, cudaStream_t stream) {
  using T = ConvTile<WMW, WNW, FM, FN>;
  static size_t configured[kMaxDevices] = {};
  void (*kernel)(ConvArgs, int, int, int);
  if constexpr (kPhased)
    kernel = causal_conv_transpose_kernel<WMW, WNW, FM, FN, WT, XT, YT>;
  else
    kernel = causal_conv_kernel_gemm<WMW, WNW, FM, FN, WT, XT, YT>;
  cudaError_t err = allow_smem(kernel, smem, configured);
  if (err != cudaSuccess) return err;
  const int S = conv_steps(a.taps, a.Cin);
  const int cluster = (S + steps_per_block - 1) / steps_per_block;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((a.M + T::BM - 1) / T::BM) * ((a.Cout + T::BN - 1) / T::BN) * cluster,
                     a.phases);
  cfg.blockDim = dim3(T::kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a, steps_per_block, a_vec, w_vec);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Launches the GEMM arm at the plan (tile, steps_per_block), which the caller
// has checked (conv_gemm_plan_ok) and whose shared memory is `smem`.
template <typename WT, typename XT, typename YT, bool kPhased>
cudaError_t launch_conv_gemm(const ConvArgs& a, int tile, int steps_per_block, size_t smem,
                             cudaStream_t s) {
  const int a_vec = a.Cin % 4 == 0 && a.cache_bs % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(a.cache) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(a.x) % (4 * sizeof(XT)) == 0;
  const int w_vec = a.Cout % 4 == 0 && reinterpret_cast<uintptr_t>(a.w) % (4 * sizeof(WT)) == 0;
#define DSE_LAUNCH(i, wm, wn, fm, fn)                                                        \
  if (tile == i)                                                                             \
    return launch_gemm<wm, wn, fm, fn, WT, XT, YT, kPhased>(a, steps_per_block, a_vec, w_vec, \
                                                            smem, s);
  DSE_CONV_TILES(DSE_LAUNCH)
#undef DSE_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace dse
