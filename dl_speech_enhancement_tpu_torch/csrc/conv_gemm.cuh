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
// Products are TF32 `mma.sync.m16n8k8`. With f32 weights both operands are
// split (tile_mma.cuh's split_tf32): a_hi*w_hi + a_lo*w_hi + a_hi*w_lo. With
// bf16 weights the reference multiplies bf16 by bf16 (JAX rounds every
// conv's input rows to the weight dtype, `v.astype(wd)`), so each A value is
// rounded to bf16 as it is read, after its activation; a bf16 value times a
// bf16 weight is exact in one TF32 pass, and the split's low pass, which
// would add zeros, is not run. The reduction's taps*Cin terms,
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
// dtype (ops/mega_stacked.py). The cache stays f32. The f32-x arm stages its
// A tile as f32 through cp.async. The bf16-x arm (always into bf16) keeps the
// f32 arm's sums bit for bit on the widened values, but stages and
// multiplies them for what they are:
// - x's terms are copied as bf16 by 16-byte cp.async (8 channels) into a
//   bf16 A stage, half the f32 stage's bytes, and widened (a 16-bit shift,
//   exact) as the fragments are read. A stream's first Q = ceil(P / stride)
//   rows may take terms from the f32 cache, always a prefix of the reduction
//   (the taps before the row's first x row): those "side rows" of a tile get
//   their cache terms by cp.async into a small f32 side stage,
//   conv_side_rows of them a step, and read each term from the stage its
//   place in the reduction names. No load of the arm waits.
// - A widened bf16 value is exact in TF32: its low split part is zero. So a
//   16-row fragment with no side row and no activation multiplies its hi
//   part alone (the f32 arm's a_lo*w pass would add exact zero products);
//   elsewhere, with f32 weights, the fragment is split, and a warp vote
//   skips the a_lo pass of an 8-term slice whose low parts are all zero
//   (bf16-exact cache rows); with bf16 weights it is rounded to bf16, one
//   pass. LeakyReLU applies as the fragments are read.
// - A step is bound by the shared-memory loads that feed the fragments, not
//   by memory or the tensor cores (tools/conv_timing.py: a deeper ring and
//   an L1 bypass gained nothing). So lane gid of a warp takes the FN
//   adjacent output columns n_w + gid*FN + f, f < FN, where the f32-x arm's
//   lane takes n_w + 8f + gid: its weights of a k row are one vector load
//   (the W rows padded so that the four k rows of a load hit distinct
//   banks), and its 2*FN adjacent outputs of a row one vector store. Every
//   output element still gets the same products in the same order. The
//   weights come in 16-byte copies (8 bf16 columns), and a tile of its own
//   (DSE_CONV_TILES_BF16X) shares each A load among 8 fragments.
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
constexpr int kConvLdaH = kKC + 8;  // bf16 A row stride: 144 bytes, 16-byte rows, 8 bank quads
constexpr int kMaxConvCluster = 8;
// The source of the A tile's zero fill (cp.async of 0 bytes reads nothing).
__device__ __align__(16) float kConvZeros[4];

// The bf16-x arm's W row stride (elements) for BN columns of WT: the four k
// rows a vector load reads (tig, 8 words apart in banks) hit distinct banks.
__host__ __device__ constexpr int conv_ldw_bf16x(int bn, int w_bytes) {
  return w_bytes == 4 ? bn + 8 : bn == 16 ? 48 : bn + 16;
}

// FN adjacent weights of one k row as f32 (one vector load where FN > 1).
template <int FN, typename WT>
__device__ __forceinline__ void load_w_row(const WT* p, float (&v)[FN]) {
  if constexpr (sizeof(WT) == 2 && FN == 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      v[2 * i] = __uint_as_float(w[i] << 16), v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  } else if constexpr (sizeof(WT) == 2 && FN == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    v[0] = __uint_as_float(u.x << 16), v[1] = __uint_as_float(u.x & 0xffff0000u);
    v[2] = __uint_as_float(u.y << 16), v[3] = __uint_as_float(u.y & 0xffff0000u);
  } else if constexpr (sizeof(WT) == 2 && FN == 2) {
    const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
    v[0] = __uint_as_float(u << 16), v[1] = __uint_as_float(u & 0xffff0000u);
  } else if constexpr (sizeof(WT) == 4 && FN == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else if constexpr (sizeof(WT) == 4 && FN == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x, v[1] = q.y;
  } else {
#pragma unroll
    for (int f = 0; f < FN; ++f) v[f] = to_f(p[f]);
  }
}

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
  // the vocoder's upsamples round to bf16: 1 the product, before the bias
  // (JAX K4), 2 the output, after it (JAX K5)
  int round_mode = 0;
};

__device__ __forceinline__ float conv_out(const ConvArgs& a, int n, float v) {
  if (a.round_mode == 1) v = __bfloat162float(__float2bfloat16_rn(v));
  float y = a.bias ? v + a.bias[n] : v;
  if (a.round_mode == 2) y = __bfloat162float(__float2bfloat16_rn(y));
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
// The bf16-x arm's with bf16 weights alone: warps of 16 x 64 outputs, whose
// 8 fragments share each A load (the A loads bound its steps). It spills 136
// bytes under the 128-register cap and is still the fastest at many rows; 4
// such warps without the cap (213 registers) were slower everywhere.
#define DSE_CONV_TILES_BF16X(X) X(6, 8, 1, 1, 8)
constexpr int kConvTiles = 6;        // f32 x or f32 weights
constexpr int kConvTilesBf16x = 7;   // bf16 x and weights: those and DSE_CONV_TILES_BF16X

__host__ __device__ inline void conv_tile_dims(int tile, int* bm, int* bn, int* threads) {
  int wm = 1, wn = 2, fm = 1, fn = 1;
#define DSE_DIMS(i, a, b, c, d) \
  if (tile == i) wm = a, wn = b, fm = c, fn = d;
  DSE_CONV_TILES(DSE_DIMS)
  DSE_CONV_TILES_BF16X(DSE_DIMS)
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

// Whether (tile, steps_per_block) is a plan the arm takes for S steps, with
// bf16 x and weights (`bf16_xw`) or not.
inline bool conv_gemm_plan_ok(int tile, int steps_per_block, int S, int bf16_xw) {
  return tile >= 0 && tile < (bf16_xw ? kConvTilesBf16x : kConvTiles) && steps_per_block >= 1 &&
         steps_per_block <= S && (S + steps_per_block - 1) / steps_per_block <= kMaxConvCluster;
}

// A stream's first Q = ceil(P / stride) output rows may read terms of the
// cache (P = (taps - 1) * dil rows); the later ones read x alone.
__host__ __device__ inline int conv_cache_rows(int taps, int stride, int dil) {
  return ((taps - 1) * dil + stride - 1) / stride;
}

// Side rows a bf16-x block of BM rows stages a step: min(Q, T_out) rows of
// each stream the tile meets (at most ceil(BM / T_out) + 1 of them), or BM
// where that is as many (then a row's slot is its row in the tile).
__host__ __device__ inline int conv_side_rows(int bm, int T_out, int Q) {
  if (Q <= 0) return 0;
  const long long n = (long long)((bm + T_out - 1) / T_out + 1) * (Q < T_out ? Q : T_out);
  return n < bm ? (int)n : bm;
}

// Shared memory of one block of the plan (tile, steps_per_block): the (A, W)
// ring, a stage per step up to kConvStages, and, when a cluster splits the
// steps, `steps_per_block` BM x BN f32 slots. With bf16 x an A stage is the
// bf16 rows and `side_rows` f32 rows (conv_side_rows), a W row
// conv_ldw_bf16x elements.
inline size_t conv_gemm_smem(int tile, int Cin, int Cout, int taps, int steps_per_block,
                             int bf16, int x_bf16 = 0, int side_rows = 0) {
  int bm, bn, threads;
  conv_tile_dims(tile, &bm, &bn, &threads);
  const int S = conv_steps(taps, Cin);
  const size_t a_stage = x_bf16 ? 2 * (size_t)bm * kConvLdaH + sizeof(float) * (size_t)side_rows *
                                                                 kConvLda
                                : sizeof(float) * (size_t)bm * kConvLda;
  const int ldw = x_bf16 ? conv_ldw_bf16x(bn, bf16 ? 2 : 4) : bn + 8;
  const size_t ring = std::min(kConvStages, steps_per_block) *
                      (a_stage + (size_t)kKC * ldw * (bf16 ? 2 : 4));
  return ring + (steps_per_block < S ? sizeof(float) * (size_t)steps_per_block * bm * bn : 0);
}

// The kernels' body; each .cu file's kernel below carries the name that the
// profiler's time is summed under (<wrapper>_kernel).
template <int WMW, int WNW, int FM, int FN, typename WT, typename XT, typename YT,
          bool kPhased>
__device__ __forceinline__ void conv_gemm_body(ConvArgs a, int steps_per_block, int a_vec,
                                               int w_vec) {
  using T = ConvTile<WMW, WNW, FM, FN>;
  constexpr bool kWiden = sizeof(XT) == 2;  // bf16 x: the bf16 A stage (see the top)
  constexpr int NT = T::kThreads, BM = T::BM, BN = T::BN;
  constexpr int LDW = kWiden ? conv_ldw_bf16x(BN, sizeof(WT)) : T::LDW;
  constexpr int kChunkTerms = kWiden ? 8 : 4;   // terms of an A chunk: 16 bytes of x
  constexpr int kChunksRow = kKC / kChunkTerms;
  constexpr int kAChunks = BM * kChunksRow;     // A chunks a step
  constexpr int kWCols = kWiden && sizeof(WT) == 2 ? 8 : 4;  // 16-byte bf16 copies
  constexpr int kWChunks = kKC * BN / kWCols;   // kWCols-column W chunks a step
  constexpr int kAPer = (kAChunks + NT - 1) / NT;
  constexpr int kWPer = (kWChunks + NT - 1) / NT;
  constexpr int kAStage = BM * kConvLda;        // floats
  constexpr int kAStageH = BM * kConvLdaH;      // bf16 x: bf16 elements
  constexpr int kWStage = kKC * LDW;            // weights
  static_assert(NT % kChunksRow == 0, "a thread's A chunks share their terms");
  extern __shared__ __align__(16) unsigned char smem[];
  const int P = (a.taps - 1) * a.dil;
  // bf16 x: the rows of the tile that may read the cache, staged in f32
  const int Q = kWiden ? conv_cache_rows(a.taps, a.stride, a.dil) : 0;
  const int side_rows = kWiden ? conv_side_rows(BM, a.T_out, Q) : 0;
  const size_t a_stage_bytes = kWiden ? 2 * (size_t)kAStageH + sizeof(float) * side_rows *
                                                                   kConvLda
                                      : sizeof(float) * kAStage;
  // A block of q <= kConvStages - 1 steps loads them all before its first
  // product, so its ring needs only q stages.
  const int ring = min(kConvStages, steps_per_block);
  float* As = reinterpret_cast<float*>(smem);
  WT* Ws = reinterpret_cast<WT*>(smem + ring * a_stage_bytes);
  float* slots = reinterpret_cast<float*>(smem + ring * a_stage_bytes +
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
  const int T_in = a.T_out * a.stride;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gid = lane / 4, tig = lane % 4;
  const int m_w = (warp / WNW) * 16 * FM, n_w = (warp % WNW) * 8 * FN;
  // this thread's terms of every A row it stages
  const int cc = (tid % kChunksRow) * kChunkTerms;

  // bf16 x: the side slot of tile row m (-1 where it reads x alone), in the
  // side stage of conv_side_rows rows
  const int b_first = m0 / a.T_out, mq = min(Q, a.T_out);
  auto side_slot = [&](int m) {
    const int b = m / a.T_out, t = m - b * a.T_out;
    if (m >= a.M || t >= Q) return -1;
    return side_rows == BM ? m - m0 : (b - b_first) * mq + t;
  };

  // This thread's A chunks: the same rows of the tile every step, each row's
  // stream and first input row worked out once.
  int a_b[kAPer], a_e0[kAPer], a_side[kAPer];
#pragma unroll
  for (int i = 0; i < kAPer; ++i) {
    const int q = tid + i * NT, m = m0 + q / kChunksRow;
    const int b = m / a.T_out;
    a_b[i] = q < kAChunks && m < a.M ? b : -1;
    a_e0[i] = (m - b * a.T_out) * a.stride;
    if constexpr (kWiden) a_side[i] = a_b[i] >= 0 ? side_slot(m) : -1;
  }
  const XT* x = static_cast<const XT*>(a.x);
  // x_ext[s*t + j*d][c] of A chunk i's row: in the cache (f32) where e < P,
  // else in x (XT)
  auto a_e = [&](int i, int j) { return a_e0[i] + j * a.dil; };
  auto a_src = [&](int i, int j, int c) {
    const int e = a_e(i, j), b = max(a_b[i], 0);
    return (e < P ? a.cache + (size_t)b * a.cache_bs + (size_t)e * a.Cin
                  : reinterpret_cast<const float*>(x) + ((size_t)b * T_in + e - P) * a.Cin) + c;
  };
  auto x_src = [&](int i, int j, int c) {
    return x + ((size_t)max(a_b[i], 0) * T_in + a_e(i, j) - P) * a.Cin + c;
  };
  auto store = [&](int m, int n, float v) {
    const size_t row = kPhased ? (size_t)m * a.phases + p : (size_t)m;
    static_cast<YT*>(a.out)[row * a.Cout + n] = from_f<YT>(conv_out(a, n, v));
  };

  // Stages step `step`'s A (BM rows x its terms, zeros past them up to a
  // multiple of 8) and W (its terms' rows, BN columns) into ring stage `stage`.
  auto load = [&](int step, int stage) {
    if (step < s_end) {
      const int g0 = step * kKC, kn = min(kKC, K - g0), kn8 = (kn + 7) / 8 * 8;
      if constexpr (kWiden) {
        unsigned char* sb = smem + stage * a_stage_bytes;
        __nv_bfloat16* ad = reinterpret_cast<__nv_bfloat16*>(sb);
        float* sd = reinterpret_cast<float*>(sb + 2 * kAStageH);
        if (cc < kn8) {
          const int g = g0 + cc, j = g / a.Cin, c = g - j * a.Cin;
#pragma unroll
          for (int i = 0; i < kAPer; ++i) {
            const int q = tid + i * NT;
            if (kAChunks % NT != 0 && q >= kAChunks) break;
            // x's terms (or zeros) into the bf16 rows, a side row's cache terms
            // into its f32 row (the bf16 row's place there is not read)
            __nv_bfloat16* dst = ad + (q / kChunksRow) * kConvLdaH + cc;
            float* side = sd + a_side[i] * kConvLda + cc;
            if (a_vec) {  // Cin % 8 == 0: the 8 terms are 8 channels of one tap
              const bool ok = a_b[i] >= 0 && cc < kn;
              if (ok && a_e(i, j) < P) {
                const float* src = a_src(i, j, c);
                cp_async<16>(side, src, 16);
                cp_async<16>(side + 4, src + 4, 16);
              } else {
                cp_async<16>(dst, ok ? static_cast<const void*>(x_src(i, j, c)) : kConvZeros,
                             ok ? 16 : 0);
              }
            } else {
#pragma unroll
              for (int u = 0; u < 8; ++u) {
                const int ju = (g + u) / a.Cin, cu = g + u - ju * a.Cin;
                const bool ok = a_b[i] >= 0 && cc + u < kn;
                if (ok && a_e(i, ju) < P)
                  cp_async<4>(side + u, a_src(i, ju, cu), 4);
                else
                  dst[u] = ok ? *x_src(i, ju, cu) : __float2bfloat16(0.f);
              }
            }
          }
        }
      } else {
        float* ad = As + stage * kAStage;
        if (cc < kn8) {
          const int g = g0 + cc, j = g / a.Cin, c = g - j * a.Cin;
#pragma unroll
          for (int i = 0; i < kAPer; ++i) {
            const int q = tid + i * NT;
            if (kAChunks % NT != 0 && q >= kAChunks) break;
            float* dst = ad + (q / kChunksRow) * kConvLda + cc;
            if (a_vec) {  // Cin % 4 == 0: the 4 terms are 4 channels of one tap
              const bool ok = a_b[i] >= 0 && cc < kn;
              cp_async<16>(dst, ok ? a_src(i, j, c) : kConvZeros, ok ? 16 : 0);
            } else {
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                const int ju = (g + u) / a.Cin, cu = g + u - ju * a.Cin;
                const bool ok = a_b[i] >= 0 && cc + u < kn;
                cp_async<4>(dst + u, ok ? a_src(i, ju, cu) : kConvZeros, ok ? 4 : 0);
              }
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
        const int r = q / (BN / kWCols), col = (q % (BN / kWCols)) * kWCols;
        if (r >= kn8) continue;
        WT* dst = wd + r * LDW + col;
        // a phase's tap 1 lies s taps after its tap 0
        const WT* src = kPhased ? w + ((size_t)(g0 + r) + (size_t)((g0 + r) / a.Cin) *
                                           (a.phases - 1) * a.Cin) * a.Cout + n0 + col
                                : wsrc + (size_t)r * a.Cout + col;
        if (w_vec) {
          const bool ok = r < kn && n0 + col < a.Cout;
          cp_async<kWCols * (int)sizeof(WT)>(dst, ok ? src : w, ok ? kWCols * (int)sizeof(WT) : 0);
        } else {
#pragma unroll
          for (int u = 0; u < kWCols; ++u)
            dst[u] = r < kn && n0 + col + u < a.Cout ? src[u] : WT(0.f);
        }
      }
    }
    cp_async_commit();
  };

  // the tile column of this lane's sum i of fragment f (see the top)
  auto col_of = [&](int f, int i) {
    return kWiden ? n_w + (2 * tig + (i & 1)) * FN + f : n_w + f * 8 + tig * 2 + (i & 1);
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
  // bf16 x: this lane's two rows of each fragment (gid, gid + 8): the slot
  // in the side stage and the end of the row's cache terms in the reduction
  // (0: none), and the fragments that are split: those with a side row (a
  // warp vote over its 16 rows) or an activation
  int r_side[FM][2], r_end[FM][2];
  bool split[FM];
#pragma unroll
  for (int mi = 0; mi < FM; ++mi) {
    if constexpr (kWiden) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + m_w + 16 * mi + gid + 8 * h;
        r_side[mi][h] = side_slot(m);
        // taps j with e + j * dil < P, e = t * stride < P (a side row's t < Q)
        const int e = (m - (m / a.T_out) * a.T_out) * a.stride;
        r_end[mi][h] = r_side[mi][h] < 0 ? 0 : (P - e + a.dil - 1) / a.dil * a.Cin;
      }
      split[mi] = __any_sync(0xffffffffu, r_side[mi][0] >= 0 || r_side[mi][1] >= 0) || a.act;
    }
  }

#pragma unroll
  for (int i = 0; i < kConvStages - 1; ++i) load(s_begin + i, i);
  int stage = 0;
  for (int step = s_begin; step < s_end; ++step) {
    const int kn = min(kKC, K - step * kKC), k8 = (kn + 7) / 8;
    cp_async_wait<kConvStages - 2>();
    // each thread activates the A elements it copied (bf16 x: as they are read)
    if (!kWiden && a.act && cc < k8 * 8) {
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
    const unsigned char* sb = smem + stage * a_stage_bytes;  // bf16 x: rows, side rows
    const unsigned short* ah = reinterpret_cast<const unsigned short*>(sb);
    const float* sd = reinterpret_cast<const float*>(sb + 2 * kAStageH);
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
      if constexpr (kWiden) {  // lane gid's FN adjacent columns, a vector load a k row
        float w0[FN], w1[FN];
        load_w_row<FN>(wt + (kk * 8 + tig) * LDW + n_w + gid * FN, w0);
        load_w_row<FN>(wt + (kk * 8 + tig + 4) * LDW + n_w + gid * FN, w1);
#pragma unroll
        for (int f = 0; f < FN; ++f) {
          if constexpr (sizeof(WT) == 2) {  // bf16 weights are exact in TF32
            bh[f][0] = __float_as_uint(w0[f]);
            bh[f][1] = __float_as_uint(w1[f]);
          } else {
            split_tf32(w0[f], bh[f][0], bl[f][0]);
            split_tf32(w1[f], bh[f][1], bl[f][1]);
          }
        }
      } else {
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
      }
#pragma unroll
      for (int mi = 0; mi < FM; ++mi) {
        if (!live[mi]) continue;
        uint32_t hi[4], lo[4];
        if constexpr (kWiden) {
          const int col = kk * 8 + tig;
          const unsigned short* hp = ah + (m_w + mi * 16 + gid) * kConvLdaH + col;
          if (!split[mi]) {  // widened bf16 x: exact in TF32, no low part
            hi[0] = (uint32_t)hp[0] << 16;
            hi[1] = (uint32_t)hp[8 * kConvLdaH] << 16;
            hi[2] = (uint32_t)hp[4] << 16;
            hi[3] = (uint32_t)hp[8 * kConvLdaH + 4] << 16;
#pragma unroll
            for (int f = 0; f < FN; ++f) {
              mma_tf32(part[mi][f], hi, bh[f][0], bh[f][1]);
              if constexpr (sizeof(WT) == 4) mma_tf32(part[mi][f], hi, bl[f][0], bl[f][1]);
            }
            continue;
          }
          // a term before the row's cache end is the side stage's
          const int g = step * kKC + col;
          const float* s0 = sd + r_side[mi][0] * kConvLda + col;
          const float* s1 = sd + r_side[mi][1] * kConvLda + col;
          float v[4] = {
              g < r_end[mi][0] ? s0[0] : __uint_as_float((uint32_t)hp[0] << 16),
              g < r_end[mi][1] ? s1[0] : __uint_as_float((uint32_t)hp[8 * kConvLdaH] << 16),
              g + 4 < r_end[mi][0] ? s0[4] : __uint_as_float((uint32_t)hp[4] << 16),
              g + 4 < r_end[mi][1] ? s1[4]
                                   : __uint_as_float((uint32_t)hp[8 * kConvLdaH + 4] << 16)};
          if constexpr (sizeof(WT) == 2) {  // bf16 weights: the bf16 operand, one pass
#pragma unroll
            for (int u = 0; u < 4; ++u)
              hi[u] = __float_as_uint(mma_operand<WT>(a.act ? leaky(v[u], a.slope) : v[u]));
#pragma unroll
            for (int f = 0; f < FN; ++f) mma_tf32(part[mi][f], hi, bh[f][0], bh[f][1]);
            continue;
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (a.act) v[u] = leaky(v[u], a.slope);
            split_tf32(v[u], hi[u], lo[u]);
          }
          // the passes in the f32 arm's order; an a_lo pass of zeros adds nothing
#pragma unroll
          for (int f = 0; f < FN; ++f) mma_tf32(part[mi][f], hi, bh[f][0], bh[f][1]);
          if (__any_sync(0xffffffffu, (lo[0] | lo[1] | lo[2] | lo[3]) != 0u)) {
#pragma unroll
            for (int f = 0; f < FN; ++f) mma_tf32(part[mi][f], lo, bh[f][0], bh[f][1]);
          }
          if constexpr (sizeof(WT) == 4) {
#pragma unroll
            for (int f = 0; f < FN; ++f) mma_tf32(part[mi][f], hi, bl[f][0], bl[f][1]);
          }
        } else {
          const float* ap = at + (m_w + mi * 16 + gid) * kConvLda + kk * 8 + tig;
          if constexpr (sizeof(WT) == 2) {  // bf16 weights: the bf16 operand, one pass
            hi[0] = __float_as_uint(mma_operand<WT>(ap[0]));
            hi[1] = __float_as_uint(mma_operand<WT>(ap[8 * kConvLda]));
            hi[2] = __float_as_uint(mma_operand<WT>(ap[4]));
            hi[3] = __float_as_uint(mma_operand<WT>(ap[8 * kConvLda + 4]));
#pragma unroll
            for (int f = 0; f < FN; ++f) mma_tf32(part[mi][f], hi, bh[f][0], bh[f][1]);
            continue;
          }
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
            slots[((step - s_begin) * BM + m) * BN + col_of(f, i)] = v;
          }
        }
    stage = stage + 1 == kConvStages ? 0 : stage + 1;
  }
  cp_async_wait<0>();

  if (n_blocks == 1) {
    if constexpr (kWiden) {  // bf16 out: a lane's 2*FN adjacent columns of a row, one store
      constexpr int kCols = 2 * FN;
      const bool whole = a.Cout % kCols == 0 &&
                         reinterpret_cast<uintptr_t>(a.out) % (kCols < 8 ? 2 * kCols : 16) == 0;
#pragma unroll
      for (int mi = 0; mi < FM; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + m_w + 16 * mi + gid + 8 * h;
          const int n = n0 + col_of(0, 0);  // columns n + c: sum 2h + c / FN of fragment c % FN
          if (m >= a.M || n >= a.Cout) continue;
          float y[kCols];
#pragma unroll
          for (int c = 0; c < kCols; ++c) y[c] = acc[mi][c % FN][2 * h + c / FN];
          if (whole) {
            const size_t row = kPhased ? (size_t)m * a.phases + p : (size_t)m;
            uint32_t v[FN];  // column pairs, rounded
#pragma unroll
            for (int c = 0; c < FN; ++c) {
              const __nv_bfloat162 pair = __floats2bfloat162_rn(
                  conv_out(a, n + 2 * c, y[2 * c]), conv_out(a, n + 2 * c + 1, y[2 * c + 1]));
              v[c] = *reinterpret_cast<const uint32_t*>(&pair);
            }
            YT* o = static_cast<YT*>(a.out) + row * a.Cout + n;
            if constexpr (FN >= 4) {
#pragma unroll
              for (int q = 0; q < FN / 4; ++q)
                reinterpret_cast<uint4*>(o)[q] =
                    make_uint4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
            }
            if constexpr (FN == 2)
              *reinterpret_cast<uint2*>(o) = make_uint2(v[0], v[1]);
            if constexpr (FN == 1)
              *reinterpret_cast<uint32_t*>(o) = v[0];
          } else {
#pragma unroll
            for (int c = 0; c < kCols; ++c)
              if (n + c < a.Cout) store(m, n + c, y[c]);
          }
        }
    } else {
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
          slots[m * BN + col_of(f, i)] = acc[mi][f][i];
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
  // A chunks of 16 bytes: 4 f32 or 8 bf16 channels of one tap
  const int a_vec = a.Cin % (16 / sizeof(XT)) == 0 && a.cache_bs % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(a.cache) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(a.x) % 16 == 0;
  // W chunks of 4 columns (8 in the bf16-x arm with bf16 weights: 16 bytes)
  constexpr int wcols = sizeof(XT) == 2 && sizeof(WT) == 2 ? 8 : 4;
  const int w_vec = a.Cout % wcols == 0 &&
                    reinterpret_cast<uintptr_t>(a.w) % (wcols * sizeof(WT)) == 0;
#define DSE_LAUNCH(i, wm, wn, fm, fn)                                                        \
  if (tile == i)                                                                             \
    return launch_gemm<wm, wn, fm, fn, WT, XT, YT, kPhased>(a, steps_per_block, a_vec, w_vec, \
                                                            smem, s);
  DSE_CONV_TILES(DSE_LAUNCH)
  if constexpr (sizeof(XT) == 2 && sizeof(WT) == 2) {
    DSE_CONV_TILES_BF16X(DSE_LAUNCH)
  }
#undef DSE_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace dse
