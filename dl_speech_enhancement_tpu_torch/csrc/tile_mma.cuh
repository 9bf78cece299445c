// Block-level tap GEMM on the tensor cores, for hifigan_unit.cu and
// residual_chain.cu.
//
//     out[m][n] = sum_{j < taps} sum_{ci < K} A[(m + j * a_step) * lda + ci] * W_j[ci][n]
//
// A is a window in shared memory (a dilated conv reads it at a_step =
// dilation, conv2 at 1); W_j is tap j's (K, ldw_g) row-major weights in
// device memory, of which the block computes `ncols` columns. Two arms, by
// the weights' type:
//
// f32 weights, f32 window: `mma.sync.aligned.m16n8k8` with TF32 operands
// and f32 sums. A single TF32 pass rounds each operand at 2^-11, ~1e-3 over
// a 2,816-term stage-0 sum (tests/test_torch_port_unit_plan.py emulates
// it), far above the 1e-4 the kernel is held to, so both operands are split:
// a = a_hi + a_lo with a_hi = rna_tf32(a), a_lo = rna_tf32(a - a_hi), which
// leaves ~2^-22 of a, and a_hi*w_hi + a_lo*w_hi + a_hi*w_lo, 3 passes. The
// tensor core's own sum inside one mma is not specified to round to
// nearest, so each (tap, 64-channel) step sums into fresh fragments (big:
// a_hi*w_hi, small: the rest; each split into even and odd 8-channel
// slices), and the running f32 sum then takes acc + ((big_even + big_odd) +
// (small_even + small_odd)) with round-to-nearest adds: the order of every
// output element's sum is fixed by (tap, channel) alone, whatever the
// block's rows and columns are, so two plans give the same bits.
//
// bf16 weights, bf16 window: the reference multiplies bf16 by bf16 (its
// operands rounded to the weight dtype) with f32 sums, so the caller's
// window holds the rounded operands and each product is one
// `mma.sync.aligned.m16n8k16` with bf16 operands and an f32 accumulator,
// at the dense bf16 rate: A fragments by `ldmatrix.x4` from the row-major
// window (channels contiguous, the k of the product), B fragments by
// `ldmatrix.trans` from the ring's (k, n) rows. A step's four 16-channel
// slices go into fresh even and odd fragments, and the running f32 sum
// takes acc + (even + odd): again an order fixed by (tap, channel) alone.
//
// Warps: 8, as a kWarpsM x kWarpsN grid of (16 * WM)-row x (8 * kWN)-column
// warp tiles; a block tile is BM = 16 * WM * kWarpsM rows by BN = 8 * NF
// columns and walks M in BM-row chunks. A step's time is mostly latency, so
// a warp with more fragments (WM, kWN) does more work in about the same
// time, and a step spans 64 channels so that its barrier is paid less
// often. W reaches shared memory through cp.async into a ring of kStages
// (tap, kKC-channel) tiles, so the next tiles are in flight while one is
// multiplied; each block reads only its own columns.
#pragma once

#include <cstdint>

#include "tile_gemm.cuh"

namespace dse {

constexpr int kWarps = kThreads / 32;
constexpr int kKC = 64;     // input channels per ring stage: one barrier per 64
constexpr int kStages = 4;  // W ring depth: 3 tiles in flight cover the L2 latency

// NF 8-column fragments across the block (1, 2, 4 or 8), WM 16-row
// fragments per warp (1, 2 or 4). kRows puts the warps along the rows first
// (one warp column, two for NF 8), so that each warp loads (and splits) an A
// fragment for all of its columns at once rather than its share of them.
template <int NF, int WM, bool kRows = false>
struct MmaTile {
  static constexpr int kWarpsN = kRows ? (NF < 8 ? 1 : 2) : NF < 4 ? NF : 4;
  static constexpr int kWN = NF / kWarpsN;       // fragments per warp along n
  static constexpr int kWarpsM = kWarps / kWarpsN;
  static constexpr int BM = 16 * WM * kWarpsM;   // rows per chunk
  static constexpr int BN = 8 * NF;
  static constexpr int LDW = BN + 8;             // padded ring row: B fragments hit 32 banks
};

// cvt.rna.tf32.f32 as two integer operations (the instruction itself is a
// longer sequence on sm_90): round the magnitude to 10 mantissa bits, ties
// away from zero. Equal to it for every finite and infinite input.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a (16 x 16, bf16, row) * b (16 x 8, bf16, col), f32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 matrices from shared memory, lanes 8i .. 8i + 7 giving
// the 16-byte rows of matrix i; r[i] is this lane's pair of matrix i (row
// lane / 4, columns 2 * (lane % 4) and the next). With .trans the pair is
// of column lane / 4, rows 2 * (lane % 4) and the next.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(a));
}

// Copies `bytes` (4, 8 or 16) from global to shared memory without the
// registers; with src_bytes 0 it writes zeros and reads nothing.
template <int bytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src),
               "n"(bytes), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending));
}

// Bytes of the W ring for NF fragments of WT weights.
template <int NF, typename WT>
__host__ __device__ constexpr int ring_bytes() {
  return kStages * kKC * MmaTile<NF, 1>::LDW * (int)sizeof(WT);
}

// Computes out rows [0, M) and columns [0, ncols) and hands each result to
// epi(m, n, value). A (AE: f32 with f32 weights, bf16 with bf16 weights) has
// zeros in columns [K, K rounded up to 8 (f32) or 16 (bf16)) and rows up to M
// rounded up to 16 plus (taps - 1) * a_step (what they hold there only
// reaches rows >= M); a bf16 window's rows are 16-byte aligned. w points
// at tap 0, input channel 0, the block's first column; tap j starts w_tap
// elements later, a channel ldw_g later; its rows and the block's columns
// are 16-byte aligned (ncols a multiple of 4). `ring` holds ring_bytes<NF, WT>(). Cp.async groups the caller
// committed before the call land before the first product, after which
// `ready()` runs in every thread (the caller's own copies are then visible
// to it). `prologue()`, if given, runs in every thread once the first ring
// stages are in flight, before anything is read: a caller may fill A there
// with plain stores, hiding the weights' latency. All threads call it with
// the same scalars; it ends with a barrier.
struct NoPrologue {
  __device__ void operator()() const {}
};

template <int NF, int WM, typename WT, bool kRows = false, typename AE, typename Ready,
          typename Epi, typename Prologue = NoPrologue>
__device__ __forceinline__ void mma_tap_gemm(int M, int taps, int a_step, int K,
                                             const AE* A, int lda, const WT* w,
                                             long long w_tap, int ldw_g, int ncols, WT* ring,
                                             Ready ready, Epi epi,
                                             Prologue prologue = Prologue()) {
  using T = MmaTile<NF, WM, kRows>;
  constexpr int kVec = 4;                        // weights per cp.async
  constexpr int kChunks = kKC * T::BN / kVec;    // cp.async per ring stage
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gid = lane / 4, tig = lane % 4;
  const int wm = warp / T::kWarpsN, wn = warp % T::kWarpsN;
  const int k_slices = (K + kKC - 1) / kKC;
  const int steps = taps * k_slices;
  bool first = true;
  int lj = 0, lc0 = 0, ls = 0;  // the next (tap, channel, ring stage) to load
  // This thread's share of a ring stage: the same (row, column) every step.
  constexpr int kPer = (kChunks + kThreads - 1) / kThreads;
  int row[kPer], src_off[kPer], dst_off[kPer];
  bool mine[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int q = tid + i * kThreads, col = (q % (T::BN / kVec)) * kVec;
    row[i] = q / (T::BN / kVec);
    mine[i] = q < kChunks && col < ncols;
    src_off[i] = row[i] * ldw_g + col;
    dst_off[i] = row[i] * T::LDW + col;
  }

  auto load = [&] {
    if (lj < taps) {
      WT* dst = ring + ls * kKC * T::LDW;
      const WT* src = w + lj * w_tap + (size_t)lc0 * ldw_g;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        if (kChunks % kThreads == 0 || tid + i * kThreads < kChunks) {
          const bool ok = mine[i] && lc0 + row[i] < K;
          cp_async<kVec * (int)sizeof(WT)>(dst + dst_off[i], ok ? src + src_off[i] : w,
                                           ok ? kVec * (int)sizeof(WT) : 0);
        }
      }
      lc0 += kKC;
      if (lc0 >= K) lc0 = 0, ++lj;
      ls = ls + 1 == kStages ? 0 : ls + 1;
    }
    cp_async_commit();
  };

  for (int mb = 0; mb < M; mb += T::BM) {
    const int m_warp = mb + wm * 16 * WM;
    bool live[WM];  // this warp's 16-row fragments that hold rows < M
#pragma unroll
    for (int mi = 0; mi < WM; ++mi) live[mi] = m_warp + 16 * mi < M;
    float acc[WM][T::kWN][4];
#pragma unroll
    for (int mi = 0; mi < WM; ++mi)
#pragma unroll
      for (int f = 0; f < T::kWN; ++f)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mi][f][i] = 0.f;
    lj = lc0 = ls = 0;
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) load();
    if (mb == 0) prologue();
    int j = 0, c0 = 0, stage = 0;
    for (int step = 0; step < steps; ++step) {
      cp_async_wait<kStages - 2>();
      if (first) {
        ready();
        first = false;
      }
      __syncthreads();  // this step's tile is in; the stage loaded next is free
      load();
      if constexpr (sizeof(AE) == 2) {
        static_assert(sizeof(WT) == 2, "a bf16 window takes bf16 weights");
        if (live[0]) {
          const WT* Ws = ring + stage * kKC * T::LDW;
          // this lane's ldmatrix rows: A row lane % 16 of a fragment at
          // channel 8 * (lane / 16); W k row lane % 16 at column 8 * (lane / 16)
          const AE* a_row =
              A + (size_t)(m_warp + lane % 16 + j * a_step) * lda + c0 + lane / 16 * 8;
          const WT* w_row = Ws + (lane % 16) * T::LDW + wn * T::kWN * 8 + lane / 16 * 8;
          float part[2][WM][T::kWN][4];  // even and odd 16-channel slices
#pragma unroll
          for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int mi = 0; mi < WM; ++mi)
#pragma unroll
              for (int f = 0; f < T::kWN; ++f)
#pragma unroll
                for (int i = 0; i < 4; ++i) part[e][mi][f][i] = 0.f;
          const int k16 = min(kKC, K - c0 + 15) / 16;  // 16-channel slices left in K
#pragma unroll
          for (int kk = 0; kk < kKC / 16; ++kk) {
            if (kk >= k16) break;
            uint32_t b[T::kWN][2];
#pragma unroll
            for (int f = 0; f < T::kWN; f += 2) {
              if constexpr (T::kWN == 1) {
                ldmatrix_x2_trans(b[0][0], b[0][1], w_row + kk * 16 * T::LDW);
              } else {  // fragments f and f + 1 in one load
                uint32_t r[4];
                ldmatrix_x4_trans(r, w_row + kk * 16 * T::LDW + f * 8);
                b[f][0] = r[0], b[f][1] = r[1], b[f + 1][0] = r[2], b[f + 1][1] = r[3];
              }
            }
#pragma unroll
            for (int mi = 0; mi < WM; ++mi) {
              if (mi > 0 && !live[mi]) continue;
              uint32_t a[4];
              ldmatrix_x4(a, a_row + (size_t)mi * 16 * lda + kk * 16);
#pragma unroll
              for (int f = 0; f < T::kWN; ++f) mma_bf16(part[kk % 2][mi][f], a, b[f][0], b[f][1]);
            }
          }
#pragma unroll
          for (int mi = 0; mi < WM; ++mi)
#pragma unroll
            for (int f = 0; f < T::kWN; ++f)
#pragma unroll
              for (int i = 0; i < 4; ++i) acc[mi][f][i] += part[0][mi][f][i] + part[1][mi][f][i];
        }
      } else if (live[0]) {
        static_assert(sizeof(WT) == 4, "an f32 window takes f32 weights");
        const WT* Ws = ring + stage * kKC * T::LDW;
        const float* a_row = A + (size_t)(m_warp + gid + j * a_step) * lda + c0 + tig;
        // two chains per product (even and odd 8-channel slices), so one
        // mma's latency does not hold up the next
        float big[2][WM][T::kWN][4], small[2][WM][T::kWN][4];
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int mi = 0; mi < WM; ++mi)
#pragma unroll
            for (int f = 0; f < T::kWN; ++f)
#pragma unroll
              for (int i = 0; i < 4; ++i) big[e][mi][f][i] = small[e][mi][f][i] = 0.f;
        const int k8 = min(kKC, K - c0 + 7) / 8;  // 8-channel slices left in K
#pragma unroll
        for (int kk = 0; kk < kKC / 8; ++kk) {
          if (kk >= k8) break;
          uint32_t bh[T::kWN][2], bl[T::kWN][2];
#pragma unroll
          for (int f = 0; f < T::kWN; ++f) {
            const int n = (wn * T::kWN + f) * 8 + gid;
            split_tf32(Ws[(kk * 8 + tig) * T::LDW + n], bh[f][0], bl[f][0]);
            split_tf32(Ws[(kk * 8 + tig + 4) * T::LDW + n], bh[f][1], bl[f][1]);
          }
#pragma unroll
          for (int mi = 0; mi < WM; ++mi) {
            if (mi > 0 && !live[mi]) continue;
            uint32_t hi[4], lo[4];
            const float* a = a_row + (size_t)mi * 16 * lda + kk * 8;
            split_tf32(a[0], hi[0], lo[0]);
            split_tf32(a[8 * lda], hi[1], lo[1]);
            split_tf32(a[4], hi[2], lo[2]);
            split_tf32(a[8 * lda + 4], hi[3], lo[3]);
#pragma unroll
            for (int f = 0; f < T::kWN; ++f) {
              float(&bg)[4] = big[kk % 2][mi][f];
              float(&sm)[4] = small[kk % 2][mi][f];
              mma_tf32(bg, hi, bh[f][0], bh[f][1]);
              mma_tf32(sm, lo, bh[f][0], bh[f][1]);
              mma_tf32(sm, hi, bl[f][0], bl[f][1]);
            }
          }
        }
#pragma unroll
        for (int mi = 0; mi < WM; ++mi)
#pragma unroll
          for (int f = 0; f < T::kWN; ++f)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              acc[mi][f][i] += (big[0][mi][f][i] + big[1][mi][f][i]) +
                               (small[0][mi][f][i] + small[1][mi][f][i]);
      }
      c0 += kKC;
      if (c0 >= K) c0 = 0, ++j;
      stage = stage + 1 == kStages ? 0 : stage + 1;
    }
    cp_async_wait<0>();
    __syncthreads();  // every warp is done with the ring before it is refilled
#pragma unroll
    for (int mi = 0; mi < WM; ++mi) {
      if (!live[mi]) continue;
#pragma unroll
      for (int f = 0; f < T::kWN; ++f)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int m = m_warp + 16 * mi + gid + (i >= 2 ? 8 : 0);
          const int n = (wn * T::kWN + f) * 8 + tig * 2 + (i & 1);
          if (m < M && n < ncols) epi(m, n, acc[mi][f][i]);
        }
    }
  }
  __syncthreads();
}

}  // namespace dse
