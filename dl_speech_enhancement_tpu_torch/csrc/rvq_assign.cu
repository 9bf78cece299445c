// rvq_assign: the residual-VQ nearest-codeword search of the symAD codec,
// emitting the flattened int32 wire codes,
//
//     r = z[row]
//     for l < L:  dist[k] = (|r|^2 - 2 r.E_l[:, k]) + |E_l[:, k]|^2
//                 ind     = argmin_k dist (lowest index on ties)
//                 r      -= E_l[:, ind]
//                 codes[row, l] = ind + l*K
//
// with books E (L, D, K) f32 in the JAX package's VQState layout and their
// squared norms (L, K) f32. Replaces the residual-VQ part of the TPU kernel
// dl_speech_enhancement_tpu/ops/mega_kernel.py::make_mega_stream.enc_kernel
// (:418-432), which loops over the L books inside its body with the books
// resident in VMEM.
//
// What bounds it on an H100: 2*D*K operations per row and book (1.05 MFLOP a
// code row at D=64, K=1024, L=8) against the 2 MB of books, so bytes below
// some 40 rows and f32 operations above. At one frame (4 rows) the time is
// the chain of the L stages: each needs the previous stage's residual.
//
// Design: a thread-block cluster of C = 1-16 blocks splits K; block j owns
// codewords [j*S, (j+1)*S) (S = 4 * groups, a power of two of groups; the
// last slice is masked where C*S > K). Each block copies its slice of every
// book and of the squared norms into shared memory once, with 16-byte
// cp.async copies that arrive on one mbarrier a book, two books ahead of the
// stage that needs them, so stage l waits only for book l (1-D bulk copies,
// one a (book, d) run of S floats, measured slower on the card: a block's 520
// copies of 256 bytes queue in its copy engine). Where the slices of all L
// books do not fit (and in the plans for many rows, so that two blocks share
// an SM), the slots form a ring of book stages, refilled as each stage is
// passed. The slices stay resident while the cluster walks its share of row
// tiles (persistent clusters, as many as the card runs at once). Per stage,
// for the tile's rows:
// - each thread holds CW consecutive codewords (one 8- or 16-byte shared load
//   per d serves all its RT rows; CW = 2 at few rows, so that twice the warps
//   hide the loads' latency, else 4) and computes each (row, codeword) dot
//   product whole, in ascending d, with fmaf from 0; a block of 4 or 8 d's
//   loads its operands before its products;
// - the distance is (|r|^2 - 2 r.E) + |E|^2 with rounded, uncontracted
//   operations, as the plain version writes it; the thread keeps its best by
//   a strict < in ascending k, then the row group's best by the total order
//   `better` (smaller distance, then lower index) over warp shuffles;
// - the row group's lanes store that candidate into every block of the
//   cluster, itself too (st.async into distributed shared memory,
//   double-buffered by the stage's parity), completing on the receiver's
//   mbarrier, so no cluster barrier is needed (bulk copies of a block's
//   candidates measured slower at few rows); a block waits for its own C
//   candidates of each row;
// - where the tile's rows times max(C, D / 4) lanes fit the block, one pass of
//   that many lanes a row merges the row's candidates by `better`,
//   subtracts the winner's D floats, read from books_t (L, K, D) in L2
//   (contiguous; read from the owner's slot through distributed shared
//   memory, where the column is strided, it measured 6x slower), and takes
//   |r|^2; else a thread a row merges in rank order, then every element
//   moves at once, then |r|^2. |r|^2 sums each 16-byte chunk's squares in
//   order, then the D / 4 chunks by an xor tree over lanes, where D / 4 is a
//   power of two up to 32, else the squares in ascending d: one order for a
//   given D. Block 0 writes the codes; no finite distance gives index 0, the
//   answer of argmin on an all-NaN row.
// A block may store into a peer's candidates of stage l+2 only after the
// peer has sent its own of stage l+1, which it does after its merge of stage
// l, so the two buffers suffice. Every (row, codeword) distance is the same
// sequence of f32 operations whatever the plan (cluster, tile, clusters,
// stages), B or N, and the merge is a total order: a row's codes do not
// depend on the plan. The plan comes from ops/mega_kernel.py::_rvq_plan (pure
// Python); its rvq_smem_bytes equals dse_rvq_assign_smem, its
// rvq_block_threads dse_rvq_assign_threads.
#include <cooperative_groups.h>

#include <math.h>

#include "async_copy.cuh"
#include "tile_gemm.cuh"

namespace cg = cooperative_groups;

namespace dse {
namespace {

constexpr int kMaxThreads = 512;
constexpr int kWideThreads = 256;  // a block takes more threads only at 8 rows a thread
constexpr int kMaxCluster = 16;
constexpr int kMaxGroups = 32;  // codeword groups of 4 a block: at most 128 codewords
constexpr int kMaxDim = 1024;
constexpr int kBooksAhead = 2;  // resident books in flight ahead of the stage that needs them

__host__ __device__ inline int round4(int n) { return (n + 3) / 4 * 4; }

// Groups of 4 codewords each block of a `cluster`-block cluster owns: the
// least power of two that covers ceil(K / cluster).
__host__ __device__ inline int rvq_groups(int K, int cluster) {
  const int per = (K + cluster - 1) / cluster;
  int w = 1;
  while (4 * w < per) w *= 2;
  return w;
}

// Row stride of the residual tile: D rounded up to 4, plus 4, so that two
// rows read by one warp start in different banks.
__host__ __device__ inline int rvq_ldr(int D) { return round4(D) + 4; }

// Shared memory of one block: the mbarriers (one a book slot, two for the
// candidates), `stages` book slots (S * D codeword floats and S norms each),
// the residual tile, per row |r|^2 and the pick, and two buffers of the
// cluster's candidates (C a row).
inline size_t rvq_smem(int tile, int D, int K, int cluster, int stages) {
  const size_t S = 4 * (size_t)rvq_groups(K, cluster);
  return (size_t)(8 * (stages + 2) + 15) / 16 * 16 +
         sizeof(float) * ((size_t)stages * S * (D + 1) + (size_t)tile * rvq_ldr(D) +
                          (4 * (size_t)cluster + 2) * round4(tile));
}

// Rows a thread carries: the fewest of 1, 2, 4, 8 that keep a block within
// 256 threads (groups threads a row group), else 8 (up to 512 threads).
inline int rvq_rows_per_thread(int tile, int groups) {
  int rt = 1;
  while (rt < 8 && groups * ((tile + rt - 1) / rt) > kWideThreads) rt *= 2;
  return rt;
}

// Codewords a thread: 2 where a row group of 2 S / 4 lanes fits a warp and
// carries the tile at one row a thread (few rows: twice the warps to hide
// the loads' latency), else 4.
inline int rvq_codewords_per_thread(int tile, int groups) {
  return 2 * groups <= 32 && 2 * groups * tile <= kMaxThreads ? 2 : 4;
}

inline int rvq_threads(int tile, int groups, int rt) {
  return (groups * ((tile + rt - 1) / rt) + 31) / 32 * 32;
}

// |r|^2 of a residual row (16-byte aligned), summed in ascending d; each
// block of 32 floats is loaded before its sum.
__device__ __forceinline__ float row_norm(const float* r, int D) {
  float s = 0.f;
  int d = 0;
  for (; d + 32 <= D; d += 32) {
    float4 v[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) v[q] = *reinterpret_cast<const float4*>(r + d + 4 * q);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      s = __fadd_rn(s, __fmul_rn(v[q].x, v[q].x));
      s = __fadd_rn(s, __fmul_rn(v[q].y, v[q].y));
      s = __fadd_rn(s, __fmul_rn(v[q].z, v[q].z));
      s = __fadd_rn(s, __fmul_rn(v[q].w, v[q].w));
    }
  }
  for (; d < D; ++d) s = __fadd_rn(s, __fmul_rn(r[d], r[d]));
  return s;
}

// The sum of squares of a row held as 16-byte chunks, chunk x in lane x of n
// consecutive lanes (n a power of two up to 32; chunks past the row are
// zeros; every lane of the warp calls it): each chunk's squares in order,
// then the chunks by an xor tree, a fixed order whatever n is, that leaves
// the sum in every lane.
__device__ __forceinline__ float chunk_norm(float4 v, int n) {
  float s = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(v.x, v.x), __fmul_rn(v.y, v.y)),
                                __fmul_rn(v.z, v.z)),
                      __fmul_rn(v.w, v.w));
  for (int off = n / 2; off > 0; off >>= 1) s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
  return s;
}

// (d, i) beats (bd, bi): smaller distance, or the same one at a lower index
__device__ __forceinline__ bool better(float d, int i, float bd, int bi) {
  return d < bd || (d == bd && i < bi);
}

// Merges (d, i) over n consecutive lanes (n a power of two up to 32) by
// `better`; every lane ends with the winner.
__device__ __forceinline__ void merge_lanes(float& d, int& i, int n) {
  for (int off = n / 2; off > 0; off >>= 1) {
    const float od = __shfl_xor_sync(0xffffffffu, d, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (better(od, oi, d, i)) {
      d = od;
      i = oi;
    }
  }
}

struct RvqArgs {
  const float* z;
  const float* books;
  const float* sqnorm;
  const float* books_t;  // (L, K, D): the winner's codeword from L2
  int* codes;
  int R, D, K, L;
  int S;        // codewords a block owns
  int tile;     // rows a cluster carries through the L stages at once
  int stages;   // book slots: L holds every book resident, fewer make a ring
  int async;    // slices arrive by 16-byte cp.async copies (else by the threads' loads)
  int chunks;   // D / 4 where rows move as 16-byte chunks (a power of two up to 32), else 0
};

// CW consecutive floats of shared memory (8- or 16-byte aligned).
template <int CW>
__device__ __forceinline__ void load_cw(float (&v)[CW], const float* p) {
  if constexpr (CW == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x, v[1] = t.y;
  }
}

// acc[i][j] = r_i . E[:, CW kg + j] over d in ascending order, with fmaf from
// 0. A block of DB d's loads its operands before its products.
template <int RT, int CW>
__device__ __forceinline__ void dot(float (&acc)[RT][CW], const float* res, const int (&rr)[RT],
                                    int ldr, const float* ec, int S, int D) {
  constexpr int DB = RT <= 2 ? 8 : 4;
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < CW; ++j) acc[i][j] = 0.f;
  int d = 0;
#pragma unroll(RT <= 2 ? 2 : 1)
  for (; d + DB <= D; d += DB) {
    float4 rv[RT][DB / 4];
    float e[DB][CW];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int q = 0; q < DB / 4; ++q)
        rv[i][q] = *reinterpret_cast<const float4*>(res + (size_t)rr[i] * ldr + d + 4 * q);
#pragma unroll
    for (int u = 0; u < DB; ++u) load_cw<CW>(e[u], ec + (size_t)(d + u) * S);
#pragma unroll
    for (int u = 0; u < DB; ++u)
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const float4 v = rv[i][u / 4];
        const float r = u % 4 == 0 ? v.x : u % 4 == 1 ? v.y : u % 4 == 2 ? v.z : v.w;
#pragma unroll
        for (int j = 0; j < CW; ++j) acc[i][j] = fmaf(r, e[u][j], acc[i][j]);
      }
  }
  for (; d < D; ++d) {
    float e[CW];
    load_cw<CW>(e, ec + (size_t)d * S);
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const float r = res[(size_t)rr[i] * ldr + d];
#pragma unroll
      for (int j = 0; j < CW; ++j) acc[i][j] = fmaf(r, e[j], acc[i][j]);
    }
  }
}

template <int RT, int CW>
__global__ void __launch_bounds__(kMaxThreads) rvq_assign_kernel(const RvqArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int cid = blockIdx.x / C, n_clusters = gridDim.x / C;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int D = a.D, K = a.K, L = a.L, S = a.S, W = S / CW, tile = a.tile, NS = a.stages;
  const int ldr = rvq_ldr(D), T4 = round4(tile), P = a.chunks;
  const size_t slot_floats = (size_t)S * (D + 1);

  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);  // [NS] book slots
  uint64_t* cbar = bar + NS;                             // [2] candidate buffers
  float* slots = reinterpret_cast<float*>(smem + (8 * (NS + 2) + 15) / 16 * 16);
  float* res = slots + NS * slot_floats;
  float* rsq = res + (size_t)tile * ldr;
  int* pick = reinterpret_cast<int*>(rsq + T4);
  int2* cand = reinterpret_cast<int2*>(pick + T4);  // [2][C][T4] (distance bits, index)

  const int k0 = rank * S;
  const int valid = max(0, min(S, K - k0));  // this block's codewords
  const int n_tiles = (a.R + tile - 1) / tile;
  const int my_tiles = (n_tiles - cid + n_clusters - 1) / n_clusters;
  const bool resident = NS >= L;
  const int loads = resident ? L : my_tiles * L;  // book slices this block loads
  const unsigned cand_bytes = (unsigned)(C * tile * sizeof(int2));

  // Load g (book g % L) into slot g % NS: D runs of the book's rows and one
  // of its norms, every thread arriving on the slot's barrier once its own
  // copies have landed.
  auto issue = [&](int g) {
    const int slot = g % NS, l = g % L;
    float* dst = slots + slot * slot_floats;
    const float* book = a.books + (size_t)l * D * K + k0;
    const float* norm = a.sqnorm + (size_t)l * K + k0;
    if (a.async) {
      const int n16 = valid / 4;  // 16-byte chunks a run
      for (int e = tid; e < (D + 1) * n16; e += nthreads) {
        const int q = e / n16, c = 4 * (e - q * n16);
        cp_async_16(dst + (size_t)q * S + c, (q < D ? book + (size_t)q * K : norm) + c);
      }
      cp_async_arrive(&bar[slot]);
    } else {
      for (int e = tid; e < (D + 1) * valid; e += nthreads) {
        const int q = e / valid, k = e - q * valid;
        dst[(size_t)q * S + k] = q < D ? book[(size_t)q * K + k] : norm[k];
      }
      mbar_arrive(&bar[slot]);
    }
  };

  // resident books go kBooksAhead ahead of the stages (so that stage 0 does
  // not wait behind every book's copies), a ring fills all its slots
  const int first = resident ? min(kBooksAhead, L) : min(NS, loads);
  if (tid == 0) {
    for (int s = 0; s < NS; ++s) mbar_init(&bar[s], nthreads);
    mbar_init(&cbar[0], 1);
    mbar_init(&cbar[1], 1);
    mbar_init_fence();
  }
  __syncthreads();
  cluster_arrive();  // this block's barriers exist: peers may store into it once they wait
  for (int g = 0; g < first; ++g) issue(g);

  const int kg = tid & (W - 1), rg = tid / W;  // codewords CW kg.., row group
  int step = 0;                                // stages run: the candidates' parity
  for (int it = 0, t = cid; t < n_tiles; ++it, t += n_clusters) {
    const int r0 = t * tile, rows = min(tile, a.R - r0);
    // the tile's rows (zeros past the last) and their |r|^2
    if (P) {
      const float4* z4 = reinterpret_cast<const float4*>(a.z) + (size_t)r0 * P;
      for (int q0 = 0; q0 < tile * P; q0 += nthreads) {
        const int q = q0 + tid, row = q / P, x = q - row * P;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (q < tile * P && row < rows) v = z4[q];
        if (q < tile * P) *reinterpret_cast<float4*>(res + (size_t)row * ldr + 4 * x) = v;
        const float s = chunk_norm(v, P);
        if (x == 0 && q < tile * P) rsq[row] = s;
      }
    } else {
      for (int e = tid; e < tile * ldr; e += nthreads) {
        const int row = e / ldr, d = e - row * ldr;
        res[e] = row < rows && d < D ? a.z[(size_t)(r0 + row) * D + d] : 0.f;
      }
      __syncthreads();
      for (int row = tid; row < tile; row += nthreads)
        rsq[row] = row_norm(res + (size_t)row * ldr, D);
    }
    __syncthreads();

    for (int l = 0; l < L; ++l, ++step) {
      const int g = resident ? l : it * L + l;
      const int slot = g % NS, par = step & 1;
      if (tid == 0) mbar_arrive_expect_tx(&cbar[par], cand_bytes);  // this stage's phase
      mbar_wait(&bar[slot], (g / NS) & 1);
      const float* E = slots + slot * slot_floats;

      // dot products of RT rows with CW codewords, each whole in ascending d
      int rr[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i) rr[i] = min(rg * RT + i, tile - 1);
      float acc[RT][CW];
      dot<RT, CW>(acc, res, rr, ldr, E + CW * kg, S, D);

      // each row's best in this block: the thread's (strict < over ascending
      // k keeps the lowest index among equals), then across its row group
      if (step == 0) cluster_wait();  // every block's barriers exist
      float nk[CW];
      load_cw<CW>(nk, E + (size_t)D * S + CW * kg);
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const float rs = rsq[rr[i]];
        float bd = INFINITY;
        int bi = K;
#pragma unroll
        for (int j = 0; j < CW; ++j) {
          if (CW * kg + j < valid) {
            const float dist = __fadd_rn(__fsub_rn(rs, __fmul_rn(2.f, acc[i][j])), nk[j]);
            if (dist < bd) {
              bd = dist;
              bi = k0 + CW * kg + j;
            }
          }
        }
        merge_lanes(bd, bi, W);
        // the row group's lanes store the candidate into every block of the
        // cluster, itself too, completing on the receiver's barrier
        const int row = rg * RT + i;
        if (row < tile) {
          const int2* dst = cand + ((size_t)par * C + rank) * T4 + row;
          for (int j = kg; j < C; j += W)
            st_async_v2(cluster_addr(dst, j), __float_as_int(bd), bi, cluster_addr(&cbar[par], j));
        }
      }

      // the next resident book's copies go out while the candidates travel
      if (resident && it == 0 && l + first < L) issue(l + first);
      // merge the C candidates of each row, subtract the winner's D floats
      // from the row (read from books_t (L, K, D) in L2, where a codeword is
      // contiguous) and take |r|^2
      mbar_wait_cluster(&cbar[par], (step >> 1) & 1);
      const float* bt = a.books_t + (size_t)l * K * D;
      const int G = P > C ? P : C;  // lanes a row in the single pass below
      const bool refill = !resident && g + NS < loads;
      if (P && tile * G <= nthreads) {
        // one pass, G lanes a row: lane j < C reads block j's candidate, the
        // merge leaves the winner in every lane, lane x < P moves chunk x
        const int row = tid / G, x = tid & (G - 1);
        float bd = INFINITY;
        int bi = K;
        if (row < tile && x < C) {
          const int2 c = cand[((size_t)par * C + x) * T4 + row];
          bd = __int_as_float(c.x);
          bi = c.y;
        }
        merge_lanes(bd, bi, G);
        const int k = bi >= K ? 0 : bi;  // no finite distance: argmin's answer for all-NaN rows
        if (x == 0 && rank == 0 && row < rows) a.codes[(size_t)(r0 + row) * L + l] = k + l * K;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (row < tile && x < P) {
          const float4 c = *reinterpret_cast<const float4*>(bt + (size_t)k * D + 4 * x);
          float4* rp = reinterpret_cast<float4*>(res + (size_t)row * ldr + 4 * x);
          v = *rp;
          v.x = __fsub_rn(v.x, c.x);
          v.y = __fsub_rn(v.y, c.y);
          v.z = __fsub_rn(v.z, c.z);
          v.w = __fsub_rn(v.w, c.w);
          *rp = v;
        }
        const float s = chunk_norm(v, G);
        if (x == 0 && row < tile) rsq[row] = s;
        __syncthreads();  // a ring slot is refilled once every thread has read it
        if (refill) issue(g + NS);
        continue;
      }
      // else: a thread a row merges in rank order, then every element moves
      // at once, then |r|^2
      for (int row = tid; row < tile; row += nthreads) {
        int2 c[kMaxCluster];
#pragma unroll
        for (int j = 0; j < kMaxCluster; ++j)
          if (j < C) c[j] = cand[((size_t)par * C + j) * T4 + row];
        float bd = INFINITY;
        int bi = K;
#pragma unroll
        for (int j = 0; j < kMaxCluster; ++j)
          if (j < C && better(__int_as_float(c[j].x), c[j].y, bd, bi)) {
            bd = __int_as_float(c[j].x);
            bi = c[j].y;
          }
        const int k = bi >= K ? 0 : bi;
        pick[row] = k;
        if (rank == 0 && row < rows) a.codes[(size_t)(r0 + row) * L + l] = k + l * K;
      }
      __syncthreads();
      if (refill) issue(g + NS);
      const int per_row = D % 4 == 0 ? D / 4 : D;  // 16-byte chunks, else floats
      for (int q0 = 0; q0 < tile * per_row; q0 += 4 * nthreads) {
        float4 c[4];
        int at[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int q = q0 + u * nthreads + tid;
          at[u] = -1;
          if (q < tile * per_row) {
            const int row = q / per_row, x = q - row * per_row;
            const float* src = bt + (size_t)pick[row] * D;
            if (D % 4 == 0) {
              c[u] = *reinterpret_cast<const float4*>(src + 4 * x);
              at[u] = row * ldr + 4 * x;
            } else {
              c[u].x = src[x];
              at[u] = row * ldr + x;
            }
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (at[u] < 0) continue;
          if (D % 4 == 0) {
            float4 v = *reinterpret_cast<float4*>(res + at[u]);
            v.x = __fsub_rn(v.x, c[u].x);
            v.y = __fsub_rn(v.y, c[u].y);
            v.z = __fsub_rn(v.z, c[u].z);
            v.w = __fsub_rn(v.w, c[u].w);
            *reinterpret_cast<float4*>(res + at[u]) = v;
          } else {
            res[at[u]] = __fsub_rn(res[at[u]], c[u].x);
          }
        }
      }
      __syncthreads();
      // |r|^2 in the same order as the single pass: a lane a chunk (P), else
      // a thread a row in ascending d
      if (P) {
        for (int q0 = 0; q0 < tile * P; q0 += nthreads) {
          const int q = q0 + tid, row = q / P, x = q - row * P;
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (q < tile * P) v = *reinterpret_cast<const float4*>(res + (size_t)row * ldr + 4 * x);
          const float s = chunk_norm(v, P);
          if (x == 0 && q < tile * P) rsq[row] = s;
        }
      } else {
        for (int row = tid; row < tile; row += nthreads)
          rsq[row] = row_norm(res + (size_t)row * ldr, D);
      }
      __syncthreads();
    }
  }
  cluster.sync();  // no block leaves while a peer may still store into its shared memory
}

template <int RT, int CW>
cudaError_t launch(const RvqArgs& a, int cluster, int clusters, size_t smem,
                   cudaStream_t stream, int* max_clusters) {
  static size_t configured = 0;
  static bool wide = false;  // clusters above 8 blocks allowed
  auto kernel = rvq_assign_kernel<RT, CW>;
  cudaError_t err = allow_smem(kernel, smem, &configured);
  if (err != cudaSuccess) return err;
  if (cluster > 8 && !wide) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    wide = true;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * cluster);
  cfg.blockDim = dim3(rvq_threads(a.tile, a.S / CW, RT));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (max_clusters) return cudaOccupancyMaxActiveClusters(max_clusters, kernel, &cfg);
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Checks a plan and launches it (or, with `max_clusters`, asks how many of
// its clusters the card holds at once).
cudaError_t run(const float* z, const float* books, const float* sqnorm, const float* books_t,
                int* codes, int R, int D, int K, int L, int cluster, int tile, int clusters,
                int stages, cudaStream_t stream, int* max_clusters) {
  if (R <= 0 || D <= 0 || D > kMaxDim || K <= 0 || L <= 0 || cluster < 1 ||
      cluster > kMaxCluster || (cluster & (cluster - 1)) != 0 || tile <= 0 || clusters <= 0 ||
      clusters > (R + tile - 1) / tile || stages < (L < 2 ? L : 2) || stages > L ||
      (books_t == nullptr && codes != nullptr) ||
      (D % 4 == 0 && reinterpret_cast<uintptr_t>(books_t) % 16 != 0))
    return cudaErrorInvalidValue;
  const int groups = rvq_groups(K, cluster);
  const int cw = rvq_codewords_per_thread(tile, groups);
  const int rt = cw == 2 ? 1 : rvq_rows_per_thread(tile, groups);
  if (groups > kMaxGroups || (cluster - 1) * 4 * groups >= K ||
      4 * groups / cw * ((tile + rt - 1) / rt) > kMaxThreads ||
      (long long)clusters * cluster > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const size_t smem = rvq_smem(tile, D, K, cluster, stages);
  if (smem > 232448) return cudaErrorInvalidValue;
  RvqArgs a;
  a.z = z;
  a.books = books;
  a.sqnorm = sqnorm;
  a.books_t = books_t;
  a.codes = codes;
  a.R = R;
  a.D = D;
  a.K = K;
  a.L = L;
  a.S = 4 * groups;
  a.tile = tile;
  a.stages = stages;
  a.chunks = D % 4 == 0 && D <= 128 && ((D / 4) & (D / 4 - 1)) == 0 &&
                     (reinterpret_cast<uintptr_t>(z) | reinterpret_cast<uintptr_t>(books_t)) % 16 == 0
                 ? D / 4
                 : 0;
  a.async = K % 4 == 0 &&
            (reinterpret_cast<uintptr_t>(books) | reinterpret_cast<uintptr_t>(sqnorm)) % 16 == 0;

  if (cw == 2) return launch<1, 2>(a, cluster, clusters, smem, stream, max_clusters);
  switch (rt) {
    case 1: return launch<1, 4>(a, cluster, clusters, smem, stream, max_clusters);
    case 2: return launch<2, 4>(a, cluster, clusters, smem, stream, max_clusters);
    case 4: return launch<4, 4>(a, cluster, clusters, smem, stream, max_clusters);
    default: return launch<8, 4>(a, cluster, clusters, smem, stream, max_clusters);
  }
}

}  // namespace
}  // namespace dse

// Shared memory one block takes for a tile of `tile` rows when a cluster of
// `cluster` blocks splits K, with `stages` book slots.
extern "C" size_t dse_rvq_assign_smem(int tile, int D, int K, int cluster, int stages) {
  return dse::rvq_smem(tile, D, K, cluster, stages);
}

// Threads of a block at `tile` rows when a cluster of `cluster` blocks splits
// K (ops/mega_kernel.py::rvq_block_threads mirrors it).
extern "C" int dse_rvq_assign_threads(int tile, int K, int cluster) {
  const int groups = dse::rvq_groups(K, cluster);
  const int cw = dse::rvq_codewords_per_thread(tile, groups);
  const int rt = cw == 2 ? 1 : dse::rvq_rows_per_thread(tile, groups);
  return dse::rvq_threads(tile, 4 * groups / cw, rt);
}

// How many clusters of a plan the card runs at once (into *out).
extern "C" int dse_rvq_assign_max_clusters(int R, int D, int K, int L, int cluster, int tile,
                                           int stages, int* out) {
  return dse::run(nullptr, nullptr, nullptr, nullptr, nullptr, R, D, K, L, cluster, tile, 1,
                  stages, nullptr, out);
}

// z (R, D), books (L, D, K), sqnorm (L, K) and books_t (L, K, D) f32 ->
// codes (R, L) int32, at the plan (cluster, tile, clusters, stages) of
// ops/mega_kernel.py::_rvq_plan.
extern "C" int dse_rvq_assign(const float* z, const float* books, const float* sqnorm,
                              const float* books_t, int* codes, int R, int D, int K, int L,
                              int cluster, int tile, int clusters, int stages, void* stream) {
  return dse::run(z, books, sqnorm, books_t, codes, R, D, K, L, cluster, tile, clusters, stages,
                  static_cast<cudaStream_t>(stream), nullptr);
}
