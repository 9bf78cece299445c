// dft_spectrum: the training losses' spectral front end as a real DFT in two
// GEMMs, for frames that are a strided view of the reflect-padded signal,
//
//     re = frames @ (win * cos),  im = frames @ (-win * sin)    (n_fft, n_freq_p)
//     amp = sqrt(max(re^2 + im^2, eps))
//
// dse_log_mel (K6) then projects amp onto the mel filterbank and writes
// log(max(amp @ mel, eps)) (natural log, log2 or log10), (rows, n_mels);
// dse_stft_magnitude (K7) writes amp itself, (rows, n_freq).
//
// Replaces the TPU kernels dl_speech_enhancement_tpu/ops/mel_kernel.py::
// make_fused_log_mel (_kernel :119, call :177) and ::make_fused_stft_magnitude
// (_mag_kernel :247, call :270). Those keep frame blocks and 128-column
// frequency blocks of the bases in VMEM and carry the partial mel sum in the
// output block from one grid step to the next.
//
// Cost: the DFT as GEMMs does 4 * n_fft operations per frame and frequency
// (two multiply-adds a sample for re and im): ~22 GFLOP at the course's mel
// loss (2,576 frames, n_fft 2048, 1,025 frequencies), 0.33 ms at the f32
// rate of 67 TFLOP/s. The function needs ~130x fewer: a real FFT is about
// 5/2 * n_fft * log2(n_fft) a frame and the mel filterbank is sparse, ~0.17
// GFLOP, so its bound is a few microseconds and these kernels, written to be
// right first, sit far from it.
//
// Design: one 256-thread block owns a tile of kBM frames (rows of the
// view: row r is frame r % n_frames of signal r / n_frames, at x + signal *
// batch_stride + frame * hop, so no frames tensor is materialised). For each
// kBN-frequency tile, a K loop over n_fft in kBK-sample steps stages the
// frames' samples and both bases' rows in shared memory (the next step's
// elements prefetched into registers while the current step's FMAs run) and
// each thread accumulates 2 frames x 4 frequencies of re and of im in f32
// registers. K7 writes the tile's magnitudes and is done: its grid also
// spans the frequency tiles. K6 loops over the frequency tiles in order: each
// tile's amplitudes go to shared memory and are multiplied by that tile's
// rows of the mel matrix into per-thread (frame, mel) accumulators; after
// the last tile the clamp and the log are applied and the row written. No
// atomics: every output is summed in one fixed order whatever the batch, so
// a batch's rows equal the same frames' rows of a per-example call bit for
// bit. The products run on the CUDA cores in f32, as the reference keeps the
// DFT in f32.
#include <cuda_runtime.h>

#include <math.h>

#include "error.cuh"

namespace dse {

constexpr int kThreads = 256;
constexpr int kBM = 32;          // frames per block
constexpr int kBN = 64;          // frequencies per tile (ops/mel_kernel.py FREQ_TILE)
constexpr int kBK = 32;          // samples per K step
constexpr int kLDA = kBM + 4;    // staged frames, [kBK][kLDA] (column-major)
constexpr int kLDAmp = kBN + 1;  // staged amplitudes, [kBM][kLDAmp]
constexpr int kTM = 2;           // frames per thread
constexpr int kTN = 4;           // frequencies per thread
constexpr int kColThreads = kBN / kTN;  // 16
constexpr int kMelGroups = kThreads / kBM;  // 8 groups of mel columns

static_assert(kThreads / kColThreads * kTM == kBM, "thread tile does not cover the frames");

struct Frames {
  const float* x;          // the padded signal, (signals, length) at batch_stride
  long long batch_stride;  // elements between signals
  int hop;                 // elements between frames
  int n_frames;            // frames per signal
  int rows;                // signals * n_frames
  int n_fft;
};

struct Smem {
  float a[kBK][kLDA];
  float c[kBK][kBN];
  float s[kBK][kBN];
  float amp[kBM][kLDAmp];
  long long row_off[kBM];
};

__device__ __forceinline__ void frame_offsets(const Frames& fr, int m0, Smem& sm) {
  if (threadIdx.x < kBM) {
    const int r = m0 + threadIdx.x;
    long long off = 0;
    if (r < fr.rows) {
      const int sig = r / fr.n_frames;
      off = sig * fr.batch_stride + (long long)(r - sig * fr.n_frames) * fr.hop;
    }
    sm.row_off[threadIdx.x] = off;
  }
  __syncthreads();
}

// re/im of frames [m0, m0 + kBM) at frequencies [f0, f0 + kBN): thread
// (ty, tx) = (tid / 16, tid % 16) owns frames m0 + 2 ty + {0, 1} and
// frequencies f0 + 4 tx + {0..3}. The bases are (>= n_fft, ldb) row-major,
// ldb a multiple of kBN, 16-byte aligned.
__device__ __forceinline__ void dft_tile(const Frames& fr, int m0, const float* __restrict__ cosb,
                                         const float* __restrict__ sinb, int ldb, int f0,
                                         Smem& sm, float re[kTM][kTN], float im[kTM][kTN]) {
  constexpr int kAPer = kBK * kBM / kThreads;            // 4 samples a thread
  constexpr int kWPer = kBK * kBN / (4 * kThreads);      // 2 float4 of each basis
  const int tid = threadIdx.x;
  const int tx = tid % kColThreads, ty = tid / kColThreads;
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int q = 0; q < kTN; ++q) re[i][q] = im[i][q] = 0.f;
  float ra[kAPer];
  float4 rc[kWPer], rs[kWPer];
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kAPer; ++i) {
      const int e = tid + i * kThreads;
      const int m = e / kBK, k = k0 + e % kBK;
      ra[i] = (m0 + m < fr.rows && k < fr.n_fft) ? __ldg(fr.x + sm.row_off[m] + k) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kWPer; ++i) {
      const int e = tid + i * kThreads;
      const int k = k0 + e / (kBN / 4), n = f0 + (e % (kBN / 4)) * 4;
      const bool in = k < fr.n_fft;
      rc[i] = in ? __ldg(reinterpret_cast<const float4*>(cosb + (size_t)k * ldb + n)) : zero4;
      rs[i] = in ? __ldg(reinterpret_cast<const float4*>(sinb + (size_t)k * ldb + n)) : zero4;
    }
  };
  fetch(0);
  for (int k0 = 0; k0 < fr.n_fft; k0 += kBK) {
    __syncthreads();  // the previous step's tiles are consumed
#pragma unroll
    for (int i = 0; i < kAPer; ++i) {
      const int e = tid + i * kThreads;
      sm.a[e % kBK][e / kBK] = ra[i];
    }
#pragma unroll
    for (int i = 0; i < kWPer; ++i) {
      const int e = tid + i * kThreads;
      const int kk = e / (kBN / 4), n = (e % (kBN / 4)) * 4;
      *reinterpret_cast<float4*>(&sm.c[kk][n]) = rc[i];
      *reinterpret_cast<float4*>(&sm.s[kk][n]) = rs[i];
    }
    __syncthreads();
    if (k0 + kBK < fr.n_fft) fetch(k0 + kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float2 a = *reinterpret_cast<const float2*>(&sm.a[kk][ty * kTM]);
      const float4 c = *reinterpret_cast<const float4*>(&sm.c[kk][tx * kTN]);
      const float4 s = *reinterpret_cast<const float4*>(&sm.s[kk][tx * kTN]);
      const float av[kTM] = {a.x, a.y};
      const float cv[kTN] = {c.x, c.y, c.z, c.w};
      const float sv[kTN] = {s.x, s.y, s.z, s.w};
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int q = 0; q < kTN; ++q) {
          re[i][q] = fmaf(av[i], cv[q], re[i][q]);
          im[i][q] = fmaf(av[i], sv[q], im[i][q]);
        }
    }
  }
}

// sqrt(max(re^2 + im^2, eps)), the products and the sum rounded one by one
// as the plain version computes them
__device__ __forceinline__ float magnitude(float re, float im, float eps) {
  return sqrtf(fmaxf(__fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im)), eps));
}

__global__ void __launch_bounds__(kThreads)
stft_magnitude_kernel(Frames fr, const float* __restrict__ cosb, const float* __restrict__ sinb,
                      int ldb, int n_freq, float eps, float* __restrict__ out) {
  __shared__ __align__(16) Smem sm;
  const int m0 = blockIdx.x * kBM, f0 = blockIdx.y * kBN;
  frame_offsets(fr, m0, sm);
  float re[kTM][kTN], im[kTM][kTN];
  dft_tile(fr, m0, cosb, sinb, ldb, f0, sm, re, im);
  const int tx = threadIdx.x % kColThreads, ty = threadIdx.x / kColThreads;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = m0 + ty * kTM + i;
#pragma unroll
    for (int q = 0; q < kTN; ++q) {
      const int f = f0 + tx * kTN + q;
      if (r < fr.rows && f < n_freq)
        out[(size_t)r * n_freq + f] = magnitude(re[i][q], im[i][q], eps);
    }
  }
}

// MPT mel columns per thread: thread t owns frame m0 + t % kBM and mel
// columns (t / kBM) * MPT + {0 .. MPT-1}, so a warp reads one mel row
// element at a time (a broadcast) and the staged amplitudes conflict-free.
template <int MPT>
__global__ void __launch_bounds__(kThreads)
log_mel_kernel(Frames fr, const float* __restrict__ cosb, const float* __restrict__ sinb,
               int ldb, const float* __restrict__ mel, int n_mels, float eps, int log_kind,
               float* __restrict__ out) {
  __shared__ __align__(16) Smem sm;
  const int m0 = blockIdx.x * kBM;
  frame_offsets(fr, m0, sm);
  const int tx = threadIdx.x % kColThreads, ty = threadIdx.x / kColThreads;
  const int row = threadIdx.x % kBM, c0 = (threadIdx.x / kBM) * MPT;
  float acc[MPT];
#pragma unroll
  for (int i = 0; i < MPT; ++i) acc[i] = 0.f;
  for (int f0 = 0; f0 < ldb; f0 += kBN) {
    float re[kTM][kTN], im[kTM][kTN];
    dft_tile(fr, m0, cosb, sinb, ldb, f0, sm, re, im);
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int q = 0; q < kTN; ++q)
        sm.amp[ty * kTM + i][tx * kTN + q] = magnitude(re[i][q], im[i][q], eps);
    __syncthreads();
    for (int j = 0; j < kBN; ++j) {
      const float a = sm.amp[row][j];
      const float* mrow = mel + (size_t)(f0 + j) * n_mels;
#pragma unroll
      for (int i = 0; i < MPT; ++i) {
        const int c = c0 + i;
        acc[i] = fmaf(a, c < n_mels ? __ldg(mrow + c) : 0.f, acc[i]);
      }
    }
    __syncthreads();  // the amplitudes are consumed before the next tile's
  }
  const int r = m0 + row;
  if (r >= fr.rows) return;
#pragma unroll
  for (int i = 0; i < MPT; ++i) {
    const int c = c0 + i;
    if (c >= n_mels) continue;
    const float v = fmaxf(acc[i], eps);
    out[(size_t)r * n_mels + c] = log_kind == 2 ? log2f(v) : log_kind == 10 ? log10f(v) : logf(v);
  }
}

}  // namespace dse

// x: the padded signals; frame r starts at x + (r / n_frames) * batch_stride
// + (r % n_frames) * hop. cosb, sinb: (>= n_fft, ldb) row-major f32, ldb a
// multiple of 64 with zero columns past the last frequency. mel: (ldb,
// n_mels) row-major, zero rows past the last frequency, n_mels <= 128.
// log_kind: 0 natural, 2 base 2, 10 base 10. out: (rows, n_mels).
extern "C" int dse_log_mel(const float* x, long long batch_stride, int hop, int n_frames,
                           int rows, int n_fft, const float* cosb, const float* sinb, int ldb,
                           const float* mel, int n_mels, float eps, int log_kind, float* out,
                           void* stream) {
  if (rows <= 0) return 0;
  if (ldb % dse::kBN != 0 || n_mels < 1 || n_mels > dse::kMelGroups * 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const dse::Frames fr{x, batch_stride, hop, n_frames, rows, n_fft};
  const dim3 grid((rows + dse::kBM - 1) / dse::kBM);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int mpt = (n_mels + dse::kMelGroups - 1) / dse::kMelGroups;
#define DSE_LOG_MEL(M)                                                                     \
  dse::log_mel_kernel<M><<<grid, dse::kThreads, 0, st>>>(fr, cosb, sinb, ldb, mel, n_mels, \
                                                         eps, log_kind, out)
  if (mpt <= 2) DSE_LOG_MEL(2);
  else if (mpt <= 4) DSE_LOG_MEL(4);
  else if (mpt <= 8) DSE_LOG_MEL(8);
  else if (mpt <= 12) DSE_LOG_MEL(12);
  else DSE_LOG_MEL(16);
#undef DSE_LOG_MEL
  return static_cast<int>(cudaGetLastError());
}

// As dse_log_mel's front end; out: (rows, n_freq) magnitudes.
extern "C" int dse_stft_magnitude(const float* x, long long batch_stride, int hop, int n_frames,
                                  int rows, int n_fft, const float* cosb, const float* sinb,
                                  int ldb, int n_freq, float eps, float* out, void* stream) {
  if (rows <= 0) return 0;
  if (ldb % dse::kBN != 0 || n_freq > ldb) return static_cast<int>(cudaErrorInvalidValue);
  const dse::Frames fr{x, batch_stride, hop, n_frames, rows, n_fft};
  const dim3 grid((rows + dse::kBM - 1) / dse::kBM, ldb / dse::kBN);
  dse::stft_magnitude_kernel<<<grid, dse::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      fr, cosb, sinb, ldb, n_freq, eps, out);
  return static_cast<int>(cudaGetLastError());
}
