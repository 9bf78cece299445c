// dft_spectrum: the training losses' spectral front end, for frames that are
// a strided view of the reflect-padded signal (row r is frame r % n_frames of
// signal r / n_frames, at x + signal * batch_stride + frame * hop, so no frames
// tensor is materialised),
//
//     X = rfft(frame * win),  amp = sqrt(max(|X|^2, eps))   (rows, n_fft/2 + 1)
//
// dse_*_fft / dse_log_mel (K6) then project amp onto the mel filterbank and
// write log(max(amp @ mel, eps)) (natural log, log2 or log10), (rows, n_mels);
// dse_*_fft / dse_stft_magnitude (K7) write amp itself, (rows, n_freq).
//
// Replaces the TPU kernels dl_speech_enhancement_tpu/ops/mel_kernel.py::
// make_fused_log_mel (_kernel :119, call :177) and ::make_fused_stft_magnitude
// (_mag_kernel :247, call :270). Those compute the DFT as products against
// windowed cos / sin bases, with frame blocks and 128-column frequency
// blocks of the bases in VMEM and the partial mel sum carried in the output
// block from one grid step to the next.
//
// Bound: the function needs a real FFT (about 5/2 n_fft log2(n_fft)
// operations a frame) and a sparse mel product (the triangular filterbank's
// nonzeros, about two a frequency), ~0.17 GFLOP at the course's mel loss:
// a few microseconds. K7 is bound by writing its magnitudes, K6 by reading
// the audio. Two arms, picked by n_fft alone in ops/mel_kernel.py::
// spectrum_arm:
//
// FFT arm (power-of-two n_fft, 64 .. 4096; dse_log_mel_fft,
// dse_stft_magnitude_fft). One 256-thread block owns kPoints / (n_fft / 2)
// consecutive rows and computes each row's real FFT in shared memory as an
// N = n_fft / 2 point complex FFT of z[n] = x[2n] w[2n] + i x[2n+1] w[2n+1]:
// - the first Stockham pass (radix 2, 4 or 8, so that the rest are radix 8)
//   loads its butterflies' samples straight from the signal (coalesced; the
//   window multiplies as they load, and samples outside a shorter window's
//   centred range are never read) and writes to shared memory;
// - each later radix-8 pass reads its butterflies (twiddles from a table
//   computed on the host in f64 and rounded, W_{n_fft}^k, no sin/cos on the
//   card), transforms them in registers, waits at a barrier and writes them
//   back in place (Stockham order, so the result is in natural order);
//   re and im sit in separate arrays at a + a / 8 against bank conflicts;
// - the split step gives bins k and N - k from Z[k] and Z[N - k],
//   X[k] = E + W_{n_fft}^k O, X[N - k] = conj(E - W_{n_fft}^k O), and their
//   magnitudes. K7 stores them (consecutive threads, consecutive bins). K6
//   keeps them in shared memory, then sums each (row, mel) over its band's
//   contiguous bins in ascending order with the band's packed weights (a
//   table ops/mel_kernel.py::mel_bands builds from the dense filterbank),
//   clamps, takes the log and writes the row.
// The products run on the CUDA cores in f32, as the reference keeps the DFT
// in f32. Every row is computed by the same instructions whatever its slot
// in a block, so a batch's rows equal the same frames' rows of a
// per-example call bit for bit, and two calls are bit-equal.
//
// GEMM arm (any other n_fft; dse_log_mel, dse_stft_magnitude): the DFT as two
// GEMMs, re = frames @ (win * cos), im = frames @ (-win * sin), 4 n_fft
// operations a frame and frequency (~130x what the function needs). One
// 256-thread block owns a tile of kBM rows. For each kBN-frequency tile, a K
// loop over n_fft in kBK-sample steps stages the frames' samples and both
// bases' rows in shared memory (the next step's elements prefetched into
// registers while the current step's FMAs run) and each thread accumulates
// 2 frames x 4 frequencies of re and of im in f32 registers. K7 writes the
// tile's magnitudes and is done: its grid also spans the frequency tiles.
// K6 loops over the frequency tiles in order: each tile's amplitudes go to
// shared memory and are multiplied by that tile's rows of the mel matrix
// into per-thread (frame, mel) accumulators; after the last tile the clamp
// and the log are applied and the row written. No atomics: every output is
// summed in one fixed order whatever the batch.
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


// ---------------------------------------------------------------- FFT arm

namespace fft {

constexpr int kThreads = 256;
constexpr int kPoints = 2048;  // complex points a block holds: rows x n_fft / 2
// every pass gives each thread the same whole number of radix-8 butterflies
static_assert(kPoints % (8 * kThreads) == 0, "a pass leaves threads without a butterfly");
constexpr int kPadded = kPoints + kPoints / 8;
constexpr int kMinLogN = 5;    // n_fft 64 (ops/mel_kernel.py FFT_N_FFT)
constexpr int kMaxLogN = 11;   // n_fft 4096: one row a block

// shared-memory slot of logical element a: one float of padding every eight
// makes the passes' strided writes and the row-major reads conflict-free or
// nearly so
__device__ __forceinline__ int pad(int a) { return a + (a >> 3); }

struct Smem {
  float re[kPadded];  // row f's element i at pad(f * N + i)
  float im[kPadded];
};

__device__ __forceinline__ float2 add(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 sub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 mul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 neg_i(float2 a) { return make_float2(a.y, -a.x); }  // a * -i

__device__ __forceinline__ void dft2(float2& a0, float2& a1) {
  const float2 t = a0;
  a0 = add(t, a1);
  a1 = sub(t, a1);
}

__device__ __forceinline__ void dft4(float2& a0, float2& a1, float2& a2, float2& a3) {
  const float2 t0 = add(a0, a2), t1 = sub(a0, a2), t2 = add(a1, a3), t3 = neg_i(sub(a1, a3));
  a0 = add(t0, t2);
  a1 = add(t1, t3);
  a2 = sub(t0, t2);
  a3 = sub(t1, t3);
}

// radix 8 as two radix-4 halves (even and odd inputs) joined by W_8^k
__device__ __forceinline__ void dft8(float2 (&v)[8]) {
  constexpr float kS = 0.70710678118654752f;
  dft4(v[0], v[2], v[4], v[6]);
  dft4(v[1], v[3], v[5], v[7]);
  const float2 e0 = v[0], e1 = v[2], e2 = v[4], e3 = v[6], o0 = v[1];
  const float2 o1 = make_float2((v[3].x + v[3].y) * kS, (v[3].y - v[3].x) * kS);
  const float2 o2 = neg_i(v[5]);
  const float2 o3 = make_float2((v[7].y - v[7].x) * kS, -(v[7].x + v[7].y) * kS);
  v[0] = add(e0, o0);
  v[4] = sub(e0, o0);
  v[1] = add(e1, o1);
  v[5] = sub(e1, o1);
  v[2] = add(e2, o2);
  v[6] = sub(e2, o2);
  v[3] = add(e3, o3);
  v[7] = sub(e3, o3);
}

template <int R>
__device__ __forceinline__ void dft(float2 (&v)[R]) {
  if constexpr (R == 2) dft2(v[0], v[1]);
  else if constexpr (R == 4) dft4(v[0], v[1], v[2], v[3]);
  else dft8(v);
}

struct Window {
  const float* w;  // (n_fft) the centred window, zero-padded
  int lo, hi;      // its nonzero range: samples outside it are not read
};

// One radix-R Stockham pass over the block's rows (N = 2^LOG_N points each,
// Ns = 2^log_ns the product of the earlier radices): butterfly b = tid + e *
// kThreads of row f = b / (N / R) takes z[j + r N / R] (j = b % (N / R)),
// multiplies it by W_{Ns R}^{(j % Ns) r}, transforms and writes z[(j / Ns) Ns
// R + j % Ns + r Ns]. The first pass (Ns = 1, every twiddle 1) loads the
// windowed samples from the signal; the others read and write in place.
template <int LOG_N, int R, bool kFirst>
__device__ __forceinline__ void pass(Smem& sm, const Frames& fr, int row0, Window win,
                                     const float2* __restrict__ tw, int log_ns) {
  constexpr int N = 1 << LOG_N, kStride = N / R, kPer = kPoints / (R * kThreads);
  constexpr int kLogR = R == 8 ? 3 : R == 4 ? 2 : 1;
  float2 v[kPer][R];
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int b = threadIdx.x + e * kThreads;
    const int f = b / kStride, j = b % kStride;
    if constexpr (kFirst) {
      const int row = row0 + f;
      const float* xf = nullptr;
      if (row < fr.rows) {
        const int sig = row / fr.n_frames;
        xf = fr.x + sig * fr.batch_stride + (long long)(row - sig * fr.n_frames) * fr.hop;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int t = 2 * (j + r * kStride);
        const bool in0 = xf != nullptr && t >= win.lo && t < win.hi;
        const bool in1 = xf != nullptr && t + 1 >= win.lo && t + 1 < win.hi;
        v[e][r] = make_float2(in0 ? __ldg(xf + t) * __ldg(win.w + t) : 0.f,
                              in1 ? __ldg(xf + t + 1) * __ldg(win.w + t + 1) : 0.f);
      }
    } else {
      const int step = (j & ((1 << log_ns) - 1)) << (LOG_N + 1 - log_ns - kLogR);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int a = pad(f * N + j + r * kStride);
        v[e][r] = make_float2(sm.re[a], sm.im[a]);
      }
#pragma unroll
      for (int r = 1; r < R; ++r) v[e][r] = mul(v[e][r], __ldg(tw + r * step));
    }
    dft<R>(v[e]);
  }
  if constexpr (!kFirst) __syncthreads();  // every input is read before any is overwritten
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int b = threadIdx.x + e * kThreads;
    const int f = b / kStride, j = b % kStride;
    const int d = f * N + ((j >> log_ns) << (log_ns + kLogR)) + (j & ((1 << log_ns) - 1));
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int a = pad(d + (r << log_ns));
      sm.re[a] = v[e][r].x;
      sm.im[a] = v[e][r].y;
    }
  }
  __syncthreads();
}

// Z = the N-point complex FFT of each row's z, in natural order in sm
template <int LOG_N>
__device__ __forceinline__ void transform(Smem& sm, const Frames& fr, int row0, Window win,
                                          const float2* __restrict__ tw) {
  constexpr int kLogFirst = LOG_N % 3 == 0 ? 3 : LOG_N % 3;
  pass<LOG_N, (1 << kLogFirst), true>(sm, fr, row0, win, tw, 0);
#pragma unroll
  for (int log_ns = kLogFirst; log_ns < LOG_N; log_ns += 3)
    pass<LOG_N, 8, false>(sm, fr, row0, win, tw, log_ns);
}

// The real FFT's bins from Z: item (f, k), k = 0 .. N / 2, reads Z[k] and
// Z[N - k] of row f and calls emit(f, k, |X[k]|, |X[N - k]|) (for k = 0 the
// second is bin N; for k = N / 2 both are bin N / 2). An item touches no
// other item's elements, so emit may overwrite them.
template <int LOG_N, class Emit>
__device__ __forceinline__ void split(Smem& sm, const float2* __restrict__ tw, float eps,
                                      Emit emit) {
  constexpr int N = 1 << LOG_N, kHalf = N / 2 + 1, kRows = kPoints / N;
  for (int it = threadIdx.x; it < kRows * kHalf; it += kThreads) {
    const int f = it / kHalf, k = it % kHalf;
    const int a = pad(f * N + k), b = pad(f * N + ((N - k) & (N - 1)));
    const float ar = sm.re[a], ai = sm.im[a], br = sm.re[b], bi = sm.im[b];
    const float2 e = make_float2(0.5f * (ar + br), 0.5f * (ai - bi));  // (Z[k] + conj Z[N-k]) / 2
    const float2 o = make_float2(0.5f * (ai + bi), 0.5f * (br - ar));  // (Z[k] - conj Z[N-k]) / 2i
    const float2 wo = mul(__ldg(tw + k), o);
    emit(f, k, magnitude(e.x + wo.x, e.y + wo.y, eps), magnitude(e.x - wo.x, e.y - wo.y, eps));
  }
}

template <int LOG_N>
__global__ void __launch_bounds__(kThreads)
fft_stft_magnitude_kernel(Frames fr, Window win, const float2* __restrict__ tw, int n_freq,
                          float eps, float* __restrict__ out) {
  constexpr int N = 1 << LOG_N;
  __shared__ __align__(16) Smem sm;
  const int row0 = blockIdx.x * (kPoints / N);
  transform<LOG_N>(sm, fr, row0, win, tw);
  split<LOG_N>(sm, tw, eps, [&](int f, int k, float lo, float hi) {
    const int row = row0 + f;
    if (row >= fr.rows) return;
    float* o = out + (size_t)row * n_freq;
    if (k < n_freq) o[k] = lo;
    if (k != N / 2 && N - k < n_freq) o[N - k] = hi;
  });
}

// bands: (n_mels, 3) int32 (first bin, bins, offset into weights) of each
// mel band's contiguous nonzeros; weights: the packed nonzeros, band-major.
template <int LOG_N>
__global__ void __launch_bounds__(kThreads)
fft_log_mel_kernel(Frames fr, Window win, const float2* __restrict__ tw,
                   const int* __restrict__ bands, const float* __restrict__ weights,
                   int n_mels, float eps, int log_kind, float* __restrict__ out) {
  constexpr int N = 1 << LOG_N, kRows = kPoints / N;
  __shared__ __align__(16) Smem sm;
  const int row0 = blockIdx.x * kRows;
  transform<LOG_N>(sm, fr, row0, win, tw);
  // row f's amplitude of bin k < N in re at pad(f N + k), of bin N in im at pad(f N)
  split<LOG_N>(sm, tw, eps, [&](int f, int k, float lo, float hi) {
    sm.re[pad(f * N + k)] = lo;
    if (k == 0) sm.im[pad(f * N)] = hi;
    else if (k != N / 2) sm.re[pad(f * N + N - k)] = hi;
  });
  __syncthreads();
  const int rows = min(kRows, fr.rows - row0);
  for (int it = threadIdx.x; it < rows * n_mels; it += kThreads) {
    const int f = it / n_mels, m = it - f * n_mels;
    const int first = __ldg(bands + 3 * m), count = __ldg(bands + 3 * m + 1);
    const float* w = weights + __ldg(bands + 3 * m + 2);
    float acc = 0.f;
    for (int i = 0; i < count; ++i) {
      const int k = first + i;
      acc = fmaf(k < N ? sm.re[pad(f * N + k)] : sm.im[pad(f * N)], __ldg(w + i), acc);
    }
    const float v = fmaxf(acc, eps);
    out[(size_t)(row0 + f) * n_mels + m] =
        log_kind == 2 ? log2f(v) : log_kind == 10 ? log10f(v) : logf(v);
  }
}

// log2(n_fft / 2) of a power-of-two n_fft the arm takes, else -1
inline int log_points(int n_fft) {
  for (int l = kMinLogN; l <= kMaxLogN; ++l)
    if (n_fft == 2 << l) return l;
  return -1;
}

}  // namespace fft

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

// The FFT arm. win: (n_fft) f32 window, zero outside [win_lo, win_hi);
// twiddles: (n_fft, 2) f32, W_{n_fft}^k = exp(-2 pi i k / n_fft); n_fft a
// power of two in 64 .. 4096. bands, weights: mel band table
// (ops/mel_kernel.py::mel_bands), n_mels <= 128. The rest as dse_log_mel.
extern "C" int dse_log_mel_fft(const float* x, long long batch_stride, int hop, int n_frames,
                               int rows, int n_fft, const float* win, int win_lo, int win_hi,
                               const float* twiddles, const int* bands, const float* weights,
                               int n_mels, float eps, int log_kind, float* out, void* stream) {
  if (rows <= 0) return 0;
  const int log_n = dse::fft::log_points(n_fft);
  if (log_n < 0 || n_mels < 1 || n_mels > dse::kMelGroups * 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const dse::Frames fr{x, batch_stride, hop, n_frames, rows, n_fft};
  const dse::fft::Window w{win, win_lo, win_hi};
  const float2* tw = reinterpret_cast<const float2*>(twiddles);
  const int per_block = dse::fft::kPoints >> log_n;
  const dim3 grid((rows + per_block - 1) / per_block);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DSE_FFT_LOG_MEL(L)                                                                  \
  case L:                                                                                   \
    dse::fft::fft_log_mel_kernel<L><<<grid, dse::fft::kThreads, 0, st>>>(                   \
        fr, w, tw, bands, weights, n_mels, eps, log_kind, out);                             \
    break
  switch (log_n) {
    DSE_FFT_LOG_MEL(5);
    DSE_FFT_LOG_MEL(6);
    DSE_FFT_LOG_MEL(7);
    DSE_FFT_LOG_MEL(8);
    DSE_FFT_LOG_MEL(9);
    DSE_FFT_LOG_MEL(10);
    DSE_FFT_LOG_MEL(11);
  }
#undef DSE_FFT_LOG_MEL
  return static_cast<int>(cudaGetLastError());
}

// As dse_log_mel_fft's front end; out: (rows, n_freq) magnitudes, n_freq <=
// n_fft / 2 + 1.
extern "C" int dse_stft_magnitude_fft(const float* x, long long batch_stride, int hop,
                                      int n_frames, int rows, int n_fft, const float* win,
                                      int win_lo, int win_hi, const float* twiddles, int n_freq,
                                      float eps, float* out, void* stream) {
  if (rows <= 0) return 0;
  const int log_n = dse::fft::log_points(n_fft);
  if (log_n < 0 || n_freq < 1 || n_freq > n_fft / 2 + 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const dse::Frames fr{x, batch_stride, hop, n_frames, rows, n_fft};
  const dse::fft::Window w{win, win_lo, win_hi};
  const float2* tw = reinterpret_cast<const float2*>(twiddles);
  const int per_block = dse::fft::kPoints >> log_n;
  const dim3 grid((rows + per_block - 1) / per_block);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DSE_FFT_STFT(L)                                                                     \
  case L:                                                                                   \
    dse::fft::fft_stft_magnitude_kernel<L><<<grid, dse::fft::kThreads, 0, st>>>(            \
        fr, w, tw, n_freq, eps, out);                                                       \
    break
  switch (log_n) {
    DSE_FFT_STFT(5);
    DSE_FFT_STFT(6);
    DSE_FFT_STFT(7);
    DSE_FFT_STFT(8);
    DSE_FFT_STFT(9);
    DSE_FFT_STFT(10);
    DSE_FFT_STFT(11);
  }
#undef DSE_FFT_STFT
  return static_cast<int>(cudaGetLastError());
}
