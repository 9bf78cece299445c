"""Objective speech-quality metric battery.

Counterpart of dl_speech_enhancement_tpu/eval/metrics.py, a numpy / scipy
copy (float64, the same formulas in the same order, so the two agree to
rounding) over the port's ``data/audio_io.py::resample``. The reference
scores reconstructions with PESQ / STOI / SI-SDR / SDR / SNR / Mel-L1 through
pip packages (sandbox.py:101-115, torchmetrics + pesq + pystoi + mir_eval);
these are implemented from their published definitions:

- :func:`stoi`: Short-Time Objective Intelligibility (Taal et al. 2011),
  1/3-octave bands at 10 kHz, 384 ms segments, clipped normalized
  correlation, with the silent-frame removal; ``extended=True`` is ESTOI
  (Jensen & Taal 2016);
- :func:`sdr`: BSS-eval signal-to-distortion ratio, the estimate projected
  on 512-tap delayed copies of the target (a Toeplitz system);
- :func:`si_sdr_best_lag`: SI-SDR after the best global time shift;
- :func:`mel_l1`: the multi-mel L1 distance through the port's
  ``MultiMelSpectrogramLoss`` on the FFT route (``backend='eager'``, the
  JAX package's ``'xla'``), on the device of its inputs;
- SNR, SI-SDR and MAE are the port's losses/metrics.py (torch), re-exported.

PESQ (ITU-T P.862) is not implemented; DNSMOS (eval/dnsmos.py) is the
perceptual metric of record.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.linalg import solve_toeplitz

from dl_speech_enhancement_tpu_torch.data.audio_io import resample
from dl_speech_enhancement_tpu_torch.losses.metrics import (  # re-export
    mean_absolute_error,
    scale_invariant_sdr,
    signal_noise_ratio,
)

__all__ = [
    "stoi", "sdr", "si_sdr_best_lag", "signal_noise_ratio", "scale_invariant_sdr",
    "mean_absolute_error", "mel_l1",
]


# ---------------------------------------------------------------- STOI

_STOI_FS = 10000
_STOI_NFFT = 512  # frames zero-padded to a 512-point FFT
_STOI_HOP = 128   # 50% overlap of 256-sample (25.6 ms) frames
_STOI_WIN = 256
_STOI_N_BANDS = 15
_STOI_MIN_FREQ = 150.0
_STOI_SEG = 30  # frames per 384 ms segment
_STOI_BETA = -15.0  # lower SDR bound (dB)
_STOI_DYN_RANGE = 40.0  # silent-frame removal threshold (dB)


def _third_octave_bands(fs=_STOI_FS, nfft=_STOI_NFFT, n_bands=_STOI_N_BANDS,
                        min_freq=_STOI_MIN_FREQ):
    f = np.linspace(0, fs, nfft + 1)[: nfft // 2 + 1]
    k = np.arange(n_bands)
    cf = 2.0 ** (k / 3.0) * min_freq
    lo = cf * 2 ** (-1.0 / 6.0)
    hi = cf * 2 ** (1.0 / 6.0)
    obm = np.zeros((n_bands, len(f)))
    for i in range(n_bands):
        lo_idx = np.argmin((f - lo[i]) ** 2)
        hi_idx = np.argmin((f - hi[i]) ** 2)
        obm[i, lo_idx:hi_idx] = 1.0
    return obm


def _stft_frames(x, win, hop, nfft):
    flen = len(win)  # frame length; rfft zero-pads to nfft
    n = (len(x) - flen) // hop + 1
    idx = np.arange(n)[:, None] * hop + np.arange(flen)[None, :]
    return np.fft.rfft(x[idx] * win, n=nfft, axis=-1)


def _remove_silent_frames(x, y, dyn_range=_STOI_DYN_RANGE, framelen=256, hop=128):
    w = np.hanning(framelen + 2)[1:-1]
    n = (len(x) - framelen) // hop + 1
    idx = np.arange(n)[:, None] * hop + np.arange(framelen)[None, :]
    energies = 20 * np.log10(np.linalg.norm(x[idx] * w, axis=1) + 1e-12)
    mask = energies > (energies.max() - dyn_range)
    x_out = np.zeros_like(x)
    y_out = np.zeros_like(y)
    count = 0
    for i in range(n):
        if mask[i]:
            s = count * hop
            x_out[s : s + framelen] += x[idx[i]] * w
            y_out[s : s + framelen] += y[idx[i]] * w
            count += 1
    t = count * hop + framelen - hop
    return x_out[:t], y_out[:t]


def _norm_rows(a):
    a = a - a.mean(1, keepdims=True)
    return a / (np.linalg.norm(a, axis=1, keepdims=True) + 1e-12)


def _norm_cols(a):
    a = a - a.mean(0, keepdims=True)
    return a / (np.linalg.norm(a, axis=0, keepdims=True) + 1e-12)


def stoi(clean: np.ndarray, processed: np.ndarray, fs: int,
         extended: bool = False) -> float:
    """Short-Time Objective Intelligibility in [~0, 1]."""
    x = np.asarray(clean, np.float64).reshape(-1)
    y = np.asarray(processed, np.float64).reshape(-1)
    assert x.shape == y.shape
    if fs != _STOI_FS:
        x = resample(x[:, None], fs, _STOI_FS)[:, 0]
        y = resample(y[:, None], fs, _STOI_FS)[:, 0]
    x, y = _remove_silent_frames(x, y)
    if len(x) < _STOI_NFFT:
        return float("nan")
    win = np.hanning(_STOI_WIN + 2)[1:-1]
    X = _stft_frames(x, win, _STOI_HOP, _STOI_NFFT)
    Y = _stft_frames(y, win, _STOI_HOP, _STOI_NFFT)
    obm = _third_octave_bands()
    Xb = np.sqrt(obm @ (np.abs(X.T) ** 2))  # (bands, frames)
    Yb = np.sqrt(obm @ (np.abs(Y.T) ** 2))
    n_frames = Xb.shape[1]
    if n_frames < _STOI_SEG:
        return float("nan")
    scores = []
    for m in range(_STOI_SEG, n_frames + 1):
        Xs = Xb[:, m - _STOI_SEG : m]
        Ys = Yb[:, m - _STOI_SEG : m]
        if extended:
            # ESTOI (Jensen & Taal 2016): row-normalize each band over the
            # segment's frames, THEN column-normalize each frame over
            # bands; the segment distortion is the mean over the N frames
            # of the normalized-column inner products.
            Xn = _norm_cols(_norm_rows(Xs))
            Yn = _norm_cols(_norm_rows(Ys))
            scores.append(np.sum(Xn * Yn) / Xn.shape[1])
        else:
            alpha = np.linalg.norm(Xs, axis=1, keepdims=True) / (
                np.linalg.norm(Ys, axis=1, keepdims=True) + 1e-12
            )
            Ys_c = np.minimum(Ys * alpha, Xs * (1 + 10 ** (-_STOI_BETA / 20)))
            xm = Xs - Xs.mean(1, keepdims=True)
            ym = Ys_c - Ys_c.mean(1, keepdims=True)
            corr = np.sum(xm * ym, 1) / (
                np.linalg.norm(xm, axis=1) * np.linalg.norm(ym, axis=1) + 1e-12
            )
            scores.append(corr.mean())
    return float(np.mean(scores))


# ---------------------------------------------------------------- SDR

def sdr(preds: np.ndarray, target: np.ndarray, filter_length: int = 512,
        zero_mean: bool = False) -> float:
    """BSS-eval SDR: distortion = everything outside the span of
    ``filter_length`` delayed copies of the target."""
    est = np.asarray(preds, np.float64).reshape(-1)
    ref = np.asarray(target, np.float64).reshape(-1)
    if zero_mean:
        est = est - est.mean()
        ref = ref - ref.mean()
    n = len(ref)
    # autocorrelation of ref and cross-correlation ref/est via FFT
    nfft = 1 << int(np.ceil(np.log2(n + filter_length)))
    R = np.fft.rfft(ref, nfft)
    E = np.fft.rfft(est, nfft)
    acf = np.fft.irfft(R * np.conj(R), nfft)[:filter_length]
    xcorr = np.fft.irfft(E * np.conj(R), nfft)
    # cross-corr lags 0..L-1 of sum est[t] ref[t-l]
    ccf = xcorr[:filter_length]
    acf[0] += 1e-10 * acf[0] + 1e-30
    h = solve_toeplitz(acf, ccf)
    # s_target = ref filtered by h
    s_target = np.convolve(ref, h)[:n]
    e = est - s_target
    return float(10 * np.log10(
        (np.sum(s_target ** 2) + 1e-30) / (np.sum(e ** 2) + 1e-30)
    ))


# ---------------------------------------------------- lag-aligned SI-SDR

def si_sdr_best_lag(preds: np.ndarray, target: np.ndarray,
                    max_lag: int = 4800) -> tuple[float, int]:
    """SI-SDR after compensating a single global time shift.

    Plain SI-SDR collapses under even small misalignments (a 1 ms shift of
    otherwise-perfect 48 kHz speech scores < 0 dB), while mel-magnitude
    training losses are shift-tolerant — so a causal enhancement model can
    legitimately converge to a time-shifted solution that raw SI-SDR calls
    garbage. This finds the lag in [-max_lag, +max_lag] maximizing the
    |cross-correlation| (FFT-based, exact), trims both signals to the
    aligned overlap, and returns ``(si_sdr_dB, lag)``. ``lag > 0`` means
    the estimate is DELAYED relative to the target by that many samples.
    Used by the quality-campaign eval to separate "wrong waveform" from
    "right waveform, shifted" (reference measures raw SI-SDR only,
    sandbox.py:101-115).
    """
    est = np.asarray(preds, np.float64).reshape(-1)
    ref = np.asarray(target, np.float64).reshape(-1)
    n = min(len(est), len(ref))
    est, ref = est[:n] - est[:n].mean(), ref[:n] - ref[:n].mean()
    max_lag = int(min(max_lag, n - 1))
    nfft = 1 << int(np.ceil(np.log2(2 * n)))
    E = np.fft.rfft(est, nfft)
    R = np.fft.rfft(ref, nfft)
    # c[k] = sum_t est[t] ref[t - k] (circular; n <= nfft/2 keeps the
    # lags of interest linear)
    c = np.fft.irfft(E * np.conj(R), nfft)
    lags = np.concatenate([np.arange(0, max_lag + 1),
                           np.arange(-max_lag, 0)])
    # NB: c[-0:] would be the WHOLE array, so the negative-lag slice must
    # be empty when max_lag clamps to 0 (single-sample inputs)
    neg = c[-max_lag:] if max_lag > 0 else c[:0]
    vals = np.concatenate([c[: max_lag + 1], neg])
    lag = int(lags[np.argmax(np.abs(vals))])
    if lag >= 0:
        e2, r2 = est[lag:], ref[: n - lag]
    else:
        e2, r2 = est[: n + lag], ref[-lag:]
    e2 = e2 - e2.mean()
    r2 = r2 - r2.mean()
    alpha = float(np.dot(e2, r2)) / (float(np.dot(r2, r2)) + 1e-30)
    proj = alpha * r2
    err = e2 - proj
    val = 10.0 * np.log10((np.sum(proj ** 2) + 1e-30)
                          / (np.sum(err ** 2) + 1e-30))
    return float(val), lag


# ---------------------------------------------------------------- Mel L1

def mel_l1(preds, target, fs: int, **mel_kwargs) -> float:
    """Multi-mel L1 distance (the 'Mel-loss' measure of train_denoise) on the
    FFT route: a measurement takes the FFT pipeline, not the training
    kernel. Runs on the device of ``preds`` (a tensor), else on the CPU."""
    from dl_speech_enhancement_tpu_torch.losses.mel_loss import MultiMelSpectrogramLoss

    device = preds.device if isinstance(preds, torch.Tensor) else torch.device("cpu")
    loss = MultiMelSpectrogramLoss(
        fs=fs, fft_sizes=mel_kwargs.get("fft_sizes", [2048]),
        hop_sizes=mel_kwargs.get("hop_sizes", [300]),
        win_lengths=mel_kwargs.get("win_lengths", [None]),
        num_mels=mel_kwargs.get("num_mels", 80),
        fmin=mel_kwargs.get("fmin", 0),
        fmax=mel_kwargs.get("fmax", fs // 2),
        log_base=mel_kwargs.get("log_base"),
        backend="eager", device=device)
    p = torch.as_tensor(preds, dtype=torch.float32, device=device).reshape(1, -1)
    t = torch.as_tensor(target, dtype=torch.float32, device=device).reshape(1, -1)
    with torch.no_grad():
        return float(loss(p, t))
