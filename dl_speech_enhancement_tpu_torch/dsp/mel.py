"""Mel filterbank and log-mel spectrogram.

Counterpart of dl_speech_enhancement_tpu/dsp/mel.py. The filterbank is the
Slaney mel scale with Slaney area normalisation (librosa's ``htk=False``),
a numpy copy of the JAX package's. :class:`MelSpectrogram` picks its route
by ``backend``:

- ``'eager'``: the FFT pipeline (``dsp/stft.py``), STFT -> power -> clamped
  amplitude -> mel matmul -> clamp -> log;
- ``'cuda'``: the fused DFT kernel (K6, ``ops/mel_kernel.py``) on the card;
- ``'plain'``: that kernel's plain PyTorch version, the same DFT as two
  matmuls (checks compare the kernel route with it);
- ``'auto'``: ``'cuda'`` on a CUDA device, ``'eager'`` on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from dl_speech_enhancement_tpu_torch.dsp.stft import hann_window, stft_magnitude
from dl_speech_enhancement_tpu_torch.utils.device import resolve_device

# Slaney mel-scale constants (as used by librosa htk=False).
_F_SP = 200.0 / 3.0
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def hz_to_mel(f, htk: bool = False):
    f = np.asarray(f, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    mel = f / _F_SP
    log_region = f >= _MIN_LOG_HZ
    return np.where(
        log_region,
        _MIN_LOG_MEL + np.log(np.maximum(f, 1e-10) / _MIN_LOG_HZ) / _LOGSTEP,
        mel,
    )


def mel_to_hz(m, htk: bool = False):
    m = np.asarray(m, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f = m * _F_SP
    log_region = m >= _MIN_LOG_MEL
    return np.where(log_region, _MIN_LOG_HZ * np.exp(_LOGSTEP * (m - _MIN_LOG_MEL)), f)


def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float = 0.0,
                   fmax: float | None = None, htk: bool = False,
                   norm: str | None = "slaney", dtype=np.float32) -> np.ndarray:
    """Triangular mel filterbank, ``(n_fft // 2 + 1, n_mels)`` (librosa's
    transpose, so that ``amplitudes @ melmat`` projects)."""
    if fmax is None:
        fmax = sr / 2.0
    n_freqs = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sr / 2.0, n_freqs)
    mel_pts = np.linspace(hz_to_mel(fmin, htk), hz_to_mel(fmax, htk), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts, htk)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    if norm == "slaney":
        enorm = 2.0 / (hz_pts[2: n_mels + 2] - hz_pts[:n_mels])
        weights *= enorm[:, None]
    return weights.T.astype(dtype)


def apply_log(mel: torch.Tensor, log_base: float | None) -> torch.Tensor:
    if log_base is None:
        return torch.log(mel)
    if log_base == 2.0:
        return torch.log2(mel)
    if log_base == 10.0:
        return torch.log10(mel)
    raise ValueError(f"log_base: {log_base} is not supported.")


def log_mel_spectrogram(x: torch.Tensor, window: torch.Tensor, melmat: torch.Tensor, *,
                        n_fft: int, hop: int, win_length: int | None = None,
                        eps: float = 1e-10, log_base: float | None = 10.0) -> torch.Tensor:
    """Log-mel spectrogram ``(..., n_frames, n_mels)`` through the FFT:
    STFT -> power -> clamped amplitude -> mel matmul -> clamp -> log."""
    amp = stft_magnitude(x, window, n_fft=n_fft, hop=hop, win_length=win_length, eps=eps)
    return apply_log(torch.clamp(amp @ melmat.to(amp.dtype), min=eps), log_base)


class MelSpectrogram:
    """Configured log-mel front end (the reference's MelSpectrogram module).

    Builds the window, the mel matrix and, on the DFT routes, the kernel's
    bases once, on ``device``. Takes (B, T) or (B, C, T) waveforms (channels
    fold into the batch) and returns (B', n_frames, n_mels)."""

    def __init__(self, fs: int = 22050, fft_size: int = 1024, hop_size: int = 256,
                 win_length: int | None = None, window: str = "hann_window",
                 num_mels: int = 80, fmin: float | None = 80, fmax: float | None = 7600,
                 eps: float = 1e-10, log_base: float | None = 10.0, backend: str = "auto",
                 device="cuda"):
        # imported here: ops/mel_kernel.py builds its bases from this module
        from dl_speech_enhancement_tpu_torch.ops.mel_kernel import (
            make_fused_log_mel,
            resolve_spectrum_backend,
        )

        if window != "hann_window":
            raise NotImplementedError(f"window: {window}")
        if log_base not in (None, 2.0, 10.0):
            raise ValueError(f"log_base: {log_base} is not supported.")
        self.device = resolve_device(device)
        self.fft_size = fft_size
        self.hop_size = hop_size
        self.win_length = win_length if win_length is not None else fft_size
        self.eps = eps
        self.log_base = log_base
        self.window = hann_window(self.win_length, device=self.device)
        fmin = 0.0 if fmin is None else fmin
        fmax = fs / 2.0 if fmax is None else fmax
        self.melmat = torch.from_numpy(
            mel_filterbank(fs, fft_size, num_mels, fmin=fmin, fmax=fmax)).to(self.device)
        self.backend = resolve_spectrum_backend(backend, self.device)
        self._fused = None
        if self.backend in ("cuda", "plain"):
            self._fused = make_fused_log_mel(
                fs, fft_size, hop_size, self.win_length, num_mels, fmin=fmin, fmax=fmax,
                eps=eps, log_base=log_base, device=self.device, plain=self.backend == "plain")

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 3:  # (B, C, T) -> (B*C, T)
            x = x.reshape(-1, x.shape[-1])
        if self._fused is not None:
            return self._fused(x)
        return log_mel_spectrogram(x, self.window, self.melmat, n_fft=self.fft_size,
                                   hop=self.hop_size, win_length=self.win_length,
                                   eps=self.eps, log_base=self.log_base)
