"""STFT front end, matched to ``torch.stft(center=True)``.

Counterpart of dl_speech_enhancement_tpu/dsp/stft.py: reflect-pad the
signal by ``n_fft // 2`` on both sides, slide windows of ``n_fft`` samples
at the hop, apply a periodic Hann window of ``win_length`` zero-padded
symmetrically to ``n_fft``, one-sided real FFT. Frames keep the JAX layout,
``(..., n_frames, n_freq)``. The FFT is ``torch.fft.rfft``, as the JAX
package leaves it to XLA; the DFT kernels of the training losses are in
``ops/mel_kernel.py``. :func:`spectrogram` is the UnivNet discriminators'
front end.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(win_length: int, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """Periodic Hann window, computed in f64 as the JAX package does."""
    n = np.arange(win_length)
    w = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / win_length))
    return torch.as_tensor(w, dtype=dtype, device=device)


def _padded_window(window: torch.Tensor, n_fft: int) -> torch.Tensor:
    """Zero-pad a window symmetrically to n_fft (torch.stft convention)."""
    win_length = window.shape[-1]
    if win_length == n_fft:
        return window
    left = (n_fft - win_length) // 2
    return F.pad(window, (left, n_fft - win_length - left))


def frame_signal(x: torch.Tensor, frame_length: int, hop: int) -> torch.Tensor:
    """Overlapping frames of ``x (..., T)``: ``(..., n_frames, frame_length)``
    with ``n_frames = (T - frame_length) // hop + 1``, a strided view."""
    return x.unfold(-1, frame_length, hop)


def reflect_pad(x: torch.Tensor, pad: int, mode: str = "reflect") -> torch.Tensor:
    """Pad the last axis of ``x (..., T)`` by ``pad`` on both sides."""
    lead = x.shape[:-1]
    flat = x.reshape(-1, 1, x.shape[-1])
    return F.pad(flat, (pad, pad), mode=mode).reshape(*lead, -1)


def stft(x: torch.Tensor, window: torch.Tensor, *, n_fft: int, hop: int,
         win_length: int | None = None, center: bool = True,
         pad_mode: str = "reflect") -> torch.Tensor:
    """Complex STFT of ``x (..., T)`` -> ``(..., n_frames, n_fft // 2 + 1)``."""
    if center:
        x = reflect_pad(x, n_fft // 2, pad_mode)
    frames = frame_signal(x, n_fft, hop)
    w = _padded_window(window, n_fft).to(frames.dtype)
    return torch.fft.rfft(frames * w, n=n_fft, dim=-1)


def stft_magnitude(x: torch.Tensor, window: torch.Tensor, *, n_fft: int, hop: int,
                   win_length: int | None = None, center: bool = True,
                   eps: float = 1e-7) -> torch.Tensor:
    """Magnitude spectrogram ``sqrt(clamp(|STFT|^2, eps))``: the clamp is on
    the power, before the square root."""
    z = stft(x, window, n_fft=n_fft, hop=hop, win_length=win_length, center=center)
    power = z.real * z.real + z.imag * z.imag
    return torch.sqrt(torch.clamp(power, min=eps))


def spectrogram(x: torch.Tensor, window: torch.Tensor, *, n_fft: int, hop: int,
                win_length: int, pad: int = 0, power: float = 1.0,
                eps: float = 1e-9) -> torch.Tensor:
    """torchaudio-style spectrogram of ``x (..., T)`` -> ``(..., n_frames,
    n_freq)``: zero-pad by ``pad`` on both sides, then a centred (reflect)
    STFT. ``eps`` floors the power before the square root: the zero-padded
    frames have exactly zero power, where sqrt's gradient is infinite, and
    adversarial training through this front end would NaN."""
    if pad > 0:
        x = F.pad(x, (pad, pad))
    z = stft(x, window, n_fft=n_fft, hop=hop, win_length=win_length, center=True)
    mag = torch.sqrt(torch.clamp(z.real * z.real + z.imag * z.imag, min=eps))
    if power == 1.0:
        return mag
    return mag ** power
