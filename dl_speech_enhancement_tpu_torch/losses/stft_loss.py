"""Multi-resolution STFT loss (spectral convergence + log magnitude).

Counterpart of dl_speech_enhancement_tpu/losses/stft_loss.py. ``backend``
picks the magnitude's route as in :mod:`dsp.mel`: ``'cuda'`` the K7 kernel,
``'plain'`` its plain version, ``'eager'`` the FFT, ``'auto'`` the kernel
on the card and the FFT on the CPU. ``group`` spreads the batch over the
ranks of a process group: spectral convergence's norms are then taken over
all of them (the log-magnitude term is a mean, and stays local).
"""

from __future__ import annotations

import torch

from dl_speech_enhancement_tpu_torch.dsp.stft import hann_window, stft_magnitude
from dl_speech_enhancement_tpu_torch.losses.mel_loss import _flat
from dl_speech_enhancement_tpu_torch.ops.mel_kernel import (
    make_fused_stft_magnitude,
    resolve_spectrum_backend,
)
from dl_speech_enhancement_tpu_torch.utils.collectives import psum
from dl_speech_enhancement_tpu_torch.utils.device import resolve_device


def spectral_convergence_loss(x_mag, y_mag, group=None):
    """||y - x||_F / ||y||_F. With ``group`` (utils/collectives.py) the batch
    is spread over its ranks, and both norms are taken over all of them."""
    if group is None:
        return torch.linalg.norm(y_mag - x_mag) / torch.linalg.norm(y_mag)
    diff = y_mag - x_mag
    return (torch.sqrt(psum(torch.sum(diff * diff), group))
            / torch.sqrt(psum(torch.sum(y_mag * y_mag), group)))


def log_stft_magnitude_loss(x_mag, y_mag):
    """L1 of the log magnitudes."""
    return torch.mean(torch.abs(torch.log(y_mag) - torch.log(x_mag)))


class STFTLoss:
    def __init__(self, fft_size=1024, hop_size=120, win_length=600, window="hann_window",
                 backend="auto", device="cuda", group=None):
        if window != "hann_window":
            raise NotImplementedError(f"window: {window}")
        device = resolve_device(device)
        self.fft_size = fft_size
        self.hop_size = hop_size
        self.win_length = win_length
        self.group = group
        self.window = hann_window(win_length, device=device)
        self.backend = resolve_spectrum_backend(backend, device)
        self._fused = None
        if self.backend in ("cuda", "plain"):
            self._fused = make_fused_stft_magnitude(fft_size, hop_size, win_length,
                                                    device=device,
                                                    plain=self.backend == "plain")

    def _mag(self, x):
        if self._fused is not None:
            return self._fused(x)
        return stft_magnitude(x, self.window, n_fft=self.fft_size, hop=self.hop_size,
                              win_length=self.win_length)

    def __call__(self, x, y):
        """x, y: (B, T). Returns (sc_loss, mag_loss)."""
        x_mag, y_mag = self._mag(x), self._mag(y)
        return (spectral_convergence_loss(x_mag, y_mag, self.group),
                log_stft_magnitude_loss(x_mag, y_mag))


class MultiResolutionSTFTLoss:
    def __init__(self, fft_sizes=(1024, 2048, 512), hop_sizes=(120, 240, 50),
                 win_lengths=(600, 1200, 240), window="hann_window", backend="auto",
                 device="cuda", group=None):
        if not len(fft_sizes) == len(hop_sizes) == len(win_lengths):
            raise ValueError("fft_sizes, hop_sizes and win_lengths differ in length")
        self.losses = [STFTLoss(f, h, w, window, backend=backend, device=device, group=group)
                       for f, h, w in zip(fft_sizes, hop_sizes, win_lengths)]

    def __call__(self, x, y):
        """x, y: (B, T) or (B, T, C) (channels fold into the batch).
        Returns (sc, mag)."""
        x, y = _flat(x), _flat(y)
        sc = mag = 0.0
        for f in self.losses:
            sc_l, mag_l = f(x, y)
            sc = sc + sc_l
            mag = mag + mag_l
        return sc / len(self.losses), mag / len(self.losses)
