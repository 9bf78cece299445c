"""Multi-resolution mel-spectrogram L1 loss.

Counterpart of dl_speech_enhancement_tpu/losses/mel_loss.py. Each
resolution is a :class:`~dl_speech_enhancement_tpu_torch.dsp.mel.MelSpectrogram`
on ``device``; ``backend`` picks its route (``'auto'``: the K6 kernel on the
card, the FFT on the CPU).
"""

from __future__ import annotations

import torch

from dl_speech_enhancement_tpu_torch.dsp.mel import MelSpectrogram


class MultiMelSpectrogramLoss:
    def __init__(self, fs: int = 22050, fft_sizes=(1024, 2048, 512), hop_sizes=(120, 240, 50),
                 win_lengths=(600, 1200, 240), window: str = "hann_window", num_mels: int = 80,
                 fmin=80, fmax=7600, center: bool = True, normalized: bool = False,
                 onesided: bool = True, eps: float = 1e-10, log_base=10.0,
                 backend: str = "auto", device="cuda"):
        if not len(fft_sizes) == len(hop_sizes) == len(win_lengths):
            raise ValueError("fft_sizes, hop_sizes and win_lengths differ in length")
        if not center or normalized or not onesided:
            raise NotImplementedError("only center=True, normalized=False, onesided=True")
        self.mels = [
            MelSpectrogram(fs=fs, fft_size=f, hop_size=h, win_length=w, window=window,
                           num_mels=num_mels, fmin=fmin, fmax=fmax, eps=eps,
                           log_base=log_base, backend=backend, device=device)
            for f, h, w in zip(fft_sizes, hop_sizes, win_lengths)
        ]

    def __call__(self, y_hat, y):
        """y_hat, y: (B, T, C) or (B, T) waveforms -> scalar loss."""
        loss = 0.0
        for mel in self.mels:
            loss = loss + torch.mean(torch.abs(mel(_flat(y_hat)) - mel(_flat(y))))
        return loss / len(self.mels)


def _flat(x):
    """(B, T, C) -> (B*C, T); (B, T) unchanged."""
    if x.dim() == 3:
        return x.transpose(1, 2).reshape(-1, x.shape[1])
    return x
