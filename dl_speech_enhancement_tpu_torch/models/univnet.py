"""UnivNet combined discriminator (MRSD + MPD), as an ``nn.Module``.

Counterpart of dl_speech_enhancement_tpu/models/univnet.py (reference
models/vocoder/UnivNet.py:23-103): the multi-resolution spectral
discriminator's outputs, then the multi-period discriminator's; multi-channel
inputs are folded into the batch. The UnivNet generator is the HiFiGAN one
with other config values (models/hifigan.py).
"""

from __future__ import annotations

import torch
from torch import nn

from dl_speech_enhancement_tpu_torch.models.discriminator import (
    HiFiGANMultiPeriodDiscriminator,
    UnivNetMultiResolutionSpectralDiscriminator,
    fold_channels,
)
from dl_speech_enhancement_tpu_torch.utils.device import resolve_device


class UnivNetDiscriminator(nn.Module):
    """Weights are drawn from ``generator`` (a fresh one seeded with ``seed``
    if not given), MRSD then MPD, on the CPU and moved to ``device``."""

    def __init__(self, fft_sizes=(1024, 2048, 512), hop_sizes=(120, 240, 50),
                 win_lengths=(600, 1200, 240), window="hann_window",
                 spectral_discriminator_params=None, periods=(2, 3, 5, 7, 11),
                 period_discriminator_params=None, *, seed: int = 0,
                 generator: torch.Generator | None = None, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(seed)
        self.mrsd = UnivNetMultiResolutionSpectralDiscriminator(
            fft_sizes, hop_sizes, win_lengths, window, spectral_discriminator_params,
            generator=generator)
        self.mpd = HiFiGANMultiPeriodDiscriminator(periods, period_discriminator_params,
                                                   generator=generator)
        self.to(device)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def forward(self, x):
        """x: (B, T, C) waveform -> one output per sub-discriminator (the
        MRSD's a final map, the MPD's a feature list)."""
        x = fold_channels(x)
        return self.mrsd(x) + self.mpd(x)
