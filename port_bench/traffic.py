"""The benchmark's one traffic generator: seeded noisy speech.

A frozen copy of ``dl_speech_enhancement_tpu_torch/tools/dp_timing.py::
batch`` (and the reference formula of ``data/mixing.py::add_noise`` it
mixes with), drawn on the device from a ``torch.Generator`` instead of
numpy: four harmonics of a gliding pitch over a -60 dB noise floor, mixed
with white noise at ``snr`` by ``scale = exp(snr / 10) * ||noise|| /
||speech||; mix = (scale * speech + noise) / 2``. Every seed gives signals of
the same sizes; only their content moves with the seed.
"""

from __future__ import annotations

import math

import torch


def noisy_speech(rows: int, samples: int, seed: int, snr: float, sample_rate: int, device):
    """``(mixed, clean)``, each ``(rows, samples)`` f32 on ``device``; the
    norms of the mix are over all rows together, as ``add_noise`` takes
    them over a batch."""
    rng = torch.Generator(device=device).manual_seed(seed)
    t = torch.arange(samples, device=device, dtype=torch.float64) / sample_rate
    f0 = (100.0 + 150.0 * torch.rand(rows, 1, generator=rng, device=device,
                                      dtype=torch.float64)) * (1.0 + 0.1 * torch.sin(math.pi * t))
    phase = 2.0 * math.pi * torch.cumsum(f0, dim=1) / sample_rate
    clean = sum(0.3 / h * torch.sin(h * phase) for h in (1, 2, 3, 4))
    clean = (clean + 3e-4 * torch.randn(clean.shape, generator=rng, device=device,
                                        dtype=torch.float64)).float()
    noise = 0.3 * torch.randn(clean.shape, generator=rng, device=device)
    scale = math.exp(snr / 10.0) * torch.linalg.vector_norm(noise) / torch.clamp(
        torch.linalg.vector_norm(clean), min=1e-12)
    return (scale * clean + noise) / 2.0, clean
