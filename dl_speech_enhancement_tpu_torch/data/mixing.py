"""On-the-fly noise mixing and noise dropout (the course augmentations).

The port's own numpy copy of dl_speech_enhancement_tpu/data/mixing.py:

- :func:`add_noise` keeps the reference's formula: ``scale = exp(snr/10) *
  ||noise|| / ||speech||; mix = (scale*speech + noise) / 2`` (it scales the
  speech, uses a natural exponential and halves the mix); ``mode="db"`` is
  the standard variant (10^(snr/20), scaling the noise).
- :func:`noise_dropout`: per sample, the noise clip is replaced by the clean
  clip before mixing with probability ``rate``.
"""

from __future__ import annotations

import numpy as np


def add_noise(speech: np.ndarray, noise: np.ndarray, snr, mode: str = "reference"):
    if speech.shape != noise.shape:
        raise ValueError(f"speech {speech.shape} and noise {noise.shape} differ in shape")
    speech_power = np.linalg.norm(speech.reshape(-1))
    noise_power = np.linalg.norm(noise.reshape(-1))
    if mode == "reference":
        scale = np.exp(float(snr) / 10.0) * noise_power / max(speech_power, 1e-12)
        return (scale * speech + noise) / 2.0
    if mode == "db":
        target = speech_power / (10.0 ** (float(snr) / 20.0))
        return speech + noise * (target / max(noise_power, 1e-12))
    raise ValueError(mode)


def noise_dropout(clean_batch: np.ndarray, noise_batch: np.ndarray, rate: float,
                  rng: np.random.Generator) -> np.ndarray:
    """Replace noise[i] with clean[i] with probability ``rate`` (pre-mix)."""
    if rate <= 0.0:
        return noise_batch
    out = noise_batch.copy()
    for i in range(len(out)):
        if rng.random() <= rate:
            out[i] = clean_batch[i]
    return out
