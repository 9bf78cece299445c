"""Model construction by config ``model_type`` (the reference's dispatch).

Counterpart of dl_speech_enhancement_tpu/utils/model_factory.py:
symAudioDec / symAudioDecUniv (codec), HiFiGAN / UnivNet (vocoder), and
their discriminators (HiFiGAN's MSD + MPD, UnivNet's MRSD + MPD).
"""

from __future__ import annotations

import numpy as np

from dl_speech_enhancement_tpu_torch.models import (
    AudioDecGenerator,
    HiFiGANDiscriminator,
    HiFiGANGenerator,
    UnivNetDiscriminator,
)


def _gen_stats(params: dict):
    """``params`` with a ``stats:`` .npy path replaced by the array it holds
    (a path relative to the working directory, as the reference reads it)."""
    p = dict(params)
    stats_path = p.pop("stats", None)
    if stats_path is not None:
        p["stats"] = np.load(stats_path)
    return p


def _hifigan_gen_params(params: dict) -> dict:
    p = _gen_stats(params)
    nl = p.pop("nonlinear_activation", "LeakyReLU")
    nlp = p.pop("nonlinear_activation_params", {"negative_slope": 0.1})
    if nl != "LeakyReLU":
        raise NotImplementedError(f"HiFiGAN activation {nl} is not supported")
    p["negative_slope"] = nlp.get("negative_slope", 0.1)
    p.pop("use_weight_norm", None)  # always on in the port's parametrization
    return p


def build_generator(model_type: str, params: dict, use_pqc: bool = True, device="cuda",
                    seed: int = 0):
    """The generator of a config's ``model_type`` with its
    ``generator_params``, seeded weights, on ``device``."""
    if model_type in ("symAudioDec", "symAudioDecUniv"):
        return AudioDecGenerator(**params, use_pqc=use_pqc, seed=seed, device=device)
    if model_type in ("HiFiGAN", "UnivNet"):
        return HiFiGANGenerator(**_hifigan_gen_params(params), seed=seed, device=device)
    raise NotImplementedError(f"Model type: {model_type} is not supported!")


def build_discriminator(model_type: str, params: dict, device="cuda", seed: int = 0):
    """The discriminator of a config's ``model_type`` with its
    ``discriminator_params``, seeded weights, on ``device``."""
    if model_type in ("symAudioDec", "HiFiGAN"):
        return HiFiGANDiscriminator(**params, seed=seed, device=device)
    if model_type in ("symAudioDecUniv", "UnivNet"):
        return UnivNetDiscriminator(**params, seed=seed, device=device)
    raise NotImplementedError(f"Model type: {model_type} is not supported!")
