"""Criterion container built from the reference's config keys.

Counterpart of dl_speech_enhancement_tpu/train/criterion.py: the losses
that ``use_*_loss`` flags enable, and the weighted sums the GAN trainers take
(``metric_loss``, ``adv_loss``, ``dis_loss``). The mel and STFT losses run
on ``device`` (their ``backend`` comes from their params, ``'auto'`` by
default: the K6/K7 kernels on the card).
"""

from __future__ import annotations

from dl_speech_enhancement_tpu_torch.losses import (
    DiscriminatorAdversarialLoss,
    FeatureMatchLoss,
    GeneratorAdversarialLoss,
    MultiMelSpectrogramLoss,
    MultiResolutionSTFTLoss,
    MultiWindowShapeLoss,
)


def build_criterion(config: dict, device="cuda", group=None) -> dict:
    """The losses the config enables; ``group`` spreads the batch over the
    ranks of a process group (spectral convergence reduces over it)."""
    crit = {}
    if config.get("use_mel_loss", False):
        crit["mel"] = MultiMelSpectrogramLoss(**config.get("mel_loss_params", {}), device=device)
    if config.get("use_stft_loss", False):
        crit["stft"] = MultiResolutionSTFTLoss(**config.get("stft_loss_params", {}),
                                               device=device, group=group)
    if config.get("use_shape_loss", False):
        crit["shape"] = MultiWindowShapeLoss(**config.get("shape_loss_params", {}))
    crit["gen_adv"] = GeneratorAdversarialLoss(**config.get("generator_adv_loss_params", {}))
    crit["dis_adv"] = DiscriminatorAdversarialLoss(
        **config.get("discriminator_adv_loss_params", {}))
    crit["feat_match"] = FeatureMatchLoss(**config.get("feat_match_loss_params", {}))
    return crit


def metric_loss(crit: dict, config: dict, predict_y, natural_y):
    """Weighted mel / STFT / shape losses. Returns (total, fragments)."""
    total = 0.0
    frags = {}
    if "mel" in crit:
        mel = crit["mel"](predict_y, natural_y) * config["lambda_mel_loss"]
        frags["mel_loss"] = mel
        total = total + mel
    if "stft" in crit:
        sc, mag = crit["stft"](predict_y, natural_y)
        sc = sc * config["lambda_stft_loss"]
        mag = mag * config["lambda_stft_loss"]
        frags["spectral_convergence_loss"] = sc
        frags["log_stft_magnitude_loss"] = mag
        total = total + sc + mag
    if "shape" in crit:
        shape = crit["shape"](predict_y, natural_y) * config["lambda_shape_loss"]
        frags["shape_loss"] = shape
        total = total + shape
    return total, frags


def adv_loss(crit: dict, config: dict, predict_p, natural_p=None):
    """Generator adversarial (+ feature matching) loss."""
    loss = crit["gen_adv"](predict_p)
    frags = {}
    if natural_p is not None:
        fm = crit["feat_match"](predict_p, natural_p)
        frags["feature_matching_loss"] = fm
        loss = loss + config["lambda_feat_match"] * fm
    loss = loss * config["lambda_adv"]
    frags["adversarial_loss"] = loss
    return loss, frags


def dis_loss(crit: dict, config: dict, predict_p, natural_p):
    """Discriminator loss."""
    real, fake = crit["dis_adv"](predict_p, natural_p)
    return real + fake, {"real_loss": real, "fake_loss": fake}
