"""Audio quality metrics used as losses and measures by the course loop.

Counterpart of dl_speech_enhancement_tpu/losses/metrics.py (torchmetrics
semantics, SNR with ``zero_mean=False``), computed over the whole batch.
"""

from __future__ import annotations

import torch

_EPS = torch.finfo(torch.float32).eps


def signal_noise_ratio(preds, target, zero_mean: bool = False):
    """SNR = 10 log10(||target||^2 / ||target - preds||^2), batch-global."""
    if zero_mean:
        target = target - torch.mean(target)
        preds = preds - torch.mean(preds)
    noise = target - preds
    return 10.0 * (torch.log10(torch.sum(target * target) + _EPS)
                   - torch.log10(torch.sum(noise * noise) + _EPS))


def scale_invariant_sdr(preds, target):
    """SI-SDR with zero-mean normalisation, averaged over the batch.
    preds/target: (B, T) or (B, T, C)."""
    p = preds.reshape(preds.shape[0], -1)
    t = target.reshape(target.shape[0], -1)
    p = p - torch.mean(p, dim=1, keepdim=True)
    t = t - torch.mean(t, dim=1, keepdim=True)
    alpha = ((torch.sum(p * t, dim=1, keepdim=True) + _EPS)
             / (torch.sum(t * t, dim=1, keepdim=True) + _EPS))
    t_scaled = alpha * t
    e = p - t_scaled
    ratio = (torch.sum(t_scaled * t_scaled, dim=1) + _EPS) / (torch.sum(e * e, dim=1) + _EPS)
    return torch.mean(10.0 * torch.log10(ratio))


def mean_absolute_error(preds, target):
    return torch.mean(torch.abs(preds - target))
