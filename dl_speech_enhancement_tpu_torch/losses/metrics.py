"""Audio quality metrics used as losses and measures by the course loop.

Counterpart of dl_speech_enhancement_tpu/losses/metrics.py (torchmetrics
semantics, SNR with ``zero_mean=False``), computed over the whole batch.
"""

from __future__ import annotations

import torch

from dl_speech_enhancement_tpu_torch.utils.collectives import group_size, psum

_EPS = torch.finfo(torch.float32).eps


def _mean(x, group):
    if group is None:
        return torch.mean(x)
    return psum(torch.sum(x), group) / (x.numel() * group_size(group))


def signal_noise_ratio(preds, target, zero_mean: bool = False, group=None):
    """SNR = 10 log10(||target||^2 / ||target - preds||^2), batch-global.
    With ``group`` (utils/collectives.py) the batch is spread over its ranks:
    the sums, and the means of ``zero_mean``, are taken over all of them."""
    if zero_mean:
        target = target - _mean(target, group)
        preds = preds - _mean(preds, group)
    noise = target - preds
    return 10.0 * (torch.log10(psum(torch.sum(target * target), group) + _EPS)
                   - torch.log10(psum(torch.sum(noise * noise), group) + _EPS))


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
