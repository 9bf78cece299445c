"""Waveform shape (max-pooled envelope) loss.

Counterpart of dl_speech_enhancement_tpu/losses/waveform_loss.py: L1
between non-overlapping max-pool envelopes of |y| at several window lengths.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _maxpool_envelope(y, winlen):
    """y: (B, T, C) -> (B, T // winlen, C) non-overlapping max of |y|."""
    return F.max_pool1d(torch.abs(y).transpose(1, 2), winlen).transpose(1, 2)


class WaveformShapeLoss:
    def __init__(self, winlen: int):
        self.winlen = winlen

    def __call__(self, y_hat, y):
        return torch.mean(torch.abs(_maxpool_envelope(y_hat, self.winlen)
                                    - _maxpool_envelope(y, self.winlen)))


class MultiWindowShapeLoss:
    def __init__(self, winlen=(300, 200, 100)):
        self.losses = [WaveformShapeLoss(w) for w in winlen]

    def __call__(self, y_hat, y):
        loss = 0.0
        for f in self.losses:
            loss = loss + f(y_hat, y)
        return loss / len(self.losses)
