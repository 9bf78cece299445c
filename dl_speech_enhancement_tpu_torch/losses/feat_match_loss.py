"""Feature-matching loss between discriminator feature maps.

Counterpart of dl_speech_enhancement_tpu/losses/feat_match_loss.py: L1
between per-layer features (the final logits left out by default), the
target features detached.
"""

from __future__ import annotations

import torch


class FeatureMatchLoss:
    def __init__(self, average_by_layers=True, average_by_discriminators=True,
                 include_final_outputs=False):
        self.average_by_layers = average_by_layers
        self.average_by_discriminators = average_by_discriminators
        self.include_final_outputs = include_final_outputs

    def __call__(self, feats_hat, feats):
        total = 0.0
        for feats_hat_, feats_ in zip(feats_hat, feats):
            if not self.include_final_outputs:
                feats_hat_ = feats_hat_[:-1]
                feats_ = feats_[:-1]
            layer_loss = 0.0
            for fh, f in zip(feats_hat_, feats_):
                layer_loss = layer_loss + torch.mean(torch.abs(fh - f.detach()))
            if self.average_by_layers:
                layer_loss = layer_loss / len(feats_)
            total = total + layer_loss
        if self.average_by_discriminators:
            total = total / len(feats)
        return total
