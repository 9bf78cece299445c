"""GAN adversarial losses over (possibly nested) discriminator output lists.

Counterpart of dl_speech_enhancement_tpu/losses/adversarial_loss.py: a
discriminator's outputs arrive as a list per discriminator; when an entry
is itself a list of per-layer features, its last element is the logits.
"""

from __future__ import annotations

import torch


def _logits(entry):
    return entry[-1] if isinstance(entry, (tuple, list)) else entry


def _check_type(loss_type):
    if loss_type not in ("mse", "hinge"):
        raise ValueError(f"loss_type {loss_type!r}; expected 'mse' or 'hinge'")


class GeneratorAdversarialLoss:
    def __init__(self, average_by_discriminators=True, loss_type="mse"):
        _check_type(loss_type)
        self.average = average_by_discriminators
        self.loss_type = loss_type

    def _criterion(self, x):
        if self.loss_type == "mse":
            return torch.mean((x - 1.0) ** 2)
        return -torch.mean(x)

    def __call__(self, outputs):
        if isinstance(outputs, (tuple, list)):
            loss = 0.0
            for o in outputs:
                loss = loss + self._criterion(_logits(o))
            if self.average:
                loss = loss / len(outputs)
            return loss
        return self._criterion(outputs)


class DiscriminatorAdversarialLoss:
    def __init__(self, average_by_discriminators=True, loss_type="mse"):
        _check_type(loss_type)
        self.average = average_by_discriminators
        self.loss_type = loss_type

    def _real(self, x):
        if self.loss_type == "mse":
            return torch.mean((x - 1.0) ** 2)
        return -torch.mean(torch.clamp(x - 1.0, max=0.0))

    def _fake(self, x):
        if self.loss_type == "mse":
            return torch.mean(x * x)
        return -torch.mean(torch.clamp(-x - 1.0, max=0.0))

    def __call__(self, outputs_hat, outputs):
        """Returns (real_loss, fake_loss)."""
        if isinstance(outputs, (tuple, list)):
            real = fake = 0.0
            for o_hat, o in zip(outputs_hat, outputs):
                real = real + self._real(_logits(o))
                fake = fake + self._fake(_logits(o_hat))
            if self.average:
                real = real / len(outputs)
                fake = fake / len(outputs)
            return real, fake
        return self._real(outputs), self._fake(outputs_hat)
