"""Denoise fine-tune workload: the encoder trained on (noisy, clean) pairs.

Counterpart of dl_speech_enhancement_tpu/train/workloads/denoise.py
(reference trainer/denoise.py:19-111): the decoder is frozen, the codebook
EMA off at every step (denoise.py:60), so the codebooks do not move either;
the loss is the VQ loss (its commitment term reaches the encoder and the
projector) plus the metric losses between the output for the noisy input
and the clean target. With a data-parallel ``group`` perplexity and
spectral convergence reduce over its ranks and the gradients are averaged
over them before each update.
"""

from __future__ import annotations

import torch

from dl_speech_enhancement_tpu_torch.train.criterion import build_criterion, metric_loss
from dl_speech_enhancement_tpu_torch.train.gan_trainer import TrainerGAN
from dl_speech_enhancement_tpu_torch.train.optim import (
    build_optimizer_from_config,
    frozen,
    frozen_params,
)
from dl_speech_enhancement_tpu_torch.train.workloads.autoencoder import detached
from dl_speech_enhancement_tpu_torch.utils.collectives import average_gradients

FROZEN = ("decoder",)  # the codebooks are the VQState, which the EMA-off steps keep


def make_denoise_steps(gen, config, opt_g, group=None):
    """``train(vq_state, x_n, x_c)`` updates ``gen`` and returns
    ``(fragments, perplexities)``; ``eval`` the same without gradients.
    ``group``: the process group whose ranks share the batch."""
    crit = build_criterion(config, device=gen.device, group=group)
    lambda_vq = config.get("lambda_vq_loss", 1.0)

    def loss(vq_state, x_n, x_c):
        y, _, _, vqloss, ppl, _ = gen(x_n, vq_state, train=False, axis_name=group)
        vq_l = torch.sum(vqloss) * lambda_vq
        metric_l, frags = metric_loss(crit, config, y, x_c)
        total = vq_l + metric_l
        return total, dict(frags, vqloss=vq_l, generator_loss=total), ppl

    def train_step(vq_state, x_n, x_c):
        opt_g.zero_grad()
        with frozen(frozen_params(gen, FROZEN)):
            total, frags, ppl = loss(vq_state, x_n, x_c)
            total.backward()
        average_gradients(opt_g.params, group)
        opt_g.step()
        return detached(frags), ppl.detach()

    @torch.no_grad()
    def eval_step(vq_state, x_n, x_c):
        _, frags, ppl = loss(vq_state, x_n, x_c)
        return frags, ppl

    return {"train": train_step, "eval": eval_step}


class Trainer(TrainerGAN):
    """The denoise fine-tuner (trainer/denoise.py) on ``gen`` with
    ``vq_state`` (the codec's, e.g. from the checkpoint the config's
    ``initial`` names; drawn from the config's seed if not given). A batch
    is ``(noisy, clean)``."""

    def __init__(self, steps, epochs, data_loader, gen, config, vq_state=None):
        super().__init__(steps, epochs, data_loader, config, device=gen.device)
        self.gen = gen
        self.opt_g = build_optimizer_from_config(config, "generator", gen.parameters())
        self.modules = {"params_generator": gen}
        self.optimizers = {"opt_generator": self.opt_g}
        self.vq_state = (vq_state if vq_state is not None
                         else gen.quantizer.init(seed=config.get("seed", 0), device=gen.device))
        self._steps_fns = make_denoise_steps(gen, config, self.opt_g, self.group)
        self._shard_state()

    def _train_step(self, batch):
        x_n, x_c = self._device_batch(batch)
        frags, _ = self._steps_fns["train"](self.vq_state, x_n, x_c)
        self._record_losses(frags, "train")
        self.steps += 1
        self._check_train_finish()

    def _eval_step(self, batch):
        x_n, x_c = self._device_batch(batch)
        frags, _ = self._steps_fns["eval"](self.vq_state, x_n, x_c)
        self._record_losses(frags, "eval")
