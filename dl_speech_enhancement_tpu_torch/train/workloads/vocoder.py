"""Vocoder workload: a HiFiGAN / UnivNet generator on a frozen analyzer.

Counterpart of dl_speech_enhancement_tpu/train/workloads/vocoder.py
(reference trainer/vocoder.py:19-147): the analyzer (a PQC
``AudioDecGenerator``: encoder, projector, ``quantizer.inference``) is frozen
and runs without gradients; each step encodes the waveform to ``zq``, the
vocoder reconstructs the waveform from it, and the metric (and adversarial)
losses drive the generator's update, then the discriminator's on ``y``
recomputed from the updated generator.

The gates are strict (trainer/vocoder.py): the generator updates once
``steps > generator_train_start_steps``, the discriminator once ``steps >
discriminator_train_start_steps``. With a data-parallel ``group`` spectral
convergence reduces over its ranks and the gradients are averaged over them
before each update.
"""

from __future__ import annotations

import torch

from dl_speech_enhancement_tpu_torch.train.criterion import (
    adv_loss,
    build_criterion,
    dis_loss,
    metric_loss,
)
from dl_speech_enhancement_tpu_torch.train.gan_trainer import TrainerGAN
from dl_speech_enhancement_tpu_torch.train.optim import build_optimizer_from_config, frozen
from dl_speech_enhancement_tpu_torch.train.workloads.autoencoder import detached
from dl_speech_enhancement_tpu_torch.utils.collectives import average_gradients


@torch.no_grad()
def encode(analyzer, vq_state, x):
    """The analyzer's quantized codes ``zq`` (B, T / hop, code_dim) of ``x``."""
    zq, _ = analyzer.quantizer.inference(vq_state, analyzer.projector(analyzer.encoder(x)))
    return zq


def make_vocoder_steps(analyzer, vq_state, gen, disc, config, opt_g, opt_d, group=None):
    """The steps of the vocoder ``gen`` and ``disc`` on ``analyzer``'s codes:
    ``gen`` / ``gen_adv`` and ``dis`` take ``x`` (B, T, 1) and return their
    fragments; ``eval`` / ``eval_adv`` the same without gradients.
    ``group``: the process group whose ranks share the batch."""
    crit = build_criterion(config, device=gen.device, group=group)
    use_feat_match = config.get("use_feat_match_loss", False)

    def gen_loss(zq, x, use_adv):
        y = gen(zq)
        total, frags = metric_loss(crit, config, y, x)
        if use_adv:
            p_ = disc(y)
            p = None
            if use_feat_match:
                with torch.no_grad():
                    p = disc(x)
            a_l, a_frags = adv_loss(crit, config, p_, p)
            total = total + a_l
            frags.update(a_frags)
        frags["generator_loss"] = total
        return total, frags

    def make_gen_step(use_adv: bool):
        def step(x):
            zq = encode(analyzer, vq_state, x)
            opt_g.zero_grad()
            with frozen(disc.parameters() if use_adv else ()):
                total, frags = gen_loss(zq, x, use_adv)
                total.backward()
            average_gradients(opt_g.params, group)
            opt_g.step()
            return detached(frags)
        return step

    def dis_step(x):
        with torch.no_grad():
            y = gen(encode(analyzer, vq_state, x))
        opt_d.zero_grad()
        d_l, frags = dis_loss(crit, config, disc(y), disc(x))
        d_l.backward()
        average_gradients(opt_d.params, group)
        opt_d.step()
        return detached(dict(frags, discriminator_loss=d_l))

    @torch.no_grad()
    def eval_step(x, use_adv: bool):
        y = gen(encode(analyzer, vq_state, x))
        total, frags = metric_loss(crit, config, y, x)
        if use_adv:
            p_, p = disc(y), disc(x)
            a_l, a_frags = adv_loss(crit, config, p_, p)
            total = total + a_l
            frags.update(a_frags)
            d_l, d_frags = dis_loss(crit, config, p_, p)
            frags.update(d_frags, discriminator_loss=d_l)
        frags["generator_loss"] = total
        return frags

    return {
        "gen": make_gen_step(use_adv=False),
        "gen_adv": make_gen_step(use_adv=True),
        "dis": dis_step,
        "eval": lambda x: eval_step(x, use_adv=False),
        "eval_adv": lambda x: eval_step(x, use_adv=True),
    }


class Trainer(TrainerGAN):
    """The vocoder trainer (trainer/vocoder.py): ``analyzer`` (its weights
    loaded) with ``vq_state``, the vocoder ``gen`` and ``disc``, all on one
    device. The analyzer's weights take no gradient."""

    def __init__(self, steps, epochs, data_loader, analyzer, vq_state, gen, disc, config):
        super().__init__(steps, epochs, data_loader, config, device=gen.device)
        analyzer.requires_grad_(False)
        self.analyzer, self.gen, self.disc = analyzer, gen, disc
        self.opt_g = build_optimizer_from_config(config, "generator", gen.parameters())
        self.opt_d = build_optimizer_from_config(config, "discriminator", disc.parameters())
        self.modules = {"params_analyzer": analyzer, "params_generator": gen,
                        "params_discriminator": disc}
        self.optimizers = {"opt_generator": self.opt_g, "opt_discriminator": self.opt_d}
        self.vq_state = vq_state
        self._steps_fns = make_vocoder_steps(analyzer, vq_state, gen, disc, config,
                                             self.opt_g, self.opt_d, self.group)
        self.generator_start = config.get("generator_train_start_steps", 0)
        self.discriminator_start = config.get("discriminator_train_start_steps", 0)
        self._shard_state()

    def _train_step(self, batch):
        x = self._device_batch(batch)
        if self.steps > self.generator_start:
            fn = "gen_adv" if self.steps > self.discriminator_start else "gen"
            self._record_losses(self._steps_fns[fn](x), "train")
        if self.steps > self.discriminator_start:
            self._record_losses(self._steps_fns["dis"](x), "train")
        self.steps += 1
        self._check_train_finish()

    def _eval_step(self, batch):
        x = self._device_batch(batch)
        fn = "eval_adv" if self.steps > self.discriminator_start else "eval"
        self._record_losses(self._steps_fns[fn](x), "eval")
