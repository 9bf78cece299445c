"""Autoencoder (symAD codec) workload: the two-stage "efficient" paradigm.

Counterpart of dl_speech_enhancement_tpu/train/workloads/autoencoder.py
(reference trainer/autoencoder.py:19-167):

- stage 1 (``steps`` below ``start_steps.discriminator``): the generator's
  update on the VQ loss and the metric losses, the codebooks trained by EMA
  (the new ``VQState`` carried forward);
- stage 2: the encoder and the projector frozen (``FROZEN_STAGE2``,
  autoencoder.py:62-79) and the EMA off; the generator (its decoder) also
  takes the adversarial and feature-matching losses against the
  discriminator, whose weights take no gradient there and whose features
  of the natural audio are computed without one; then the discriminator's
  update on ``y`` recomputed from the updated generator without gradients
  (autoencoder.py:117-126).

The steps update the modules and optimizers in place and return their loss
fragments as tensors on the card. With a data-parallel ``group`` the
codebooks' EMA statistics and perplexity, and spectral convergence, reduce
over its ranks, and the gradients are averaged over them before each update.
"""

from __future__ import annotations

import itertools

import torch

from dl_speech_enhancement_tpu_torch.train.criterion import (
    adv_loss,
    build_criterion,
    dis_loss,
    metric_loss,
)
from dl_speech_enhancement_tpu_torch.train.gan_trainer import TrainerGAN
from dl_speech_enhancement_tpu_torch.train.optim import (
    build_optimizer_from_config,
    frozen,
    frozen_params,
)
from dl_speech_enhancement_tpu_torch.utils.collectives import average_gradients

FROZEN_STAGE2 = ("encoder", "projector")


def detached(frags: dict) -> dict:
    return {k: v.detach() for k, v in frags.items()}


def make_autoencoder_steps(gen, disc, config, opt_g, opt_d, group=None):
    """The steps of ``gen`` (an ``AudioDecGenerator(use_pqc=True)``) and
    ``disc`` with their optimizers: ``gen_stage1`` / ``gen_stage2`` take
    ``(vq_state, x)`` and return ``(vq_state, fragments, perplexities)``,
    ``dis`` takes ``(vq_state, x)`` and returns its fragments,
    ``eval_stage1`` / ``eval_stage2`` return ``(fragments, perplexities)``
    without gradients. ``x`` is (B, T, 1) on the generator's device (a
    rank's rows where ``group``, a process group, spreads the batch)."""
    crit = build_criterion(config, device=gen.device, group=group)
    lambda_vq = config.get("lambda_vq_loss", 1.0)
    use_feat_match = config.get("use_feat_match_loss", False)

    def gen_loss(vq_state, x, train_vq, use_adv):
        y, _, _, vqloss, ppl, new_vq = gen(x, vq_state, train=train_vq, axis_name=group)
        vq_l = torch.sum(vqloss) * lambda_vq
        metric_l, frags = metric_loss(crit, config, y, x)
        total = vq_l + metric_l
        frags = dict(frags, vqloss=vq_l)
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
        return total, frags, ppl, new_vq

    def make_gen_step(train_vq: bool, use_adv: bool, frozen_names):
        def step(vq_state, x):
            opt_g.zero_grad()
            held = itertools.chain(frozen_params(gen, frozen_names),
                                   disc.parameters() if use_adv else ())
            with frozen(held):
                total, frags, ppl, new_vq = gen_loss(vq_state, x, train_vq, use_adv)
                total.backward()
            average_gradients(opt_g.params, group)
            opt_g.step()
            return (new_vq if train_vq else vq_state), detached(frags), ppl.detach()
        return step

    def dis_step(vq_state, x):
        with torch.no_grad():
            y = gen(x, vq_state, train=False)[0]
        opt_d.zero_grad()
        d_l, frags = dis_loss(crit, config, disc(y), disc(x))
        d_l.backward()
        average_gradients(opt_d.params, group)
        opt_d.step()
        return detached(dict(frags, discriminator_loss=d_l))

    @torch.no_grad()
    def eval_step(vq_state, x, use_adv: bool):
        y, _, _, vqloss, ppl, _ = gen(x, vq_state, train=False, axis_name=group)
        vq_l = torch.sum(vqloss) * lambda_vq
        metric_l, frags = metric_loss(crit, config, y, x)
        total = vq_l + metric_l
        frags = dict(frags, vqloss=vq_l)
        if use_adv:
            p_, p = disc(y), disc(x)
            a_l, a_frags = adv_loss(crit, config, p_, p)
            total = total + a_l
            frags.update(a_frags)
            d_l, d_frags = dis_loss(crit, config, p_, p)
            frags.update(d_frags, discriminator_loss=d_l)
        frags["generator_loss"] = total
        return frags, ppl

    return {
        "gen_stage1": make_gen_step(train_vq=True, use_adv=False, frozen_names=()),
        "gen_stage2": make_gen_step(train_vq=False, use_adv=True, frozen_names=FROZEN_STAGE2),
        "dis": dis_step,
        "eval_stage1": lambda vq_state, x: eval_step(vq_state, x, use_adv=False),
        "eval_stage2": lambda vq_state, x: eval_step(vq_state, x, use_adv=True),
    }


class Trainer(TrainerGAN):
    """The symAD codec trainer (trainer/autoencoder.py) on ``gen`` and
    ``disc`` (both on one device) and ``vq_state`` (drawn from the config's
    seed if not given)."""

    def __init__(self, steps, epochs, data_loader, gen, disc, config, vq_state=None):
        super().__init__(steps, epochs, data_loader, config, device=gen.device)
        self.gen, self.disc = gen, disc
        self.opt_g = build_optimizer_from_config(config, "generator", gen.parameters())
        self.opt_d = build_optimizer_from_config(config, "discriminator", disc.parameters())
        self.modules = {"params_generator": gen, "params_discriminator": disc}
        self.optimizers = {"opt_generator": self.opt_g, "opt_discriminator": self.opt_d}
        self.vq_state = (vq_state if vq_state is not None
                         else gen.quantizer.init(seed=config.get("seed", 0), device=gen.device))
        self._steps_fns = make_autoencoder_steps(gen, disc, config, self.opt_g, self.opt_d,
                                                 self.group)
        start = config.get("start_steps", {})
        self.generator_start = start.get("generator", 0)
        self.discriminator_start = start.get("discriminator", 200000)
        self._shard_state()

    def _train_step(self, batch):
        x = self._device_batch(batch)
        if self.steps >= self.generator_start:
            fn = "gen_stage1" if self.steps < self.discriminator_start else "gen_stage2"
            self.vq_state, frags, ppl = self._steps_fns[fn](self.vq_state, x)
            self._record_losses(frags, "train")
            self._record_ppl(ppl, "train")
        if self.steps >= self.discriminator_start:
            self._record_losses(self._steps_fns["dis"](self.vq_state, x), "train")
        self.steps += 1
        self._check_train_finish()

    def _eval_step(self, batch):
        x = self._device_batch(batch)
        fn = "eval_stage2" if self.steps >= self.discriminator_start else "eval_stage1"
        frags, ppl = self._steps_fns[fn](self.vq_state, x)
        self._record_losses(frags, "eval")
        self._record_ppl(ppl, "eval")

    def _record_ppl(self, ppl, mode: str):
        self._record_losses({f"ppl_{i}": v for i, v in enumerate(ppl)}, mode)
