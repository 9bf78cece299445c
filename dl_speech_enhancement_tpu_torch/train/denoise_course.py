"""The course training loop: speech-enhancement fine-tuning of the
without-PQC AudioDec generator, its generator phase.

Counterpart of dl_speech_enhancement_tpu/train/denoise_course.py, in
PyTorch idiom: the generator and its optimizer are stateful objects, so a
step updates them in place and returns the losses. Until
``epoch_to_enable_discriminator`` the loss is

    lambda_mel * MultiMel + lambda_snr * (1 - sigmoid(SNR)) [+ lambda_wave_l1 * L1]

(MultiMel through the K6 kernel on the card, ``backend='auto'`` of
``mel_loss_params``), backpropagated and applied by Adam. Batches are mixed
on the host in numpy at a random SNR in [10, 20) with noise dropout (and its
decay) before the mix, as the JAX loop does.

Waiting for their ROADMAP items, each raising NotImplementedError: the
discriminator arms (``train_disc``/``eval_disc``, and reaching
``epoch_to_enable_discriminator``) wait for "Discriminators" (ROADMAP §1);
checkpoints, which the JAX loop writes outside LAPTOP mode, for "The rest of
training"; data parallelism (``parallel.data_devices`` > 1) for "Parallel".
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from dl_speech_enhancement_tpu_torch.data.mixing import add_noise, noise_dropout
from dl_speech_enhancement_tpu_torch.losses import MultiMelSpectrogramLoss, signal_noise_ratio
from dl_speech_enhancement_tpu_torch.train.optim import build_optimizer

logger = logging.getLogger(__name__)

DISC_NOT_PORTED = ("the course's adversarial phase needs the discriminators, which are not "
                   "ported yet (ROADMAP §1, 'Discriminators')")


def _wait_for_discriminators(*_):
    raise NotImplementedError(DISC_NOT_PORTED)


def make_course_steps(gen, disc, config, opt_g, opt_d):
    """``{"train", "eval", "train_disc", "eval_disc"}`` steps of ``gen`` (an
    ``AudioDecGenerator(use_pqc=False)``) with ``opt_g`` (a
    ``train.optim.Optimizer`` over its parameters).

    ``train(x, target)`` (both (B, T, 1) on the generator's device) runs
    forward and backward (``grad_accum`` microbatches, the SNR gate per
    microbatch), records the gradient statistics (after the clip, with
    torch's clip factor ``min(1, clip / (norm + 1e-6))``, as the reference
    reads ``.grad``), steps the optimizer and returns ``(g_loss, d_loss,
    frags, stats)`` as tensors. ``eval(x, target)`` returns ``(g_loss,
    d_loss, frags)`` without gradients. The discriminator arms raise."""
    del disc, opt_d  # the adversarial arms wait for the discriminators
    mel_loss = MultiMelSpectrogramLoss(**config["mel_loss_params"], device=gen.device)
    l_mel = config["lambda_mel_loss"]
    l_snr = config.get("lambda_snr_loss", 0.0)
    l_wl1 = float(config.get("lambda_wave_l1", 0.0))
    grad_accum = int(config.get("grad_accum", 1))
    clip = float(config.get("generator_grad_norm", -1))

    def gen_loss(x, target):
        y = gen(x, None, train=True)[0]
        mel = l_mel * mel_loss(y, target)
        snr = l_snr * (1.0 - torch.sigmoid(signal_noise_ratio(y, target)))
        total = mel + snr
        frags = {"mel_loss": mel, "snr_loss": snr}
        if l_wl1 > 0.0:
            wl1 = l_wl1 * torch.mean(torch.abs(y - target))
            total = total + wl1
            frags["wave_l1_loss"] = wl1
        return total, frags

    def microbatches(x, target):
        if x.shape[0] % grad_accum:
            raise ValueError(f"batch size {x.shape[0]} is not divisible by "
                             f"grad_accum={grad_accum}")
        return zip(x.chunk(grad_accum), target.chunk(grad_accum))

    def grad_stats():
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in opt_g.params]
        if clip > 0:
            gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            factor = torch.clamp(clip / (gnorm + 1e-6), max=1.0)
            grads = [g * factor for g in grads]
        return {"grad_max": torch.max(torch.stack([g.max() for g in grads])),
                "grad_min": torch.min(torch.stack([g.min() for g in grads])),
                "grad_avg": sum(g.abs().sum() for g in grads) / sum(g.numel() for g in grads)}

    def train(x, target):
        gen.train()
        opt_g.zero_grad()
        g_loss, frags = 0.0, {}
        for xm, tm in microbatches(x, target):
            loss, fr = gen_loss(xm, tm)
            (loss / grad_accum).backward()
            g_loss = g_loss + loss.detach() / grad_accum
            for k, v in fr.items():
                frags[k] = frags.get(k, 0.0) + v.detach() / grad_accum
        stats = grad_stats()
        opt_g.step()
        return g_loss, torch.zeros((), device=x.device), frags, stats

    def evaluate(x, target):
        with torch.no_grad():
            g_loss, frags = gen_loss(x, target)
        return g_loss, torch.zeros((), device=x.device), frags

    return {"train": train, "eval": evaluate,
            "train_disc": _wait_for_discriminators, "eval_disc": _wait_for_discriminators}


def _data_devices(config: dict, device: torch.device) -> int:
    n = int((config.get("parallel") or {}).get("data_devices", 1) or 1)
    if n < 0:
        n = torch.cuda.device_count() if device.type == "cuda" else 1
    return n


def train_denoise_course(config: dict, gen, disc, train_loaders, val_loaders, *,
                         environment: str = "HPC", report=None):
    """Run the course loop on ``gen`` in place. ``train_loaders`` /
    ``val_loaders`` are (clean, noise) pairs of iterables of numpy (B, T, 1)
    batches; ``report(category, series, value, iteration)`` is the scalar
    sink. ``disc`` must be None until the discriminators are ported.
    Returns ``({"generator", "opt_generator", "steps"}, history)``, one
    history entry per epoch as the JAX loop keeps it."""
    if disc is not None:
        raise NotImplementedError(DISC_NOT_PORTED)
    if environment != "LAPTOP":
        raise NotImplementedError(
            f"environment {environment!r} writes a checkpoint every epoch; the port's "
            "checkpoints are not ported yet (ROADMAP §1, 'The rest of training'): run with "
            "'LAPTOP'")
    if _data_devices(config, gen.device) > 1:
        raise NotImplementedError("parallel.data_devices > 1: data parallelism is not ported "
                                  "yet (ROADMAP §1, 'Parallel')")
    device = gen.device
    opt_g = build_optimizer(gen.parameters(), "Adam", config["generator_optimizer_params"],
                            grad_norm=config.get("generator_grad_norm", -1))
    steps_fns = make_course_steps(gen, None, config, opt_g, None)

    def put(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    mix_rng = np.random.default_rng(config.get("seed", 82))
    noise_dropout_rate = config["noise_dropout_rate"]
    epoch_disc = config["epoch_to_enable_discriminator"]
    epoch_ndo_decay = config["epoch_to_enable_noise_dropout_decay"]
    steps = config.get("step", 0)
    start_time = time.perf_counter()

    def _report(category, series, value, iteration):
        if report is not None:
            report(category, series, float(value), iteration)

    history = []
    for epoch in range(config["epochs"]):
        if epoch == epoch_disc:
            raise NotImplementedError(f"epoch {epoch} enables the discriminator: "
                                      + DISC_NOT_PORTED)
        if epoch > epoch_ndo_decay:
            noise_dropout_rate -= config["noise_dropout_rate_decay"]

        logger.info("Epoch %d", epoch)
        train_gen, last_frags = [], {}
        for i_batch, (clean_batch, noise_batch) in enumerate(zip(*train_loaders)):
            if i_batch == 3:  # LAPTOP mode: three batches an epoch
                break
            if noise_dropout_rate > 0.0:
                noise_batch = noise_dropout(clean_batch, noise_batch, noise_dropout_rate,
                                            mix_rng)
            mixed = add_noise(clean_batch, noise_batch, mix_rng.integers(10, 20))
            g_loss, d_loss, frags, gstats = steps_fns["train"](put(mixed), put(clean_batch))
            steps += 1
            last_frags = frags
            train_gen.append(float(g_loss))
            dt = time.perf_counter() - start_time
            logger.info("Training: Step %d \t Time: %d:%02d:%02d", steps, int(dt // 3600),
                        int(dt // 60) % 60, int(dt) % 60)
            _report("Gradients", "Maximum", gstats["grad_max"], steps)
            _report("Gradients", "Minimum", gstats["grad_min"], steps)
            _report("Gradients", "Average (Abs)", gstats["grad_avg"], steps)
            _report("Generator Batch Loss", "Train", g_loss, steps)
            _report("Discriminator Batch Loss", "Train", d_loss, steps)
            for name, value in frags.items():
                _report("Generator Batch Loss", name, value, steps)
        avg_gen = float(np.mean(train_gen)) if train_gen else 0.0

        gen_val, n_val = 0.0, 0
        for i_batch, (clean_batch, noise_batch) in enumerate(zip(*val_loaders)):
            if i_batch == 3:
                break
            mixed = add_noise(clean_batch, noise_batch, mix_rng.integers(10, 20))
            g_loss, _, _ = steps_fns["eval"](put(mixed), put(clean_batch))
            gen_val += float(g_loss)
            n_val += 1
        if n_val == 0:
            logger.warning("validation yielded no batches; val losses report 0")
        n_val = max(n_val, 1)
        _report("Generator Loss", "Train", avg_gen, epoch)
        _report("Generator Loss", "Validation", gen_val / n_val, epoch)
        _report("Discriminator Loss", "Train", 0.0, epoch)
        _report("Discriminator Loss", "Validation", 0.0, epoch)
        history.append({
            "epoch": epoch, "train_gen": avg_gen, "train_dis": 0.0,
            "val_gen": gen_val / n_val, "val_dis": 0.0,
            "frags": {k: float(v) for k, v in last_frags.items()},
        })
    return {"generator": gen, "opt_generator": opt_g, "steps": steps}, history
