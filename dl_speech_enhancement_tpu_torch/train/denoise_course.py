"""The course training loop: GAN speech-enhancement fine-tuning of the
without-PQC AudioDec generator with a HiFiGAN discriminator.

Counterpart of dl_speech_enhancement_tpu/train/denoise_course.py, in
PyTorch idiom: the networks and their optimizers are stateful objects, so a
step updates them in place and returns the losses. The generator loss is

    lambda_mel * MultiMel + lambda_snr * (1 - sigmoid(SNR)) [+ lambda_wave_l1 * L1]
        [+ lambda_adv * gen_adv(D(y)) + lambda_feat_match * feat_match(D(y), D(target))]

(MultiMel through the K6 kernel on the card, ``backend='auto'`` of
``mel_loss_params``), the adversarial terms from ``epoch_to_enable_discriminator``
on. An adversarial step updates in the JAX package's order: the generator
against the old discriminator, then the discriminator, ``lambda_adv *
(real + fake)``, on the updated generator's re-forwarded output. Batches are
mixed on the host in numpy at a random SNR in [10, 20) with noise dropout
(and its decay) before the mix, as the JAX loop does. Outside LAPTOP mode
every epoch writes ``{job_dir}/{task_name}checkpoint-{steps}`` through
train/checkpoint.py (the port's torch format, not the JAX package's orbax).

``parallel.data_devices`` above 1 runs the loop data-parallel over the ranks
parallel/mesh.py::launch started (the CLI's ``--dp N``), as the JAX loop
shards its batches over its mesh: every rank mixes the whole batch from the
same ``mix_rng`` and keeps its rows, the SNR gate reduces its energy sums over
the ranks, one gradient reduction a step averages the gradients, and rank 0
alone reports and writes checkpoints. The losses, the gradient statistics and
the history are the one-process values on every rank.

The loop sums the seconds it waits for the next batch from ``train_loaders``
(the span ``dse.course.loader_wait`` in a profiler trace) and logs their
share of the run time with each step's log line.
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np
import torch
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from dl_speech_enhancement_tpu_torch.data.mixing import add_noise, noise_dropout
from dl_speech_enhancement_tpu_torch.losses import (
    DiscriminatorAdversarialLoss,
    FeatureMatchLoss,
    GeneratorAdversarialLoss,
    MultiMelSpectrogramLoss,
    signal_noise_ratio,
)
from dl_speech_enhancement_tpu_torch.parallel.mesh import (
    mesh_from_config,
    shard_batch,
    shard_train_state,
)
from dl_speech_enhancement_tpu_torch.train.checkpoint import is_rank0, save_checkpoint
from dl_speech_enhancement_tpu_torch.train.optim import build_optimizer, frozen
from dl_speech_enhancement_tpu_torch.utils.collectives import average_gradients, pmean_values
from dl_speech_enhancement_tpu_torch.utils.trace import span, spanned

logger = logging.getLogger(__name__)

DISC_DTYPES = {"float32": None, "bf16": torch.bfloat16, "bfloat16": torch.bfloat16}


def _to_f32(outs):
    if isinstance(outs, (list, tuple)):
        return [_to_f32(o) for o in outs]
    return outs.float()


class _DiscCall(nn.Module):
    """``disc(x)``, or ``disc.apply_sub(sub, x)``, as one module's forward,
    so ``functional_call`` can run either on cast parameters."""

    def __init__(self, disc):
        super().__init__()
        self.disc = disc

    def forward(self, x, sub=None):
        return self.disc(x) if sub is None else self.disc.apply_sub(sub, x)


def make_course_steps(gen, disc, config, opt_g, opt_d, group=None):
    """``{"train", "eval", "train_disc", "eval_disc"}`` steps of ``gen`` (an
    ``AudioDecGenerator(use_pqc=False)``) with ``opt_g`` (a
    ``train.optim.Optimizer`` over its parameters) and, for the ``_disc``
    arms, ``disc`` (an ``nn.Module`` on the generator's device) with
    ``opt_d``.

    ``train(x, target)`` (both (B, T, 1) on the generator's device) runs
    forward and backward (``grad_accum`` microbatches, the SNR gate per
    microbatch), records the generator's gradient statistics (after the
    clip, with torch's clip factor ``min(1, clip / (norm + 1e-6))``, as the
    reference reads ``.grad``), steps the optimizer and returns ``(g_loss,
    d_loss, frags, stats)`` as tensors; ``train_disc`` then takes the
    discriminator's gradient on the updated generator's output (each
    microbatch re-forwarded with ``train=False``, without gradients) and
    steps ``opt_d``. ``eval`` / ``eval_disc`` return ``(g_loss, d_loss,
    frags)`` without gradients.

    Options as the JAX package reads them: ``compat_adv_on_waveform`` feeds
    ``y`` itself to ``gen_adv``; ``discriminator_remat`` recomputes each
    sub-discriminator's pair of passes in the backward
    (``torch.utils.checkpoint``), so one sub-discriminator's features are
    live at a time (a discriminator with ``num_subs`` / ``apply_sub``);
    ``discriminator_dtype: bf16`` runs the discriminator on bf16 copies of
    its parameters and input (gradients reach the f32 parameters) and
    returns its outputs in f32.

    ``group`` (a process group) spreads the batch over its ranks, each
    holding its rows of every microbatch: the SNR gate sums over all of them,
    the gradients are averaged over them once a step before the clip and the
    statistics, and the returned losses are the one-process values.

    In a profiler trace (utils/trace.py) the generator's step is the span
    ``dse.course.gen`` and the discriminator's ``dse.course.disc``, each
    with the children ``.forward`` (the microbatches' losses; the
    discriminator's re-forward of the generator included), ``.backward`` and
    ``.update`` (the gradient reduction, the generator's statistics and the
    optimizer step)."""
    mel_loss = MultiMelSpectrogramLoss(**config["mel_loss_params"], device=gen.device)
    gen_adv = GeneratorAdversarialLoss(**config.get("generator_adv_loss_params", {}))
    dis_adv = DiscriminatorAdversarialLoss(**config.get("discriminator_adv_loss_params", {}))
    feat_match = FeatureMatchLoss()
    l_mel = config["lambda_mel_loss"]
    l_snr = config.get("lambda_snr_loss", 0.0)
    l_wl1 = float(config.get("lambda_wave_l1", 0.0))
    l_adv = config.get("lambda_adv", 1.0)
    l_fm = config.get("lambda_feat_match", 2.0)
    compat_adv = config.get("compat_adv_on_waveform", False)
    remat = config.get("discriminator_remat", False) and hasattr(disc, "apply_sub")
    d_dtype = DISC_DTYPES[str(config.get("discriminator_dtype", "float32"))]
    grad_accum = int(config.get("grad_accum", 1))
    clip = float(config.get("generator_grad_norm", -1))

    call = _DiscCall(disc)

    def disc_apply(wav, sub=None):
        """D(wav), or sub-discriminator ``sub``'s features alone."""
        if d_dtype is None:
            return call(wav, sub)
        params = {f"disc.{n}": p.to(d_dtype) for n, p in disc.named_parameters()}
        return _to_f32(functional_call(call, params, (wav.to(d_dtype), sub)))

    def adv_fm_remat(y, target):
        adv, fm = 0.0, 0.0
        for i in range(disc.num_subs):
            def one(y_, t_, i=i):
                q_, q = disc_apply(y_, i), disc_apply(t_, i)
                # one-element lists: the losses divide by 1 and give the
                # sub-discriminator's raw term
                return gen_adv([q_]), feat_match([q_], [q])
            a, f = checkpoint(one, y, target, use_reentrant=False)
            adv, fm = adv + a, fm + f
        n = disc.num_subs
        return (adv / (n if gen_adv.average else 1),
                fm / (n if feat_match.average_by_discriminators else 1))

    def gen_loss(x, target, use_disc):
        y = gen(x, None, train=True)[0]
        mel = l_mel * mel_loss(y, target)
        snr = l_snr * (1.0 - torch.sigmoid(signal_noise_ratio(y, target, group=group)))
        total = mel + snr
        frags = {"mel_loss": mel, "snr_loss": snr}
        if l_wl1 > 0.0:
            wl1 = l_wl1 * torch.mean(torch.abs(y - target))
            total = total + wl1
            frags["wave_l1_loss"] = wl1
        if use_disc:
            if remat and not compat_adv:
                adv, fm = adv_fm_remat(y, target)
            else:
                p_ = disc_apply(y)
                with torch.no_grad():
                    p = disc_apply(target)
                adv, fm = gen_adv(y if compat_adv else p_), feat_match(p_, p)
            adv, fm = l_adv * adv, l_fm * fm
            total = total + adv + fm
            frags.update(adv_loss=adv, feat_loss=fm)
        return total, frags

    def dis_loss(y, target):
        if remat:
            terms = 0.0
            for i in range(disc.num_subs):
                def one(y_, t_, i=i):
                    real, fake = dis_adv([disc_apply(y_, i)], [disc_apply(t_, i)])
                    return real + fake
                terms = terms + checkpoint(one, y, target, use_reentrant=False)
            return l_adv * terms / (disc.num_subs if dis_adv.average else 1)
        real, fake = dis_adv(disc_apply(y), disc_apply(target))
        return l_adv * (real + fake)

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

    @spanned("course.gen")
    def generator_step(x, target, use_disc):
        gen.train()
        opt_g.zero_grad()
        g_loss, frags = 0.0, {}
        # the generator's gradient only: D's weights are constants here
        with frozen(disc.parameters() if use_disc else ()):
            for xm, tm in microbatches(x, target):
                with span("course.gen.forward"):
                    loss, fr = gen_loss(xm, tm, use_disc)
                with span("course.gen.backward"):
                    (loss / grad_accum).backward()
                g_loss = g_loss + loss.detach() / grad_accum
                for k, v in fr.items():
                    frags[k] = frags.get(k, 0.0) + v.detach() / grad_accum
        with span("course.gen.update"):
            average_gradients(opt_g.params, group)
            stats = grad_stats()
            opt_g.step()
        frags = pmean_values(dict(frags, _total=g_loss), group)
        return frags.pop("_total"), frags, stats

    @spanned("course.disc")
    def discriminator_step(x, target):
        opt_d.zero_grad()
        d_loss = 0.0
        for xm, tm in microbatches(x, target):
            with span("course.disc.forward"):
                with torch.no_grad():
                    y = gen(xm, None, train=False)[0]
                loss = dis_loss(y, tm)
            with span("course.disc.backward"):
                (loss / grad_accum).backward()
            d_loss = d_loss + loss.detach() / grad_accum
        with span("course.disc.update"):
            average_gradients(opt_d.params, group)
            opt_d.step()
        return pmean_values({"d": d_loss}, group)["d"]

    def train(x, target):
        g_loss, frags, stats = generator_step(x, target, False)
        return g_loss, torch.zeros((), device=x.device), frags, stats

    def need_disc(arm):
        if disc is None:
            raise ValueError(f"{arm} needs a discriminator: make_course_steps was given "
                             "disc=None")

    def train_disc(x, target):
        need_disc("train_disc")
        g_loss, frags, stats = generator_step(x, target, True)
        return g_loss, discriminator_step(x, target), frags, stats

    def global_values(g_loss, d_loss, frags):
        out = pmean_values(dict(frags, _g=g_loss, _d=d_loss), group)
        return out.pop("_g"), out.pop("_d"), out

    def evaluate(x, target):
        with torch.no_grad():
            g_loss, frags = gen_loss(x, target, False)
        return global_values(g_loss, torch.zeros((), device=x.device), frags)

    def evaluate_disc(x, target):
        need_disc("eval_disc")
        with torch.no_grad():
            g_loss, frags = gen_loss(x, target, True)
            d_loss = dis_loss(gen(x, None, train=False)[0], target)
        return global_values(g_loss, d_loss, frags)

    return {"train": train, "eval": evaluate, "train_disc": train_disc,
            "eval_disc": evaluate_disc}


class _LoaderWait:
    """The seconds a loop waited for its batches: ``wrap(batches)`` yields
    their items, each fetch timed and inside the span ``course.loader_wait``."""

    def __init__(self):
        self.seconds = 0.0

    def wrap(self, batches):
        batches = iter(batches)
        while True:
            t0 = time.perf_counter()
            with span("course.loader_wait"):
                item = next(batches, None)
            self.seconds += time.perf_counter() - t0
            if item is None:
                return
            yield item


def train_denoise_course(config: dict, gen, disc, train_loaders, val_loaders, *,
                         environment: str = "HPC", job_dir: str = "job_out",
                         task_name: str = "denoise", report=None, initial_params=None):
    """Run the course loop on ``gen`` and ``disc`` (None: no adversarial
    phase) in place, ``gen`` first loaded with ``initial_params`` (a state
    dict of its own) where given: the warm start of the reference's
    ``initial_model``. ``train_loaders`` / ``val_loaders`` are (clean, noise)
    pairs of iterables of numpy (B, T, 1) batches; LAPTOP mode takes three
    of each an epoch, any other ``environment`` all of them and writes
    ``{job_dir}/{task_name}checkpoint-{steps}`` (``state.pt`` holding
    ``{"params_generator": gen.state_dict()}``, ``config.yml`` beside it)
    after every epoch's training. ``report(category, series, value,
    iteration)`` is the scalar sink. Returns ``({"generator",
    "discriminator", "opt_generator", "opt_discriminator", "steps"},
    history)``, one history entry per epoch as the JAX loop keeps it.

    With ``parallel.data_devices`` above 1 (inside the ranks
    parallel/mesh.py::launch started) ``gen`` and ``disc`` lie on the rank's
    device and are made equal to rank 0's; a ``batch_size`` the ranks do not
    divide raises ValueError."""
    if initial_params is not None:
        gen.load_state_dict(initial_params)
    mesh = mesh_from_config(config)
    group = None
    if mesh is not None:
        n = mesh["data"].size()
        if config.get("batch_size", 0) % n:
            raise ValueError(f"batch_size {config['batch_size']} is not divisible by "
                             f"parallel.data_devices={n}")
        group = mesh.get_group("data")
        shard_train_state(mesh, [gen, disc] if disc is not None else [gen])
    rank0 = is_rank0()
    device = gen.device
    laptop = environment == "LAPTOP"
    opt_g = build_optimizer(gen.parameters(), "Adam", config["generator_optimizer_params"],
                            grad_norm=config.get("generator_grad_norm", -1))
    opt_d = None
    if disc is not None:
        opt_d = build_optimizer(disc.parameters(), "Adam",
                                config["discriminator_optimizer_params"],
                                grad_norm=config.get("discriminator_grad_norm", -1))
    steps_fns = make_course_steps(gen, disc, config, opt_g, opt_d, group)
    grad_accum = int(config.get("grad_accum", 1))

    def put(a):
        rows = shard_batch(mesh, np.asarray(a, np.float32), grad_accum)
        return torch.as_tensor(rows, device=device)

    mix_rng = np.random.default_rng(config.get("seed", 82))
    noise_dropout_rate = config["noise_dropout_rate"]
    epoch_disc = config["epoch_to_enable_discriminator"]
    epoch_ndo_decay = config["epoch_to_enable_noise_dropout_decay"]
    discriminator_enabled = False
    steps = config.get("step", 0)
    start_time = time.perf_counter()
    loader_wait = _LoaderWait()

    def _report(category, series, value, iteration):
        if report is not None and rank0:
            report(category, series, float(value), iteration)

    history = []
    for epoch in range(config["epochs"]):
        if disc is not None and epoch == epoch_disc:
            discriminator_enabled = True
        if epoch > epoch_ndo_decay:
            noise_dropout_rate -= config["noise_dropout_rate_decay"]

        logger.info("Epoch %d", epoch)
        train_gen, train_dis, last_frags = [], [], {}
        for i_batch, (clean_batch, noise_batch) in enumerate(
                loader_wait.wrap(zip(*train_loaders))):
            if laptop and i_batch == 3:
                break
            if noise_dropout_rate > 0.0:
                noise_batch = noise_dropout(clean_batch, noise_batch, noise_dropout_rate,
                                            mix_rng)
            mixed = add_noise(clean_batch, noise_batch, mix_rng.integers(10, 20))
            fn = steps_fns["train_disc" if discriminator_enabled else "train"]
            g_loss, d_loss, frags, gstats = fn(put(mixed), put(clean_batch))
            steps += 1
            last_frags = frags
            g_loss, d_loss = float(g_loss), float(d_loss)
            train_gen.append(g_loss)
            train_dis.append(d_loss)
            if steps % 100 == 0 or laptop:
                dt = time.perf_counter() - start_time
                logger.info("Training: Step %d \t Time: %d:%02d:%02d \t Loader wait: %.1f%%",
                            steps, int(dt // 3600), int(dt // 60) % 60, int(dt) % 60,
                            100.0 * loader_wait.seconds / dt)
                _report("Gradients", "Maximum", gstats["grad_max"], steps)
                _report("Gradients", "Minimum", gstats["grad_min"], steps)
                _report("Gradients", "Average (Abs)", gstats["grad_avg"], steps)
                _report("Generator Batch Loss", "Train", g_loss, steps)
                _report("Discriminator Batch Loss", "Train", d_loss, steps)
                for name, value in frags.items():
                    _report("Generator Batch Loss", name, value, steps)
        avg_gen = float(np.mean(train_gen)) if train_gen else 0.0
        avg_dis = float(np.mean(train_dis)) if train_dis else 0.0

        if not laptop:
            save_checkpoint(os.path.join(job_dir, f"{task_name}checkpoint-{steps}"),
                            {"params_generator": gen.state_dict()}, config=config)

        gen_val = dis_val = 0.0
        n_val = 0
        for i_batch, (clean_batch, noise_batch) in enumerate(zip(*val_loaders)):
            if laptop and i_batch == 3:
                break
            mixed = add_noise(clean_batch, noise_batch, mix_rng.integers(10, 20))
            fn = steps_fns["eval_disc" if discriminator_enabled else "eval"]
            g_loss, d_loss, _ = fn(put(mixed), put(clean_batch))
            gen_val += float(g_loss)
            dis_val += float(d_loss)
            n_val += 1
        if n_val == 0:
            logger.warning("validation yielded no batches; val losses report 0")
        n_val = max(n_val, 1)
        _report("Generator Loss", "Train", avg_gen, epoch)
        _report("Generator Loss", "Validation", gen_val / n_val, epoch)
        _report("Discriminator Loss", "Train", avg_dis, epoch)
        _report("Discriminator Loss", "Validation", dis_val / n_val, epoch)
        history.append({
            "epoch": epoch, "train_gen": avg_gen, "train_dis": avg_dis,
            "val_gen": gen_val / n_val, "val_dis": dis_val / n_val,
            "frags": {k: float(v) for k, v in last_frags.items()},
        })
    return {"generator": gen, "discriminator": disc, "opt_generator": opt_g,
            "opt_discriminator": opt_d, "steps": steps}, history
