"""The AudioDec workloads of the port against the JAX package's, on the CPU
in f32: each step function from the same weights, codebooks and numpy batch
(autoencoder ``gen_stage1``, ``gen_stage2``, ``dis``, ``eval_stage1/2``, its
UnivNet-discriminator variant; the vocoder's ``gen``, ``gen_adv``, ``dis``,
``eval``, ``eval_adv``; denoise ``train`` / ``eval``; the statistics), and
both phase-switching trainers driven for 6 steps on the same batches.

The networks are tests/test_cli.py's tiny topology (``TINY_GEN``,
``TINY_DISC``, ``MEL_TINY``), their params drawn with numpy
(``seeded_init``, no init compiled; the discriminators' by ``disc_params``,
the vocoder's at about unit gain by ``rescaled``: at the official init its
output is almost all bias, and the spectral losses' gradients are
ill-conditioned there) and carried into the port (``from_jax_params``,
``vocoder_from_jax_params``, ``discriminator_from_jax_params``,
``vq_state_from_jax``), the codebooks scaled to the projector's output
(``_codebooks``). Each JAX trainer
is built once (its jitted steps compile once) and its steps run on copies
of its first state. Tolerances, as tests/test_torch_port_train_adv.py's:
loss fragments and perplexities rtol 1e-5; parameters after an update atol
1e-6 where the gradient is above 1e-4 of its tensor's largest, and within 2
lr everywhere (Adam's first step is about lr * g / (|g| + eps)); the EMA
codebooks rtol 1e-5; frozen parts and the analyzer bit-unchanged; the
statistics rtol 1e-5; over the 6-step runs the same steps at the same step
counts, each log interval's mean losses rtol 1e-4, equal learning rates.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dl_speech_enhancement_tpu.models import (
    AudioDecGenerator as JaxGenerator,
    HiFiGANDiscriminator as JaxDiscriminator,
    HiFiGANGenerator as JaxVocoder,
    UnivNetDiscriminator as JaxUnivNet,
)
from dl_speech_enhancement_tpu.train import optim as joptim
from dl_speech_enhancement_tpu.train.workloads import autoencoder as jae
from dl_speech_enhancement_tpu.train.workloads import denoise as jdn
from dl_speech_enhancement_tpu.train.workloads import statistic as jstat
from dl_speech_enhancement_tpu.train.workloads import vocoder as jvoc
from dl_speech_enhancement_tpu_torch.models import (
    AudioDecGenerator,
    HiFiGANDiscriminator,
    HiFiGANGenerator,
    UnivNetDiscriminator,
)
from dl_speech_enhancement_tpu_torch.train.workloads import autoencoder, denoise, statistic
from dl_speech_enhancement_tpu_torch.train.workloads import vocoder
from dl_speech_enhancement_tpu_torch.utils.jax_params import (
    discriminator_from_jax_params,
    from_jax_params,
    vocoder_from_jax_params,
    vq_state_from_jax,
)
from test_cli import MEL_TINY, TINY_DISC, TINY_GEN
from test_torch_port_discriminator import TINY_UNIV, disc_params
from test_torch_port_hifigan import rescaled, seeded_init
from torch_port_threads import one_thread  # noqa: F401

LR = 1e-3
FRAG_RTOL = 1e-5
PARAM_ATOL = 1e-6
LOG_RTOL = 1e-4
VOC = dict(in_channels=16, out_channels=1, channels=32, kernel_size=7, upsample_scales=(4, 3),
           upsample_kernel_sizes=(8, 6), resblock_kernel_sizes=(3,),
           resblock_dilations=((1, 3),))
BATCH = (2, 1200, 1)
CONFIG = dict(
    outdir=None, use_mel_loss=True, mel_loss_params=MEL_TINY, lambda_mel_loss=45.0,
    lambda_vq_loss=1.0, lambda_adv=1.0, lambda_feat_match=2.0, use_feat_match_loss=True,
    generator_adv_loss_params={"average_by_discriminators": False},
    discriminator_adv_loss_params={"average_by_discriminators": False},
    generator_optimizer_params={"lr": LR, "betas": [0.5, 0.9]},
    discriminator_optimizer_params={"lr": LR, "betas": [0.5, 0.9]},
    # schedules that move inside 6 steps: each counts its own updates
    generator_scheduler_type="StepLR",
    generator_scheduler_params={"step_size": 2, "gamma": 0.5},
    discriminator_scheduler_type="MultiStepLR",
    discriminator_scheduler_params={"gamma": 0.5, "milestones": [1, 2]},
    generator_grad_norm=-1, discriminator_grad_norm=-1, save_interval_steps=10 ** 9,
    eval_interval_steps=10 ** 9, log_interval_steps=3, train_max_steps=6, batch_size=2,
    seed=0)
AE_CONFIG = dict(CONFIG, start_steps={"generator": 0, "discriminator": 3})
VOC_CONFIG = dict(CONFIG, use_stft_loss=True, lambda_stft_loss=45.0,
                  stft_loss_params={"fft_sizes": [128, 256], "hop_sizes": [30, 60],
                                    "win_lengths": [120, 240]},
                  generator_train_start_steps=1, discriminator_train_start_steps=0)
DN_CONFIG = dict(CONFIG, use_stft_loss=True, lambda_stft_loss=45.0,
                 stft_loss_params=VOC_CONFIG["stft_loss_params"])


def _codebooks(gen, params, vq, x):
    """``vq`` scaled to the spread of the projector's output on ``x``. The
    init's N(0, 1) codebooks lie far from the tiny codec's codes (std ~0.05):
    every frame takes the codeword of least norm, the output repeats every
    hop, and its spectrum has bins at f32's rounding floor, where the mel
    loss's gradient is ill-conditioned (JAX against f64 differs by 1e-3 of
    its largest there, as the port does)."""
    z = gen.projector(params["projector"], gen.encoder(params["encoder"], jnp.asarray(x)))
    s = jnp.std(z)
    return type(vq)(vq.embed * s, vq.cluster_size, vq.embed_avg * s)


def _seeded(model, params):
    """``model`` whose ``init`` gives ``params`` (the JAX trainers call it)."""
    model.init = lambda key: params
    return model


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _copy(tree):
    return jax.tree_util.tree_map(jnp.array, tree)


def _batches(seed, n=6, pair=False):
    rng = np.random.default_rng(seed)
    t = np.arange(BATCH[1])[None, :, None] / 48.0

    def one():
        ph = rng.uniform(0, np.pi, (BATCH[0], 1, 1))
        return (0.5 * np.sin(2 * np.pi * t + ph) + 0.05 * rng.standard_normal(BATCH)).astype(
            np.float32)
    if pair:
        return [(one(), one()) for _ in range(n)]
    return [one() for _ in range(n)]


def _port_gen(params, use_pqc=True):
    return from_jax_params(AudioDecGenerator(**TINY_GEN, use_pqc=use_pqc, device="cpu"),
                           _np(params))


def _port_disc(params, univ=False):
    disc = (UnivNetDiscriminator(**TINY_UNIV, device="cpu") if univ
            else HiFiGANDiscriminator(**TINY_DISC, device="cpu"))
    return discriminator_from_jax_params(disc, _np(params))


def _port_voc(params):
    return vocoder_from_jax_params(HiFiGANGenerator(**VOC, device="cpu"), _np(params))


def held_frags(tfr, jfr, rtol=FRAG_RTOL):
    assert sorted(tfr) == sorted(jfr)
    for k in jfr:
        np.testing.assert_allclose(float(tfr[k]), float(jfr[k]), rtol=rtol, err_msg=k)


def held_params(module, ref, frozen=()):
    """``module``'s parameters after a step against ``ref``'s (the JAX
    step's, carried across), by each parameter's gradient; the parameters
    under ``frozen`` prefixes took no gradient and equal ``ref``'s bit for
    bit."""
    got = dict(module.named_parameters())
    for name, p_ref in ref.named_parameters():
        p = got[name].detach()
        if name.startswith(frozen):
            assert got[name].grad is None, name
            assert torch.equal(p, p_ref.detach()), name
            continue
        g = got[name].grad.abs()
        diff = (p - p_ref.detach()).abs()
        assert diff.max() <= 2 * LR, name
        big = g > 1e-4 * g.max()
        assert diff[big].max() <= PARAM_ATOL, name


def held_vq(tvq, jvq, rtol=FRAG_RTOL):
    for t, j in zip(tvq, jvq):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=1e-7)


def unchanged(module, ref) -> bool:
    return all(torch.equal(a, b) for a, b in zip(module.state_dict().values(),
                                                  ref.state_dict().values()))


# ---------------------------------------------------------------- autoencoder


def _jax_ae(univ=False):
    disc = JaxUnivNet(**TINY_UNIV) if univ else JaxDiscriminator(**TINY_DISC)
    gen = JaxGenerator(**TINY_GEN, use_pqc=True)
    params, vq = seeded_init(gen, 7)
    _seeded(gen, (params, _codebooks(gen, params, vq, _batches(0, n=1)[0])))
    _seeded(disc, disc_params(disc, 8))
    tr = jae.Trainer(0, 0, {"train": []}, gen, disc, AE_CONFIG, key=jax.random.PRNGKey(7))
    return tr, _copy(tr.state)


@pytest.fixture(scope="module")
def jax_ae():
    return _jax_ae()


def _port_ae(state, config=AE_CONFIG, univ=False, loader=None):
    gen = _port_gen(state["params_generator"])
    disc = _port_disc(state["params_discriminator"], univ)
    return autoencoder.Trainer(0, 0, {"train": loader or []}, gen, disc, config,
                               vq_state=vq_state_from_jax(_np(state["vq_state"])))


@pytest.mark.parametrize("stage", [1, 2])
def test_autoencoder_generator_step_matches_jax(jax_ae, stage):
    jtr, state = jax_ae
    x = _batches(1, n=1)[0]
    new, jfr, jppl = jtr._steps_fns[f"gen_stage{stage}"](_copy(state), jnp.asarray(x))
    tr = _port_ae(state)
    vq, tfr, tppl = tr._steps_fns[f"gen_stage{stage}"](tr.vq_state, torch.from_numpy(x))
    held_frags(tfr, jfr)
    np.testing.assert_allclose(tppl.numpy(), np.asarray(jppl), rtol=FRAG_RTOL)
    frozen = () if stage == 1 else tuple(f"{n}." for n in autoencoder.FROZEN_STAGE2)
    held_params(tr.gen, _port_gen(new["params_generator"]), frozen)
    held_vq(vq, new["vq_state"])
    if stage == 2:  # EMA off: the codebooks stay, and D takes no gradient
        assert vq is tr.vq_state
        held_vq(vq, state["vq_state"], rtol=0.0)
        assert all(p.grad is None for p in tr.disc.parameters())
        assert unchanged(tr.disc, _port_disc(state["params_discriminator"]))
    else:
        assert not np.array_equal(vq.embed.numpy(), np.asarray(state["vq_state"].embed))


def test_autoencoder_discriminator_step_matches_jax(jax_ae):
    jtr, state = jax_ae
    x = _batches(2, n=1)[0]
    new, jfr = jtr._steps_fns["dis"](_copy(state), jnp.asarray(x))
    tr = _port_ae(state)
    tfr = tr._steps_fns["dis"](tr.vq_state, torch.from_numpy(x))
    held_frags(tfr, jfr)
    held_params(tr.disc, _port_disc(new["params_discriminator"]))
    assert unchanged(tr.gen, _port_gen(state["params_generator"]))
    assert all(p.grad is None for p in tr.gen.parameters())


@pytest.mark.parametrize("stage", [1, 2])
def test_autoencoder_eval_matches_jax(jax_ae, stage):
    jtr, state = jax_ae
    x = _batches(3, n=1)[0]
    jfr, jppl = jtr._steps_fns[f"eval_stage{stage}"](_copy(state), jnp.asarray(x))
    tr = _port_ae(state)
    tfr, tppl = tr._steps_fns[f"eval_stage{stage}"](tr.vq_state, torch.from_numpy(x))
    held_frags(tfr, jfr)
    np.testing.assert_allclose(tppl.numpy(), np.asarray(jppl), rtol=FRAG_RTOL)


def test_autoencoder_univnet_discriminator_matches_jax():
    """symAudioDecUniv: the stage-2 generator step and the discriminator
    step with the UnivNet MRSD + MPD."""
    jtr, state = _jax_ae(univ=True)
    x = _batches(4, n=1)[0]
    new, jfr, _ = jtr._steps_fns["gen_stage2"](_copy(state), jnp.asarray(x))
    new_d, jdfr = jtr._steps_fns["dis"](_copy(new), jnp.asarray(x))
    tr = _port_ae(state, univ=True)
    vq, tfr, _ = tr._steps_fns["gen_stage2"](tr.vq_state, torch.from_numpy(x))
    held_frags(tfr, jfr)
    held_params(tr.gen, _port_gen(new["params_generator"]),
                tuple(f"{n}." for n in autoencoder.FROZEN_STAGE2))
    # the discriminator step from the same generator on both sides
    tr2 = _port_ae(new, univ=True)
    held_frags(tr2._steps_fns["dis"](tr2.vq_state, torch.from_numpy(x)), jdfr)
    held_params(tr2.disc, _port_disc(new_d["params_discriminator"], univ=True))


# ---------------------------------------------------------------- the 6-step runs


def _recorded(trainer, names):
    """Wrap ``trainer``'s step functions to log ``(steps, name)``, and its
    TensorBoard writes to keep each log interval's means."""
    ran, logged = [], []
    for name in names:
        fn = trainer._steps_fns[name]

        def wrapped(*args, _fn=fn, _name=name):
            ran.append((trainer.steps, _name))
            return _fn(*args)
        trainer._steps_fns[name] = wrapped
    trainer._write_to_tensorboard = lambda losses: logged.append((trainer.steps, dict(losses)))
    return ran, logged


def _lr(config, role, updates):
    p = config[f"{role}_optimizer_params"]
    schedule = joptim.build_schedule(p["lr"], config[f"{role}_scheduler_type"],
                                     config[f"{role}_scheduler_params"])
    return float(schedule(updates)) if callable(schedule) else float(schedule)


def _drive(jtr, state0, tr, names, batches, config):
    """Both trainers through ``run()`` on the same 6 batches from the same
    state; returns what each ran and logged."""
    jtr.state, jtr.steps, jtr.epochs, jtr.finish_train = _copy(state0), 0, 0, False
    jtr.data_loader = {"train": batches}
    jtr.total_train_loss.clear()
    saved = dict(jtr._steps_fns)
    try:
        jran, jlog = _recorded(jtr, names)
        tran, tlog = _recorded(tr, names)
        jtr.run()
        tr.run()
    finally:
        jtr._steps_fns = saved
    assert jtr.steps == tr.steps == 6
    assert tran == jran
    assert [s for s, _ in tlog] == [s for s, _ in jlog] == [3, 6]
    for (_, t), (_, j) in zip(tlog, jlog):
        assert sorted(t) == sorted(j)
        for k in j:
            np.testing.assert_allclose(t[k], j[k], rtol=LOG_RTOL, err_msg=k)
    for role, opt in (("generator", tr.opt_g), ("discriminator", tr.opt_d)):
        n = sum(1 for _, name in tran if (name == "dis") == (role == "discriminator"))
        # optax's schedules run in f32
        assert np.float32(opt.lr) == np.float32(_lr(config, role, n)), role
    return tran


def test_autoencoder_trainer_six_steps_match_jax(jax_ae):
    jtr, state = jax_ae
    batches = _batches(5)
    tr = _port_ae(state, loader=batches)
    ran = _drive(jtr, state, tr, ("gen_stage1", "gen_stage2", "dis"), batches, AE_CONFIG)
    # `>=` gates: stage 1 at steps 0-2, stage 2 and the discriminator from 3
    assert ran == [(0, "gen_stage1"), (1, "gen_stage1"), (2, "gen_stage1"),
                   (3, "gen_stage2"), (3, "dis"), (4, "gen_stage2"), (4, "dis"),
                   (5, "gen_stage2"), (5, "dis")]
    assert tr.opt_g.lr == LR / 8 and tr.opt_d.lr == LR / 4


# ---------------------------------------------------------------- vocoder


@pytest.fixture(scope="module")
def jax_voc():
    analyzer = JaxGenerator(**TINY_GEN, use_pqc=True)
    ap, vq = seeded_init(analyzer, 3)
    vq = _codebooks(analyzer, ap, vq, _batches(0, n=1)[0])
    voc, disc = JaxVocoder(**VOC), JaxDiscriminator(**TINY_DISC)
    _seeded(voc, rescaled(seeded_init(voc, 4), 5))
    _seeded(disc, disc_params(disc, 6))
    tr = jvoc.Trainer(0, 0, {"train": []}, analyzer, ap, vq, voc, disc, VOC_CONFIG,
                      key=jax.random.PRNGKey(4))
    return tr, _copy(tr.state)


def _port_voc_trainer(state, loader=None):
    analyzer = _port_gen(state["params_analyzer"])
    return vocoder.Trainer(0, 0, {"train": loader or []}, analyzer,
                           vq_state_from_jax(_np(state["vq_state"])),
                           _port_voc(state["params_generator"]),
                           _port_disc(state["params_discriminator"]), VOC_CONFIG)


@pytest.mark.parametrize("fn", ["gen", "gen_adv"])
def test_vocoder_generator_step_matches_jax(jax_voc, fn):
    jtr, state = jax_voc
    x = _batches(6, n=1)[0]
    new, jfr = jtr._steps_fns[fn](_copy(state), jnp.asarray(x))
    tr = _port_voc_trainer(state)
    tfr = tr._steps_fns[fn](torch.from_numpy(x))
    held_frags(tfr, jfr)
    held_params(tr.gen, _port_voc(new["params_generator"]))
    assert all(p.grad is None for p in tr.disc.parameters())
    assert unchanged(tr.analyzer, _port_gen(state["params_analyzer"]))
    assert all(not p.requires_grad for p in tr.analyzer.parameters())


def test_vocoder_discriminator_step_and_evals_match_jax(jax_voc):
    jtr, state = jax_voc
    x = _batches(7, n=1)[0]
    new, jfr = jtr._steps_fns["dis"](_copy(state), jnp.asarray(x))
    tr = _port_voc_trainer(state)
    held_frags(tr._steps_fns["dis"](torch.from_numpy(x)), jfr)
    held_params(tr.disc, _port_disc(new["params_discriminator"]))
    assert unchanged(tr.gen, _port_voc(state["params_generator"]))
    for fn in ("eval", "eval_adv"):
        held_frags(tr._steps_fns[fn](torch.from_numpy(x)),
                   jtr._steps_fns[fn](_copy(new), jnp.asarray(x)))


def test_vocoder_trainer_six_steps_match_jax(jax_voc):
    jtr, state = jax_voc
    batches = _batches(8)
    tr = _port_voc_trainer(state, loader=batches)
    ran = _drive(jtr, state, tr, ("gen", "gen_adv", "dis"), batches, VOC_CONFIG)
    # `>` gates (the v1 config's 1 and 0): the discriminator from step 1,
    # the generator (adversarial at once) from step 2
    assert ran == [(1, "dis"), (2, "gen_adv"), (2, "dis"), (3, "gen_adv"), (3, "dis"),
                   (4, "gen_adv"), (4, "dis"), (5, "gen_adv"), (5, "dis")]
    assert unchanged(tr.analyzer, _port_gen(state["params_analyzer"]))


# ---------------------------------------------------------------- denoise, statistics


def test_denoise_steps_match_jax():
    gen = JaxGenerator(**TINY_GEN, use_pqc=True)
    params, vq = seeded_init(gen, 9)
    vq = _codebooks(gen, params, vq, _batches(0, n=1)[0])
    jtr = jdn.Trainer(0, 0, {"train": []}, gen, DN_CONFIG, initial_state=(params, vq))
    state = _copy(jtr.state)
    x_n, x_c = _batches(10, n=1, pair=True)[0]
    new, jfr, _ = jtr._steps_fns["train"](_copy(state), jnp.asarray(x_n), jnp.asarray(x_c))
    tr = denoise.Trainer(0, 0, {"train": []}, _port_gen(params), DN_CONFIG,
                         vq_state=vq_state_from_jax(_np(vq)))
    tfr, _ = tr._steps_fns["train"](tr.vq_state, torch.from_numpy(x_n), torch.from_numpy(x_c))
    held_frags(tfr, jfr)
    held_params(tr.gen, _port_gen(new["params_generator"]),
                tuple(f"{n}." for n in denoise.FROZEN))
    held_vq(tr.vq_state, vq, rtol=0.0)
    jfr, _ = jtr._steps_fns["eval"](new, jnp.asarray(x_n), jnp.asarray(x_c))
    tfr, _ = tr._steps_fns["eval"](tr.vq_state, torch.from_numpy(x_n), torch.from_numpy(x_c))
    held_frags(tfr, jfr)


def test_statistics_match_jax():
    analyzer = JaxGenerator(**TINY_GEN, use_pqc=True)
    params, vq = seeded_init(analyzer, 5)
    vq = _codebooks(analyzer, params, vq, _batches(0, n=1)[0])
    rng = np.random.default_rng(12)
    clips = [(0.3 * rng.standard_normal((n, 1))).astype(np.float32)
             for n in (360, 1250, 7, 2400)]
    clips.append(("utt", (0.3 * rng.standard_normal(900)).astype(np.float32)))
    ref = jstat.compute_statistics(analyzer, params, vq, clips)
    got = statistic.compute_statistics(_port_gen(params), vq_state_from_jax(_np(vq)), clips)
    assert got.shape == (2, 16) and got.dtype == np.float32 and np.all(got[1] > 0)
    np.testing.assert_allclose(got, ref, rtol=FRAG_RTOL, atol=1e-7)
    ref = jstat.compute_statistics(analyzer, params, vq, clips, batch_length=600)
    got = statistic.compute_statistics(_port_gen(params), vq_state_from_jax(_np(vq)), clips,
                                       batch_length=600)
    np.testing.assert_allclose(got, ref, rtol=FRAG_RTOL, atol=1e-7)
