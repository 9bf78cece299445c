"""Data-parallel training of the port over two gloo ranks on the host, against
the port's one-process step on the whole batch and the JAX package's step on
a 2-device mesh (JAX's SPMD data parallelism, tests/test_parallel.py).

Counterparts of tests/test_parallel.py's DP tests: the course ``train_disc``
step (:73), the codec's stage-1 step with its EMA codebooks (:97), a
16-row batch (:227), the ``TrainerGAN`` built from ``parallel.data_devices``
(:434) and a batch the ranks do not divide (:473); the course loop (:485)
and the quantizer's ``axis_name`` (:149) are held in
tests/test_torch_port_train.py and tests/test_torch_port_vq.py. Beside them:
the course step with ``grad_accum=2`` (each rank holds its part of every
microbatch), the vocoder workload's spectral convergence, the statistic
workload's sums, and a checkpoint written by two ranks that resumes in one
process. Every rank case runs in one launch (tests/torch_port_ranks.py).

Tolerances, JAX's for DP (tests/test_parallel.py:91-95): losses rtol 2e-4,
parameters atol 5e-5; the codebooks atol 1e-5 (JAX's :139); perplexity and
the statistics rtol 1e-5. The vocoder's parameters are held at 5e-5 where
their gradient is above 1e-4 of its tensor's largest and within 2 lr
elsewhere, as tests/test_torch_port_workloads.py holds them: a gradient at
f32's rounding floor takes either sign in two summation orders, and Adam's
first step moves it by lr either way.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from dl_speech_enhancement_tpu.models import (
    AudioDecGenerator as JaxGenerator,
    HiFiGANDiscriminator as JaxDiscriminator,
    HiFiGANGenerator as JaxVocoder,
)
from dl_speech_enhancement_tpu.parallel import make_mesh, shard_batch, shard_train_state
from dl_speech_enhancement_tpu.train import optim as joptim
from dl_speech_enhancement_tpu.train.denoise_course import make_course_steps as jax_course
from dl_speech_enhancement_tpu.train.workloads import autoencoder as jae
from dl_speech_enhancement_tpu.train.workloads import statistic as jstat
from dl_speech_enhancement_tpu.train.workloads import vocoder as jvoc
from dl_speech_enhancement_tpu_torch.models import (
    AudioDecGenerator,
    HiFiGANDiscriminator,
    HiFiGANGenerator,
)
from dl_speech_enhancement_tpu_torch.train.workloads import autoencoder
from dl_speech_enhancement_tpu_torch.utils.jax_params import (
    discriminator_from_jax_params,
    from_jax_params,
    vocoder_from_jax_params,
    vq_state_from_jax,
)
from test_cli import TINY_DISC as CLI_DISC
from test_cli import TINY_GEN
from test_torch_port_discriminator import disc_params
from test_torch_port_hifigan import rescaled, seeded_init
from test_torch_port_train import MEL_TINY, SMALL, TINY_DISC
from test_torch_port_workloads import AE_CONFIG, VOC, VOC_CONFIG, _codebooks
from torch_port_ranks import ADAM, held_by_gradient, run_here, run_ranks
from torch_port_threads import one_thread  # noqa: F401

LOSS_RTOL = 2e-4
PARAM_ATOL = 5e-5
VQ_ATOL = 1e-5
RTOL = 1e-5
COURSE = dict(mel_loss_params=MEL_TINY, lambda_mel_loss=45.0, lambda_snr_loss=1.0,
              lambda_adv=1.0, lambda_feat_match=2.0,
              generator_adv_loss_params={"average_by_discriminators": False},
              discriminator_adv_loss_params={"average_by_discriminators": False})
ACCUM = dict(COURSE, grad_accum=2, lambda_wave_l1=100.0, generator_grad_norm=0.5)
TRAINER = dict(AE_CONFIG, batch_size=4, log_interval_steps=10 ** 9, train_max_steps=3,
               generator_scheduler_type=None, discriminator_scheduler_type=None,
               start_steps={"generator": 0, "discriminator": 2})


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _sines(rng, b, t, noise=0.05):
    ph = rng.uniform(0, np.pi, (b, 1, 1))
    tt = np.arange(t)[None, :, None] / 48.0
    return (0.5 * np.sin(2 * np.pi * tt + ph)
            + noise * rng.standard_normal((b, t, 1))).astype(np.float32)


def _on_mesh(fn, state, *xs):
    mesh = make_mesh(2)
    return fn(shard_train_state(mesh, state), *(shard_batch(mesh, x) for x in xs))


def _course_inputs(seed, b):
    gen, disc = JaxGenerator(**SMALL, use_pqc=False), JaxDiscriminator(**TINY_DISC)
    gp, _ = seeded_init(gen, seed)
    rng = np.random.default_rng(seed)
    return gen, disc, {"gen_kw": SMALL, "gen_params": _np(gp), "disc_kw": TINY_DISC,
                       "disc_params": disc_params(disc, seed + 1),
                       "mixed": (0.3 * rng.standard_normal((b, 240, 1))).astype(np.float32),
                       "clean": (0.3 * rng.standard_normal((b, 240, 1))).astype(np.float32)}


def _ae_inputs(seed):
    gen, disc = JaxGenerator(**TINY_GEN, use_pqc=True), JaxDiscriminator(**CLI_DISC)
    params, vq = seeded_init(gen, seed)
    x = _sines(np.random.default_rng(seed), 4, 1200)
    vq = _codebooks(gen, params, vq, x)
    return gen, disc, {"gen_kw": TINY_GEN, "gen_params": _np(params), "vq": _np(vq),
                       "disc_kw": CLI_DISC, "disc_params": disc_params(disc, seed + 1)}


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """Each case's inputs, and the JAX models they were drawn for."""
    out = {}
    for name, seed, b, cfg, arm in (("course", 0, 8, COURSE, "train_disc"),
                                    ("accum", 1, 8, ACCUM, "train"),
                                    ("rows16", 2, 16, COURSE, "train_disc")):
        gen, disc, kw = _course_inputs(seed, b)
        out[name] = ("course_step", dict(kw, config=cfg, arm=arm), (gen, disc))
    gen, disc, kw = _ae_inputs(3)
    x = _sines(np.random.default_rng(13), 4, 1200)
    out["stage1"] = ("autoencoder_stage1", dict(kw, config=AE_CONFIG, x=x), (gen, disc))
    batches = [_sines(np.random.default_rng(20 + i), 4, 1200) for i in range(3)]
    ckpt = tmp_path_factory.mktemp("ckpt")
    out["trainer"] = ("ae_trainer", dict(kw, config=TRAINER, batches=batches,
                                         outdir=str(ckpt)), None)
    out["indivisible"] = ("denoise_indivisible", {
        "gen_kw": TINY_GEN, "gen_params": kw["gen_params"], "vq": kw["vq"],
        "config": dict(TRAINER, outdir=None),
        "batches": [(batches[0][:3], batches[0][:3])]}, None)
    # the vocoder on the codec's codes, its gains about unit
    voc = JaxVocoder(**VOC)
    out["vocoder"] = ("vocoder_step", {
        "an_kw": TINY_GEN, "an_params": kw["gen_params"], "vq": kw["vq"], "voc_kw": VOC,
        "voc_params": rescaled(seeded_init(voc, 4), 5), "disc_kw": CLI_DISC,
        "disc_params": kw["disc_params"], "config": VOC_CONFIG,
        "x": _sines(np.random.default_rng(14), 4, 1200)}, (gen, voc, disc))
    rng = np.random.default_rng(15)
    clips = [(0.3 * rng.standard_normal((n, 1))).astype(np.float32)
             for n in (360, 1250, 7, 2400, 600)]
    out["statistic"] = ("statistics", {"an_kw": TINY_GEN, "an_params": kw["gen_params"],
                                       "vq": kw["vq"], "clips": clips}, gen)
    return out


@pytest.fixture(scope="module")
def ranks(cases, tmp_path_factory):
    """Both ranks' results of every case, from one launch."""
    return run_ranks(2, {key: (name, kw) for key, (name, kw, _) in cases.items()},
                     tmp_path_factory.mktemp("rendezvous"))


def _here(cases, key):
    name, kw, _ = cases[key]
    return run_here(name, **kw)


def _same_on_both(ranks, key):
    """Rank 1's result of ``key`` equals rank 0's (the replicated state)."""
    a, b = ranks[0][key], ranks[1][key]
    for part in ("gen", "disc", "voc"):
        if part in a:
            for k in a[part]:
                np.testing.assert_array_equal(a[part][k], b[part][k], err_msg=f"{part}.{k}")
    return a


def held_state(got: dict, ref: dict, atol=PARAM_ATOL, what=""):
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], atol=atol, rtol=0, err_msg=f"{what}{k}")


def held_losses(got: dict, ref: dict):
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], float(ref[k]), rtol=LOSS_RTOL, err_msg=k)


def _port_gen(params, kw, use_pqc=False):
    return from_jax_params(AudioDecGenerator(**kw, use_pqc=use_pqc, device="cpu"), params)


def _port_disc(params, kw):
    return discriminator_from_jax_params(HiFiGANDiscriminator(**kw, device="cpu"), params)


def _state_np(module):
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


def _jax_course_step(cases, key):
    _, kw, (gen, disc) = cases[key]
    cfg = kw["config"]
    opt_g = joptim.build_optimizer("Adam", ADAM, grad_norm=cfg.get("generator_grad_norm", -1))
    opt_d = joptim.build_optimizer("Adam", ADAM)
    state = {"params_generator": kw["gen_params"], "params_discriminator": kw["disc_params"],
             "opt_generator": opt_g.init(kw["gen_params"]),
             "opt_discriminator": opt_d.init(kw["disc_params"])}
    state = jax.tree_util.tree_map(jnp.asarray, state)
    step = jax_course(gen, disc, cfg, opt_g, opt_d)[kw["arm"]]
    return _on_mesh(step, state, kw["mixed"], kw["clean"])


@pytest.mark.parametrize("key", ["course", "accum"], ids=["train_disc-snr", "grad_accum2"])
def test_course_step_over_two_ranks(cases, ranks, key):
    """The course step (the SNR gate over the ranks' energy sums; with
    ``grad_accum=2`` each rank's part of both microbatches, the clip and the
    gradient statistics after the one reduction) equals the port's
    one-process step and the JAX step on a 2-device mesh."""
    got = _same_on_both(ranks, key)
    one = _here(cases, key)
    new, jg, jd, jfr, jst = _jax_course_step(cases, key)
    for ref_g, ref_d, ref_frags in ((one["g"], one["d"], one["frags"]), (jg, jd, jfr)):
        np.testing.assert_allclose(got["g"], float(ref_g), rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["d"], float(ref_d), rtol=LOSS_RTOL, atol=1e-12)
        held_losses(got["frags"], ref_frags)
    held_losses(got["stats"], one["stats"])
    held_state(got["gen"], one["gen"], what="one process: gen.")
    held_state(got["disc"], one["disc"], what="one process: disc.")
    _, kw, _ = cases[key]
    held_state(got["gen"], _state_np(_port_gen(_np(new["params_generator"]), SMALL)),
               what="JAX mesh: gen.")
    held_state(got["disc"], _state_np(_port_disc(_np(new["params_discriminator"]),
                                                 TINY_DISC)), what="JAX mesh: disc.")
    if key == "course":
        assert got["d"] != 0.0
    else:
        assert "wave_l1_loss" in got["frags"]


def test_course_step_scales_the_batch(cases, ranks):
    """A 16-row batch, 8 rows a rank, as JAX's ``test_dp_scales_batch``."""
    got = _same_on_both(ranks, "rows16")
    assert np.isfinite(got["g"]) and np.isfinite(got["d"])
    one = _here(cases, "rows16")
    np.testing.assert_allclose(got["g"], one["g"], rtol=LOSS_RTOL)
    held_state(got["gen"], one["gen"])


def test_codec_stage1_over_two_ranks(cases, ranks):
    """The EMA codebooks take the whole batch's counts and sums, perplexity
    its histogram: the one-process step and the JAX step on a 2-device
    mesh."""
    got = _same_on_both(ranks, "stage1")
    for k in got["vq"]:
        np.testing.assert_array_equal(got["vq"][k], ranks[1]["stage1"]["vq"][k])
    one = _here(cases, "stage1")
    _, kw, (gen, disc) = cases["stage1"]
    gen = _seeded(gen, (kw["gen_params"], kw["vq"]))
    jtr = jae.Trainer(0, 0, {"train": []}, gen, _seeded(disc, kw["disc_params"]), AE_CONFIG,
                      key=jax.random.PRNGKey(0))
    new, jfr, jppl = _on_mesh(jtr._steps_fns["gen_stage1"],
                              jax.tree_util.tree_map(jnp.array, jtr.state), kw["x"])
    for ref_frags, ref_ppl, ref_vq in ((one["frags"], one["ppl"], one["vq"]),
                                       (jfr, jppl, _np(new["vq_state"])._asdict())):
        held_losses(got["frags"], ref_frags)
        np.testing.assert_allclose(got["ppl"], np.asarray(ref_ppl), rtol=RTOL)
        for k in ref_vq:
            np.testing.assert_allclose(got["vq"][k], np.asarray(ref_vq[k]), atol=VQ_ATOL,
                                       err_msg=k)
    assert not np.array_equal(got["vq"]["embed"], kw["vq"].embed)
    held_state(got["gen"], one["gen"])
    held_state(got["gen"], _state_np(_port_gen(_np(new["params_generator"]), TINY_GEN, True)))


def _seeded(model, params):
    model.init = lambda key: params
    return model


def test_vocoder_spectral_convergence_over_two_ranks(cases, ranks):
    """The vocoder workload's generator step: spectral convergence's norms
    over both ranks' rows, the one-process step and the JAX step on a
    2-device mesh."""
    got = _same_on_both(ranks, "vocoder")
    assert "spectral_convergence_loss" in got["frags"]
    one = _here(cases, "vocoder")
    _, kw, (analyzer, voc, disc) = cases["vocoder"]
    jtr = jvoc.Trainer(0, 0, {"train": []}, analyzer, kw["an_params"],
                       jax.tree_util.tree_map(jnp.asarray, kw["vq"]),
                       _seeded(voc, kw["voc_params"]), _seeded(disc, kw["disc_params"]),
                       VOC_CONFIG, key=jax.random.PRNGKey(0))
    new, jfr = _on_mesh(jtr._steps_fns["gen"], jax.tree_util.tree_map(jnp.array, jtr.state),
                        kw["x"])
    held_losses(got["frags"], one["frags"])
    held_losses(got["frags"], jfr)
    ref = vocoder_from_jax_params(HiFiGANGenerator(**VOC, device="cpu"),
                                  _np(new["params_generator"]))
    for ref_state in (one["voc"], _state_np(ref)):
        held_by_gradient(got["voc"], ref_state, got["grads"], PARAM_ATOL)



def test_statistic_sums_over_two_ranks(cases, ranks):
    """The clips dealt out over two ranks, the sums and the row count
    reduced: every rank holds the whole corpus's statistics."""
    got = ranks[0]["statistic"]
    np.testing.assert_array_equal(got, ranks[1]["statistic"])
    _, kw, gen = cases["statistic"]
    np.testing.assert_allclose(got, _here(cases, "statistic"), rtol=RTOL, atol=1e-7)
    ref = jstat.compute_statistics(gen, kw["an_params"], kw["vq"], kw["clips"])
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=1e-7)


@pytest.fixture(scope="module")
def one_trainer(cases, tmp_path_factory):
    """The trainer case in one process, its checkpoint under its own
    directory."""
    _, kw, _ = cases["trainer"]
    outdir = str(tmp_path_factory.mktemp("one"))
    return outdir, run_here("ae_trainer", **dict(kw, outdir=outdir))


def test_trainer_from_config_over_two_ranks(ranks, one_trainer):
    """``TrainerGAN`` with ``parallel.data_devices``: two stage-1 steps (EMA
    over the ranks) and a stage-2 and discriminator step take the one-process
    trainer's steps; the averaged running losses are the one-process ones."""
    got = _same_on_both(ranks, "trainer")
    _, one = one_trainer
    assert got["steps"] == one["steps"] == 3
    held_state(got["gen"], one["gen"], what="gen.")
    held_state(got["disc"], one["disc"], what="disc.")
    for k in one["vq"]:
        np.testing.assert_allclose(got["vq"][k], one["vq"][k], atol=VQ_ATOL, err_msg=k)
    assert sorted(got["losses"]) == sorted(one["losses"])
    for k in one["losses"]:
        np.testing.assert_allclose(got["losses"][k], one["losses"][k], rtol=LOSS_RTOL,
                                   atol=1e-7, err_msg=k)
    assert all(r["trainer"]["loader_wait"] >= 0.0 for r in ranks)


def test_two_rank_checkpoint_resumes_in_one_process(cases, ranks, one_trainer):
    """Rank 0 wrote the two-rank run's checkpoint: the one-process layout
    (the same keys and shapes, no wrapper prefix), and a one-process trainer
    resumes from it."""
    from dl_speech_enhancement_tpu_torch.train.checkpoint import load_checkpoint

    _, kw, _ = cases["trainer"]
    path = f"{kw['outdir']}/checkpoint-3steps"
    stored = load_checkpoint(path)
    ref = load_checkpoint(f"{one_trainer[0]}/checkpoint-3steps")
    assert sorted(stored) == sorted(ref)
    for key in ("params_generator", "params_discriminator"):
        assert sorted(stored[key]) == sorted(ref[key])
        assert not any(k.startswith("module.") for k in stored[key])
        for k, v in ref[key].items():
            assert stored[key][k].shape == v.shape, k
    tr = autoencoder.Trainer(
        0, 0, {"train": []}, _port_gen(kw["gen_params"], TINY_GEN, True),
        _port_disc(kw["disc_params"], CLI_DISC), kw["config"], vq_state=vq_state_from_jax(kw["vq"]))
    tr.load_checkpoint(path)
    assert tr.steps == 3
    held_state(_state_np(tr.gen), ranks[0]["trainer"]["gen"], atol=0.0)
    np.testing.assert_array_equal(tr.vq_state.embed.numpy(), ranks[0]["trainer"]["vq"]["embed"])


def test_trainer_rejects_a_batch_the_ranks_do_not_divide(ranks):
    for r in ranks:
        assert "not divisible by parallel.data_devices=2" in r["indivisible"]
