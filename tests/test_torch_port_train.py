"""The port's course trainer (generator phase), optimizer and mixing against
the JAX package.

The generators are the small topology of tests/test_train.py, the JAX params
carried into the port by ``from_jax_params``; batches come from numpy.
Tolerances (f32 on the CPU, the same math summed in other orders): loss
fragments rtol 1e-5, gradient statistics rtol 1e-4; parameters after an
update atol 1e-6 where the gradient is above 1e-4 of its tensor's largest,
and within 2 lr everywhere (Adam's first step is about lr * g / (|g| + eps),
so a gradient near 0 may take either sign in the two packages); the course
loop's history rtol 1e-4 over two epochs of three steps; optimizer states
after 5 updates atol 1e-6.
"""

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch

from dl_speech_enhancement_tpu.data import mixing as jmix
from dl_speech_enhancement_tpu.models import (
    AudioDecGenerator as JaxGenerator,
    HiFiGANDiscriminator as JaxDiscriminator,
)
from dl_speech_enhancement_tpu.train import optim as joptim
from dl_speech_enhancement_tpu.train.denoise_course import (
    make_course_steps as jax_course_steps,
    train_denoise_course as jax_course,
)
from dl_speech_enhancement_tpu_torch.data import mixing
from dl_speech_enhancement_tpu_torch.models import AudioDecGenerator
from dl_speech_enhancement_tpu_torch.train import optim
from dl_speech_enhancement_tpu_torch.train.denoise_course import (
    make_course_steps,
    train_denoise_course,
)
from dl_speech_enhancement_tpu_torch.utils.jax_params import from_jax_params
from torch_port_ranks import run_here, run_ranks
from torch_port_threads import one_thread  # noqa: F401

SMALL = dict(encode_channels=8, decode_channels=8, code_dim=16, codebook_num=2,
             codebook_size=32, enc_ratios=(2, 4), dec_ratios=(4, 2),
             enc_strides=(3, 4), dec_strides=(4, 3))
TINY_DISC = dict(  # tests/test_train.py's, never enabled here
    scales=2,
    scale_discriminator_params={"kernel_sizes": [15, 41, 5, 3], "channels": 8,
                                "max_downsample_channels": 32, "max_groups": 4,
                                "downsample_scales": [2, 2, 1]},
    periods=(2, 3),
    period_discriminator_params={"kernel_sizes": [5, 3], "channels": 4,
                                 "downsample_scales": [3, 3, 1],
                                 "max_downsample_channels": 16},
)
MEL_TINY = dict(fs=4800, fft_sizes=[256], hop_sizes=[60], win_lengths=[256],
                num_mels=20, fmin=0, fmax=2400, log_base=None)
LR = 1e-3
FRAG_RTOL = 1e-5
STATS_RTOL = 1e-4
PARAM_ATOL = 1e-6


def _generators(seed=0):
    jgen = JaxGenerator(use_pqc=False, **SMALL)
    params, _ = jgen.init(jax.random.PRNGKey(seed))
    params = jax.tree_util.tree_map(np.asarray, params)
    return jgen, params, _port(params)


def _port(params):
    return from_jax_params(AudioDecGenerator(use_pqc=False, device="cpu", **SMALL), params)


def _batch(rng, b=4, t=240):
    return (rng.standard_normal((b, t, 1)).astype(np.float32) * 0.3,
            rng.standard_normal((b, t, 1)).astype(np.float32) * 0.3)


@pytest.mark.parametrize("grad_accum,wave_l1,clip", [(1, 0.0, -1.0), (2, 100.0, 0.5)],
                         ids=["plain", "accum2-wave_l1-clip"])
def test_course_step_matches_jax(rng, grad_accum, wave_l1, clip):
    jgen, params, tgen = _generators()
    cfg = dict(mel_loss_params=MEL_TINY, lambda_mel_loss=45.0, lambda_snr_loss=1.0,
               lambda_wave_l1=wave_l1, grad_accum=grad_accum, generator_grad_norm=clip)
    opt_params = {"lr": LR, "betas": [0.5, 0.9]}
    jopt = joptim.build_optimizer("Adam", opt_params, grad_norm=clip)
    state = {"params_generator": params, "opt_generator": jopt.init(params)}
    step = jax_course_steps(jgen, None, cfg, jopt, jopt)["train"]
    x, t = _batch(rng)
    new_state, jg, _, jfr, jst = step(state, jnp.asarray(x), jnp.asarray(t))

    topt = optim.build_optimizer(tgen.parameters(), "Adam", opt_params, grad_norm=clip)
    tg, td, tfr, tst = make_course_steps(tgen, None, cfg, topt, None)["train"](
        torch.from_numpy(x), torch.from_numpy(t))
    assert sorted(tfr) == sorted(jfr) and ("wave_l1_loss" in tfr) == (wave_l1 > 0)
    np.testing.assert_allclose(tg.item(), float(jg), rtol=FRAG_RTOL)
    assert td.item() == 0.0
    for k in jfr:
        np.testing.assert_allclose(tfr[k].item(), float(jfr[k]), rtol=FRAG_RTOL)
    for k in jst:
        np.testing.assert_allclose(tst[k].item(), float(jst[k]), rtol=STATS_RTOL)

    ref = _port(jax.tree_util.tree_map(np.asarray, new_state["params_generator"]))
    got = dict(tgen.named_parameters())
    for name, p_ref in ref.named_parameters():
        p, g = got[name].detach(), got[name].grad.abs()
        diff = (p - p_ref.detach()).abs()
        assert diff.max() <= 2 * LR, name
        big = g > 1e-4 * g.max()
        assert diff[big].max() <= PARAM_ATOL, name


def test_course_step_rejects_indivisible_batch(rng):
    _, _, tgen = _generators()
    cfg = dict(mel_loss_params=MEL_TINY, lambda_mel_loss=45.0, grad_accum=3)
    topt = optim.build_optimizer(tgen.parameters(), "Adam", {"lr": LR})
    x, t = _batch(rng)
    with pytest.raises(ValueError, match="not divisible"):
        make_course_steps(tgen, None, cfg, topt, None)["train"](torch.from_numpy(x),
                                                                torch.from_numpy(t))


def test_course_eval_matches_jax(rng):
    jgen, params, tgen = _generators(seed=1)
    cfg = dict(mel_loss_params=MEL_TINY, lambda_mel_loss=45.0, lambda_snr_loss=1.0)
    jopt = joptim.build_optimizer("Adam", {"lr": LR})
    x, t = _batch(rng)
    jg, _, jfr = jax_course_steps(jgen, None, cfg, jopt, jopt)["eval"](
        {"params_generator": params}, jnp.asarray(x), jnp.asarray(t))
    steps = make_course_steps(tgen, None, cfg, None, None)
    tg, _, tfr = steps["eval"](torch.from_numpy(x), torch.from_numpy(t))
    np.testing.assert_allclose(tg.item(), float(jg), rtol=FRAG_RTOL)
    for k in jfr:
        np.testing.assert_allclose(tfr[k].item(), float(jfr[k]), rtol=FRAG_RTOL)
    for arm in ("train_disc", "eval_disc"):
        with pytest.raises(ValueError, match="needs a discriminator"):
            steps[arm](torch.from_numpy(x), torch.from_numpy(t))


def _sine_batch(rng, b=2, t=240):
    ph = rng.uniform(0, np.pi, (b, 1, 1))
    tt = np.arange(t)[None, :, None] / 48.0
    return (np.sin(2 * np.pi * tt + ph) * 0.5).astype(np.float32)


COURSE_CONFIG = dict(
    sample_rate=4800, epochs=2, epoch_to_enable_discriminator=2,
    noise_dropout_rate=0.5, noise_dropout_rate_decay=0.1,
    epoch_to_enable_noise_dropout_decay=0, seed=0, step=0,
    mel_loss_params=MEL_TINY, lambda_mel_loss=45.0, lambda_snr_loss=1.0,
    lambda_wave_l1=100.0, lambda_adv=1.0, lambda_feat_match=2.0,
    generator_adv_loss_params={"average_by_discriminators": False},
    discriminator_adv_loss_params={"average_by_discriminators": False},
    generator_optimizer_params={"lr": LR, "betas": [0.5, 0.9]},
    discriminator_optimizer_params={"lr": LR, "betas": [0.5, 0.9]},
    generator_grad_norm=-1, discriminator_grad_norm=-1, batch_size=2,
)


def test_course_loop_matches_jax(rng, tmp_path):
    """Two LAPTOP epochs of three steps from the same params and mix seed:
    the JAX loop with a tiny discriminator it never enables, the port's with
    none."""
    jgen, params, tgen = _generators(seed=2)
    clean = [_sine_batch(rng) for _ in range(4)]
    noise = [0.3 * rng.standard_normal((2, 240, 1)).astype(np.float32) for _ in range(4)]
    loaders = ((clean, noise), (clean[:2], noise[:2]))
    _, jhist = jax_course(COURSE_CONFIG, jgen, JaxDiscriminator(**TINY_DISC), *loaders,
                          environment="LAPTOP", job_dir=str(tmp_path),
                          key=jax.random.PRNGKey(0), initial_params=params)
    reports = []
    state, thist = train_denoise_course(COURSE_CONFIG, tgen, None, *loaders,
                                        environment="LAPTOP",
                                        report=lambda *a: reports.append(a))
    assert state["steps"] == 6 and state["generator"] is tgen
    assert len(thist) == len(jhist) == 2
    for t_ep, j_ep in zip(thist, jhist):
        for key in ("train_gen", "val_gen"):
            np.testing.assert_allclose(t_ep[key], j_ep[key], rtol=1e-4)
        assert t_ep["train_dis"] == t_ep["val_dis"] == 0.0
        assert sorted(t_ep["frags"]) == sorted(j_ep["frags"])
        for k in j_ep["frags"]:
            np.testing.assert_allclose(t_ep["frags"][k], j_ep["frags"][k], rtol=1e-4)
    assert any(r[0] == "Gradients" for r in reports)


def test_course_loop_data_parallel_equals_one_process(rng, tmp_path):
    """``parallel.data_devices: 2`` on two gloo ranks on the host: every
    rank mixes the whole batch from the same ``mix_rng`` (noise dropout and
    its decay included) and trains on its rows, the discriminator from
    epoch 1, as JAX's ``test_course_loop_dp_from_config``
    (tests/test_parallel.py:485). The history equals the one-process loop's
    on both ranks (losses rtol 2e-4, JAX's DP tolerance), and so do the
    generator's parameters (atol 5e-5)."""
    from test_torch_port_discriminator import disc_params  # it imports this module

    jgen, params, _ = _generators(seed=3)
    disc = disc_params(JaxDiscriminator(**TINY_DISC), 4)
    clean = [_sine_batch(rng, b=4) for _ in range(2)]
    noise = [0.3 * rng.standard_normal((4, 240, 1)).astype(np.float32) for _ in range(2)]
    config = dict(COURSE_CONFIG, epoch_to_enable_discriminator=1, batch_size=4)
    kw = {"gen_kw": SMALL, "gen_params": params, "disc_kw": TINY_DISC, "disc_params": disc,
          "train": (clean, noise), "val": (clean[:1], noise[:1])}
    one = run_here("course_loop", **kw, config=config)
    ranks = run_ranks(2, {"loop": ("course_loop", dict(
        kw, config=dict(config, parallel={"data_devices": 2})))}, tmp_path)
    for got in (r["loop"] for r in ranks):
        assert got["steps"] == one["steps"] == 4
        assert got["history"][1]["train_dis"] != 0.0
        for g_ep, o_ep in zip(got["history"], one["history"]):
            for key in ("train_gen", "train_dis", "val_gen", "val_dis"):
                np.testing.assert_allclose(g_ep[key], o_ep[key], rtol=2e-4, atol=1e-12,
                                           err_msg=key)
            for k in o_ep["frags"]:
                np.testing.assert_allclose(g_ep["frags"][k], o_ep["frags"][k], rtol=2e-4,
                                           err_msg=k)
        for k in one["gen"]:
            np.testing.assert_allclose(got["gen"][k], one["gen"][k], atol=5e-5, rtol=0,
                                       err_msg=k)


def _optax_and_port(grad_norm, weight_decay, sched_type=None, sched_params=None):
    opt_params = {"lr": 1e-2, "betas": [0.5, 0.9], "weight_decay": weight_decay}
    jopt = joptim.build_optimizer("Adam", opt_params, sched_type, sched_params, grad_norm)
    return jopt, opt_params


@pytest.mark.parametrize("grad_norm,weight_decay", [(-1, 0.0), (1.0, 0.0), (1.0, 0.01),
                                                    (100.0, 0.01)],
                         ids=["adam", "clip", "clip-wd", "no-clip-wd"])
def test_optimizer_matches_optax(rng, grad_norm, weight_decay):
    """5 updates of Adam with optax's clip and coupled weight decay."""
    init = [rng.standard_normal((3, 4)).astype(np.float32),
            rng.standard_normal(5).astype(np.float32)]
    grads = [[rng.standard_normal(p.shape).astype(np.float32) for p in init]
             for _ in range(5)]
    jopt, opt_params = _optax_and_port(grad_norm, weight_decay)
    jp = [jnp.asarray(p) for p in init]
    js = jopt.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in init]
    topt = optim.build_optimizer(tp, "Adam", opt_params, grad_norm=grad_norm)
    for g in grads:
        upd, js = jopt.update([jnp.asarray(a) for a in g], js, jp)
        jp = optax.apply_updates(jp, upd)
        topt.zero_grad()
        for p, a in zip(tp, g):
            p.grad = torch.from_numpy(a.copy())
        topt.step()
        for p, q in zip(tp, jp):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(q), atol=PARAM_ATOL)


def test_clip_is_optax_formula():
    """At the norm's edge the clip is g * max / norm (no + 1e-6)."""
    g = [torch.tensor([3.0, 4.0])]
    norm = optim.clip_by_global_norm(g, 2.5)
    assert norm.item() == 5.0
    assert torch.equal(g[0], torch.tensor([3.0, 4.0]) / 5.0 * 2.5)
    g = [torch.tensor([3.0, 4.0])]
    optim.clip_by_global_norm(g, 5.0)  # norm == max_norm: clipped, by a factor of 1
    assert torch.equal(g[0], torch.tensor([3.0, 4.0]) / 5.0 * 5.0)


@pytest.mark.parametrize("sched_type,sched_params", [
    ("StepLR", {"step_size": 3, "gamma": 0.5}),
    ("MultiStepLR", {"milestones": [2, 5], "gamma": 0.1}),
    ("StepLR", {"step_size": 200000, "gamma": 1.0}),
    (None, None),
])
def test_schedules_match_optax(sched_type, sched_params):
    """The learning rate at each update count, across the milestones."""
    schedule = joptim.build_schedule(1e-2, sched_type, sched_params)
    p = torch.nn.Parameter(torch.zeros(2))
    topt = optim.build_optimizer([p], "Adam", {"lr": 1e-2}, sched_type, sched_params)
    for count in range(8):
        want = schedule(count) if callable(schedule) else schedule
        np.testing.assert_allclose(topt.lr, float(want), rtol=1e-6, err_msg=f"count {count}")
        p.grad = torch.ones(2)
        topt.step()


def test_optimizer_from_config_and_freeze(rng):
    """build_optimizer_from_config reads the reference keys; a frozen
    top-level submodule takes no step and leaves the clip's norm alone."""
    cfg = {"generator_optimizer_type": "Adam",
           "generator_optimizer_params": {"lr": 1e-2, "betas": [0.5, 0.9]},
           "generator_scheduler_type": "MultiStepLR",
           "generator_scheduler_params": {"milestones": [1], "gamma": 0.5},
           "generator_grad_norm": 0.1}
    net = torch.nn.ModuleDict({"encoder": torch.nn.Linear(3, 2), "decoder": torch.nn.Linear(2, 3)})
    topt = optim.build_optimizer_from_config(cfg, "generator", net.parameters())
    assert topt.grad_norm == 0.1 and topt.lr == 1e-2
    before = {k: v.detach().clone() for k, v in net.state_dict().items()}
    x = torch.from_numpy(rng.standard_normal((4, 3)).astype(np.float32))
    with optim.frozen(optim.frozen_params(net, ["encoder"])):
        net["decoder"](net["encoder"](x)).square().sum().backward()
    assert all(p.grad is None for p in net["encoder"].parameters())
    assert all(p.requires_grad for p in net.parameters())
    trainable = [p.grad.clone() for p in net["decoder"].parameters()]
    topt.step()
    after = net.state_dict()
    for k in before:
        assert torch.equal(after[k], before[k]) == k.startswith("encoder"), k
    # the trainable part took optax's step on its own clipped gradients
    jopt = joptim.build_optimizer_from_config(cfg, "generator")
    jp = [jnp.asarray(before[k].numpy()) for k in ("decoder.weight", "decoder.bias")]
    upd, _ = jopt.update([jnp.asarray(g.numpy()) for g in trainable], jopt.init(jp), jp)
    for k, q in zip(("decoder.weight", "decoder.bias"), optax.apply_updates(jp, upd)):
        np.testing.assert_allclose(after[k].numpy(), np.asarray(q), atol=PARAM_ATOL)
    assert topt.lr == 5e-3  # MultiStepLR's milestone at update 1


@pytest.mark.parametrize("mode", ["reference", "db"])
def test_add_noise_matches_jax(rng, mode):
    speech, noise = _batch(rng, b=3, t=500)
    np.testing.assert_array_equal(mixing.add_noise(speech, noise, 13, mode),
                                  jmix.add_noise(speech, noise, 13, mode))
    with pytest.raises(ValueError):
        mixing.add_noise(speech, noise[:2], 13)


def test_noise_dropout_matches_jax(rng):
    clean, noise = _batch(rng, b=8, t=50)
    for rate in (0.0, 0.5, 1.0):
        got = mixing.noise_dropout(clean, noise, rate, np.random.default_rng(3))
        ref = jmix.noise_dropout(clean, noise, rate, np.random.default_rng(3))
        np.testing.assert_array_equal(got, ref)
