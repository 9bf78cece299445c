"""The port's course trainer in its adversarial phase against the JAX package
(CPU, f32), and its per-epoch checkpoints.

The generator is tests/test_train.py's small topology and the discriminator
its ``TINY_DISC``; JAX params are carried into the port by
``from_jax_params`` / ``discriminator_from_jax_params`` (the discriminator's
drawn by tests/test_torch_port_discriminator.py's ``disc_params``), batches
come from numpy. Tolerances, as tests/test_torch_port_train.py holds the
generator phase: loss fragments rtol 1e-5; parameters after an update atol
1e-6 where the gradient is above 1e-4 of its tensor's largest, and within 2
lr everywhere (Adam's first step is about lr * g / (|g| + eps)), for both
networks; the loop's history rtol 1e-4. Remat against plain, as
tests/test_train.py holds it: losses rtol 1e-6, parameters rtol 1e-5 (atol
1e-7). bf16 discriminator: the mel fragment rtol 1e-5 and ``g_loss`` rtol
0.1 against f32 (tests/test_train.py's bounds), the losses within 5e-2 of
JAX's bf16 step.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dl_speech_enhancement_tpu.models import HiFiGANDiscriminator as JaxDiscriminator
from dl_speech_enhancement_tpu.train import optim as joptim
from dl_speech_enhancement_tpu.train.denoise_course import (
    make_course_steps as jax_course_steps,
    train_denoise_course as jax_course,
)
from dl_speech_enhancement_tpu_torch.models import HiFiGANDiscriminator
from dl_speech_enhancement_tpu_torch.train import optim
from dl_speech_enhancement_tpu_torch.train.checkpoint import load_checkpoint
from dl_speech_enhancement_tpu_torch.train.denoise_course import (
    make_course_steps,
    train_denoise_course,
)
from dl_speech_enhancement_tpu_torch.utils.config import load_config
from dl_speech_enhancement_tpu_torch.utils.jax_params import discriminator_from_jax_params
from test_torch_port_discriminator import disc_params
from test_torch_port_train import (
    COURSE_CONFIG,
    LR,
    MEL_TINY,
    TINY_DISC,
    _batch,
    _generators,
    _port,
    _sine_batch,
)
from torch_port_threads import one_thread  # noqa: F401

FRAG_RTOL = 1e-5
PARAM_ATOL = 1e-6
OPT = {"lr": LR, "betas": [0.5, 0.9]}
ADV = dict(mel_loss_params=MEL_TINY, lambda_mel_loss=45.0, lambda_snr_loss=1.0,
           lambda_adv=1.0, lambda_feat_match=2.0)


def _discriminators(seed=0):
    jd = JaxDiscriminator(**TINY_DISC)
    params = disc_params(jd, seed)
    return jd, params, _port_disc(params)


def _port_disc(params):
    return discriminator_from_jax_params(HiFiGANDiscriminator(**TINY_DISC, device="cpu"),
                                         params)


def _jax_state(jopt, params, pd):
    return {"params_generator": params, "opt_generator": jopt.init(params),
            "params_discriminator": pd, "opt_discriminator": jopt.init(pd)}


def _port_steps(tgen, td, cfg, clip):
    opt_g = optim.build_optimizer(tgen.parameters(), "Adam", OPT, grad_norm=clip)
    opt_d = optim.build_optimizer(td.parameters(), "Adam", OPT, grad_norm=clip)
    return make_course_steps(tgen, td, cfg, opt_g, opt_d)


def _held_params(module, ref):
    """``module``'s parameters after a step against ``ref``'s (the JAX
    step's, carried across), by each parameter's gradient."""
    got = dict(module.named_parameters())
    for name, p_ref in ref.named_parameters():
        p, g = got[name].detach(), got[name].grad.abs()
        diff = (p - p_ref.detach()).abs()
        assert diff.max() <= 2 * LR, name
        big = g > 1e-4 * g.max()
        assert diff[big].max() <= PARAM_ATOL, name


def _held_frags(tfr, jfr, rtol=FRAG_RTOL):
    assert sorted(tfr) == sorted(jfr)
    for k in jfr:
        np.testing.assert_allclose(tfr[k].item(), float(jfr[k]), rtol=rtol, err_msg=k)


def _jax_step(cfg, clip, params, pd, x, t):
    jgen, _, _ = _generators()
    jopt = joptim.build_optimizer("Adam", OPT, grad_norm=clip)
    step = jax_course_steps(jgen, JaxDiscriminator(**TINY_DISC), cfg, jopt, jopt)["train_disc"]
    return step(_jax_state(jopt, params, pd), jnp.asarray(x), jnp.asarray(t))


@pytest.mark.parametrize("grad_accum,clip", [(1, -1.0), (2, 0.5)], ids=["plain", "accum2-clip"])
def test_adversarial_step_matches_jax(rng, grad_accum, clip):
    """``train_disc``: the generator against the old discriminator, then the
    discriminator on the updated generator's re-forwarded output (each
    microbatch under grad_accum), clipped by global norm where asked."""
    _, params, tgen = _generators()
    _, pd, td = _discriminators()
    cfg = dict(ADV, grad_accum=grad_accum, generator_grad_norm=clip,
               discriminator_grad_norm=clip)
    x, t = _batch(rng)
    new_state, jg, jd_loss, jfr, jst = _jax_step(cfg, clip, params, pd, x, t)
    tg, td_loss, tfr, tst = _port_steps(tgen, td, cfg, clip)["train_disc"](
        torch.from_numpy(x), torch.from_numpy(t))
    assert {"adv_loss", "feat_loss"} <= set(tfr)
    _held_frags(tfr, jfr)
    np.testing.assert_allclose(tg.item(), float(jg), rtol=FRAG_RTOL)
    np.testing.assert_allclose(td_loss.item(), float(jd_loss), rtol=FRAG_RTOL)
    for k in jst:
        np.testing.assert_allclose(tst[k].item(), float(jst[k]), rtol=1e-4, err_msg=k)
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    _held_params(tgen, _port(to_np(new_state["params_generator"])))
    _held_params(td, _port_disc(to_np(new_state["params_discriminator"])))


def test_adversarial_eval_matches_jax(rng):
    jgen, params, tgen = _generators(seed=1)
    jd, pd, td = _discriminators(seed=1)
    jopt = joptim.build_optimizer("Adam", OPT)
    x, t = _batch(rng)
    jg, jdl, jfr = jax_course_steps(jgen, jd, ADV, jopt, jopt)["eval_disc"](
        {"params_generator": params, "params_discriminator": pd}, jnp.asarray(x),
        jnp.asarray(t))
    tg, tdl, tfr = make_course_steps(tgen, td, ADV, None, None)["eval_disc"](
        torch.from_numpy(x), torch.from_numpy(t))
    _held_frags(tfr, jfr)
    np.testing.assert_allclose(tg.item(), float(jg), rtol=FRAG_RTOL)
    np.testing.assert_allclose(tdl.item(), float(jdl), rtol=FRAG_RTOL)
    assert all(p.grad is None for p in (*tgen.parameters(), *td.parameters()))


def test_compat_adv_on_waveform_matches_jax(rng):
    """``compat_adv_on_waveform``: ``gen_adv`` on ``y`` itself."""
    _, params, tgen = _generators(seed=2)
    _, pd, td = _discriminators(seed=2)
    cfg = dict(ADV, compat_adv_on_waveform=True, discriminator_remat=True)
    x, t = _batch(rng)
    _, jg, jdl, jfr, _ = _jax_step(cfg, -1.0, params, pd, x, t)
    tg, tdl, tfr, _ = _port_steps(tgen, td, cfg, -1.0)["train_disc"](
        torch.from_numpy(x), torch.from_numpy(t))
    _held_frags(tfr, jfr)
    np.testing.assert_allclose(tg.item(), float(jg), rtol=FRAG_RTOL)
    np.testing.assert_allclose(tdl.item(), float(jdl), rtol=FRAG_RTOL)


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_remat_equals_plain(rng, grad_accum):
    """``discriminator_remat`` recomputes each sub-discriminator in the
    backward: the same losses and updated parameters of both networks."""
    _, params, _ = _generators(seed=3)
    _, pd, _ = _discriminators(seed=3)
    x, t = _batch(rng)
    runs = []
    for remat in (False, True):
        tgen, td = _port(params), _port_disc(pd)
        cfg = dict(ADV, discriminator_remat=remat, grad_accum=grad_accum)
        g, d, fr, _ = _port_steps(tgen, td, cfg, 10.0)["train_disc"](torch.from_numpy(x),
                                                                     torch.from_numpy(t))
        runs.append((g.item(), d.item(), {k: v.item() for k, v in fr.items()},
                     [p.detach().clone() for p in (*tgen.parameters(), *td.parameters())]))
    (g0, d0, f0, p0), (g1, d1, f1, p1) = runs
    np.testing.assert_allclose(g1, g0, rtol=1e-6)
    np.testing.assert_allclose(d1, d0, rtol=1e-6)
    for k in f0:
        np.testing.assert_allclose(f1[k], f0[k], rtol=1e-6, err_msg=k)
    for a, b in zip(p0, p1):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5, atol=1e-7)


def test_bf16_discriminator(rng):
    """``discriminator_dtype: bf16``: the mel fragment as f32's (rtol 1e-5),
    ``g_loss`` within 0.1 of f32's, the losses within 5e-2 of JAX's bf16
    step; gradients reach the f32 parameters, which stay f32."""
    _, params, _ = _generators(seed=4)
    _, pd, _ = _discriminators(seed=4)
    x, t = _batch(rng)
    out = {}
    for dtype in ("float32", "bf16"):
        tgen, td = _port(params), _port_disc(pd)
        before = [p.detach().clone() for p in td.parameters()]
        cfg = dict(ADV, discriminator_dtype=dtype)
        out[dtype] = _port_steps(tgen, td, cfg, 10.0)["train_disc"](torch.from_numpy(x),
                                                                    torch.from_numpy(t))
        assert all(p.dtype == torch.float32 for p in td.parameters())
        assert all(not torch.equal(a, p) for a, p in zip(before, td.parameters()))
    g32, d32, f32, _ = out["float32"]
    g16, d16, f16, _ = out["bf16"]
    assert all(torch.isfinite(v) for v in (g16, d16, *f16.values()))
    np.testing.assert_allclose(f16["mel_loss"].item(), f32["mel_loss"].item(), rtol=1e-5)
    np.testing.assert_allclose(g16.item(), g32.item(), rtol=0.1)
    _, jg, jdl, jfr, _ = _jax_step(dict(ADV, discriminator_dtype="bf16"), 10.0, params, pd, x, t)
    np.testing.assert_allclose(g16.item(), float(jg), rtol=5e-2)
    np.testing.assert_allclose(d16.item(), float(jdl), rtol=5e-2)
    for k in jfr:
        np.testing.assert_allclose(f16[k].item(), float(jfr[k]), rtol=5e-2, err_msg=k)


def _loaders(rng):
    clean = [_sine_batch(rng) for _ in range(4)]
    noise = [0.3 * rng.standard_normal((2, 240, 1)).astype(np.float32) for _ in range(4)]
    return (clean, noise), (clean[:2], noise[:2])


def test_course_loop_with_discriminator_matches_jax(rng, tmp_path):
    """Two LAPTOP epochs of three steps, the discriminator enabled at epoch
    1: the JAX loop (its discriminator drawn from the loop's key) against
    the port's with the same params."""
    config = dict(COURSE_CONFIG, epoch_to_enable_discriminator=1)
    jgen, params, tgen = _generators(seed=2)
    jd = JaxDiscriminator(**TINY_DISC)
    loaders = _loaders(rng)
    key = jax.random.PRNGKey(0)
    _, jhist = jax_course(config, jgen, jd, *loaders, environment="LAPTOP",
                          job_dir=str(tmp_path), key=key, initial_params=params)
    pd = jax.tree_util.tree_map(np.asarray, jd.init(jax.random.split(key)[1]))
    reports = []
    state, thist = train_denoise_course(config, tgen, _port_disc(pd), *loaders,
                                        environment="LAPTOP",
                                        report=lambda *a: reports.append(a))
    assert state["steps"] == 6 and state["opt_discriminator"] is not None
    assert len(thist) == len(jhist) == 2
    assert thist[0]["train_dis"] == thist[0]["val_dis"] == 0.0
    assert thist[1]["train_dis"] > 0.0 and np.isfinite(thist[1]["train_dis"])
    for t_ep, j_ep in zip(thist, jhist):
        for key_ in ("train_gen", "val_gen", "train_dis", "val_dis"):
            np.testing.assert_allclose(t_ep[key_], j_ep[key_], rtol=1e-4, err_msg=key_)
        assert sorted(t_ep["frags"]) == sorted(j_ep["frags"])
        for k in j_ep["frags"]:
            np.testing.assert_allclose(t_ep["frags"][k], j_ep["frags"][k], rtol=1e-4)
    assert any(r[:2] == ("Discriminator Loss", "Train") and r[2] > 0 for r in reports)


def test_course_loop_writes_a_checkpoint_every_epoch(rng, tmp_path):
    """Outside LAPTOP mode every epoch writes
    ``{job_dir}/{task_name}checkpoint-{steps}/state.pt`` (the generator's
    state dict) with ``config.yml`` beside it, and takes every batch."""
    config = dict(COURSE_CONFIG, epochs=2, epoch_to_enable_discriminator=1)
    _, _, tgen = _generators(seed=5)
    _, _, td = _discriminators(seed=5)
    loaders = _loaders(rng)
    state, hist = train_denoise_course(config, tgen, td, *loaders, environment="HPC",
                                       job_dir=str(tmp_path), task_name="denoise")
    assert state["steps"] == 8 and len(hist) == 2  # 4 batches an epoch, not LAPTOP's 3
    assert sorted(os.listdir(tmp_path)) == ["config.yml", "denoisecheckpoint-4",
                                            "denoisecheckpoint-8"]
    restored = load_checkpoint(str(tmp_path / "denoisecheckpoint-8"),
                               {"params_generator": tgen.state_dict()})["params_generator"]
    for name, value in tgen.state_dict().items():
        assert torch.equal(restored[name], value), name
    first = load_checkpoint(str(tmp_path / "denoisecheckpoint-4"))["params_generator"]
    assert any(not torch.equal(first[n], v) for n, v in tgen.state_dict().items())
    assert load_config(str(tmp_path / "config.yml"))["epoch_to_enable_discriminator"] == 1


def test_adversarial_arms_need_a_discriminator(rng):
    _, _, tgen = _generators()
    x, t = (torch.from_numpy(a) for a in _batch(rng))
    steps = make_course_steps(tgen, None, ADV, None, None)
    for arm in ("train_disc", "eval_disc"):
        with pytest.raises(ValueError, match="needs a discriminator"):
            steps[arm](x, t)
