"""The port's training losses and criterion against the JAX package.

Each loss gets the same numpy inputs on both sides; values are held to rtol
1e-5 and gradients (with respect to the prediction) to 1e-5 of the largest
gradient, f32 on the CPU with the sums taken in other orders. The spectral
losses run on the ``'eager'`` (FFT) route and on the ``'plain'`` route (the
K6/K7 kernels' plain DFT versions), both against the JAX ``'xla'`` route;
the DFT route differs from an FFT by rounding only. The one exception is the
STFT loss's log-magnitude gradient, held to 2e-3 of its largest value: it
divides by |X|^2, so bins near the clamp magnify the two FFTs' rounding
(measured 9.3e-4 on the FFT route, 1.5e-4 on the DFT route).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dl_speech_enhancement_tpu import losses as jl
from dl_speech_enhancement_tpu.train import criterion as jcrit
from dl_speech_enhancement_tpu_torch import losses as tl
from dl_speech_enhancement_tpu_torch.losses.stft_loss import STFTLoss
from dl_speech_enhancement_tpu_torch.train import criterion as tcrit
from torch_port_threads import one_thread  # noqa: F401

RTOL = 1e-5
GRAD_RTOL = 1e-5
LOG_MAG_GRAD_RTOL = 2e-3

MEL_PARAMS = dict(fs=48000, fft_sizes=[512, 256], hop_sizes=[120, 60],
                  win_lengths=[None, 200], num_mels=40, fmin=0, fmax=24000, log_base=None)
STFT_PARAMS = dict(fft_sizes=[512, 256, 128], hop_sizes=[120, 60, 25],
                   win_lengths=[300, 240, 100])


def _value_and_grad(jax_fn, torch_fn, y_hat, y):
    """(port value, port grad, JAX value, JAX grad) of a scalar loss in its
    first argument."""
    jv, jg = jax.value_and_grad(jax_fn)(jnp.asarray(y_hat), jnp.asarray(y))
    yt = torch.from_numpy(y_hat).requires_grad_()
    tv = torch_fn(yt, torch.from_numpy(y))
    tv.backward()
    return tv.item(), yt.grad.numpy(), float(jv), np.asarray(jg)


def _held(tv, tg, jv, jg, rtol=RTOL, grad_rtol=GRAD_RTOL):
    np.testing.assert_allclose(tv, jv, rtol=rtol)
    assert np.abs(tg - jg).max() <= grad_rtol * np.abs(jg).max()


def _pair(rng, shape):
    return (rng.standard_normal(shape).astype(np.float32) * 0.3,
            rng.standard_normal(shape).astype(np.float32) * 0.3)


@pytest.mark.parametrize("backend", ["eager", "plain"])
def test_multi_mel_loss(rng, backend):
    y_hat, y = _pair(rng, (2, 2400, 1))
    ref = jl.MultiMelSpectrogramLoss(**MEL_PARAMS, backend="xla")
    got = tl.MultiMelSpectrogramLoss(**MEL_PARAMS, backend=backend, device="cpu")
    assert [m.backend for m in got.mels] == [backend] * 2
    _held(*_value_and_grad(ref, got, y_hat, y))


@pytest.mark.parametrize("backend", ["eager", "plain"])
def test_multi_resolution_stft_loss(rng, backend):
    y_hat, y = _pair(rng, (2, 2400, 1))
    ref = jl.MultiResolutionSTFTLoss(**STFT_PARAMS, backend="xla")
    got = tl.MultiResolutionSTFTLoss(**STFT_PARAMS, backend=backend, device="cpu")
    for part, grad_rtol in enumerate((GRAD_RTOL, LOG_MAG_GRAD_RTOL)):
        _held(*_value_and_grad(lambda a, b: ref(a, b)[part], lambda a, b: got(a, b)[part],
                               y_hat, y), grad_rtol=grad_rtol)


def test_stft_loss_routes():
    assert STFTLoss(256, 60, 200, device="cpu").backend == "eager"
    with pytest.raises(ValueError, match="'cuda'"):
        STFTLoss(256, 60, 200, backend="cuda", device="cpu")


@pytest.mark.parametrize("name", ["signal_noise_ratio", "scale_invariant_sdr",
                                  "mean_absolute_error"])
def test_metrics(rng, name):
    y_hat, y = _pair(rng, (3, 800, 1))
    y_hat = y + 0.2 * y_hat  # a prediction near its target, as in training
    _held(*_value_and_grad(getattr(jl, name), getattr(tl, name), y_hat, y))


def test_snr_zero_mean(rng):
    y_hat, y = _pair(rng, (2, 500))
    np.testing.assert_allclose(
        tl.signal_noise_ratio(torch.from_numpy(y_hat) + 1.0, torch.from_numpy(y),
                              zero_mean=True).item(),
        float(jl.signal_noise_ratio(jnp.asarray(y_hat) + 1.0, jnp.asarray(y),
                                    zero_mean=True)), rtol=RTOL)


@pytest.mark.parametrize("winlen", [(300, 200, 100), (64,)])
def test_shape_loss(rng, winlen):
    y_hat, y = _pair(rng, (2, 1000, 1))
    _held(*_value_and_grad(jl.MultiWindowShapeLoss(winlen), tl.MultiWindowShapeLoss(winlen),
                           y_hat, y))


def _disc_outputs(rng):
    """Two discriminators' outputs: one a list of per-layer features ending
    in its logits, one bare logits."""
    return [[rng.standard_normal((2, 8, 4)).astype(np.float32),
             rng.standard_normal((2, 5, 1)).astype(np.float32)],
            rng.standard_normal((2, 7, 1)).astype(np.float32)]


def _to(tree, fn):
    return [_to(t, fn) if isinstance(t, list) else fn(t) for t in tree]


def _grad(t):
    """A leaf's gradient, zeros where it took no part (JAX gives zeros)."""
    return np.zeros(t.shape, np.float32) if t.grad is None else t.grad.numpy()


@pytest.mark.parametrize("loss_type", ["mse", "hinge"])
@pytest.mark.parametrize("average", [True, False])
def test_adversarial_losses(rng, loss_type, average):
    outs_hat, outs = _disc_outputs(rng), _disc_outputs(rng)
    jgen = jl.GeneratorAdversarialLoss(average, loss_type)
    tgen = tl.GeneratorAdversarialLoss(average, loss_type)
    jv, jg = jax.value_and_grad(jgen)(_to(outs_hat, jnp.asarray))
    leaves = _to(outs_hat, lambda a: torch.from_numpy(a).requires_grad_())
    tv = tgen(leaves)
    tv.backward()
    np.testing.assert_allclose(tv.item(), float(jv), rtol=RTOL)
    for a, b in zip(jax.tree_util.tree_leaves(jg), jax.tree_util.tree_leaves(
            _to(leaves, _grad))):
        np.testing.assert_allclose(b, np.asarray(a), rtol=RTOL, atol=1e-8)
    jr, jf = jl.DiscriminatorAdversarialLoss(average, loss_type)(
        _to(outs_hat, jnp.asarray), _to(outs, jnp.asarray))
    tr, tf = tl.DiscriminatorAdversarialLoss(average, loss_type)(
        _to(outs_hat, torch.from_numpy), _to(outs, torch.from_numpy))
    np.testing.assert_allclose([tr.item(), tf.item()], [float(jr), float(jf)], rtol=RTOL)
    single = tgen(torch.from_numpy(outs[1]))  # bare logits, no list
    np.testing.assert_allclose(single.item(), float(jgen(jnp.asarray(outs[1]))), rtol=RTOL)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(average_by_layers=False, average_by_discriminators=False),
    dict(include_final_outputs=True),
])
def test_feature_matching_loss(rng, kw):
    feats_hat = [_disc_outputs(rng)[0], _disc_outputs(rng)[0]]
    feats = [_disc_outputs(rng)[0], _disc_outputs(rng)[0]]
    jv, jg = jax.value_and_grad(jl.FeatureMatchLoss(**kw), argnums=(0, 1))(
        _to(feats_hat, jnp.asarray), _to(feats, jnp.asarray))
    th = _to(feats_hat, lambda a: torch.from_numpy(a).requires_grad_())
    tt = _to(feats, lambda a: torch.from_numpy(a).requires_grad_())
    tv = tl.FeatureMatchLoss(**kw)(th, tt)
    tv.backward()
    np.testing.assert_allclose(tv.item(), float(jv), rtol=RTOL)
    for a, b in zip(jax.tree_util.tree_leaves(jg[0]), jax.tree_util.tree_leaves(
            _to(th, _grad))):
        np.testing.assert_allclose(b, np.asarray(a), rtol=RTOL, atol=1e-9)
    # the targets are detached, as stop_gradient leaves them in JAX
    assert all(t.grad is None for t in jax.tree_util.tree_leaves(tt))
    assert all(not np.asarray(g).any() for g in jax.tree_util.tree_leaves(jg[1]))


CRIT_CONFIG = dict(
    use_mel_loss=True, mel_loss_params=MEL_PARAMS, lambda_mel_loss=45.0,
    use_stft_loss=True, stft_loss_params=STFT_PARAMS, lambda_stft_loss=45.0,
    use_shape_loss=True, shape_loss_params={"winlen": [300]}, lambda_shape_loss=45.0,
    generator_adv_loss_params={"average_by_discriminators": False},
    discriminator_adv_loss_params={"average_by_discriminators": False},
    feat_match_loss_params={"average_by_discriminators": False, "average_by_layers": False,
                            "include_final_outputs": False},
    lambda_adv=1.0, lambda_feat_match=2.0,
)


def test_criterion_metric_loss(rng):
    """metric_loss with every metric loss on, values and gradients; each
    fragment too."""
    y_hat, y = _pair(rng, (2, 2400, 1))
    jc = jcrit.build_criterion(dict(CRIT_CONFIG, mel_loss_params=dict(MEL_PARAMS, backend="xla"),
                                    stft_loss_params=dict(STFT_PARAMS, backend="xla")))
    tc = tcrit.build_criterion(CRIT_CONFIG, device="cpu")
    assert sorted(tc) == sorted(jc)
    jt, jfr = jcrit.metric_loss(jc, CRIT_CONFIG, jnp.asarray(y_hat), jnp.asarray(y))
    tt, tfr = tcrit.metric_loss(tc, CRIT_CONFIG, torch.from_numpy(y_hat), torch.from_numpy(y))
    assert sorted(tfr) == sorted(jfr)
    for k in jfr:
        np.testing.assert_allclose(tfr[k].item(), float(jfr[k]), rtol=RTOL)
    _held(*_value_and_grad(lambda a, b: jcrit.metric_loss(jc, CRIT_CONFIG, a, b)[0],
                           lambda a, b: tcrit.metric_loss(tc, CRIT_CONFIG, a, b)[0], y_hat, y),
          grad_rtol=LOG_MAG_GRAD_RTOL)  # the total holds the log-magnitude term


def test_criterion_adversarial_parts(rng):
    jc = jcrit.build_criterion(CRIT_CONFIG | {"use_mel_loss": False, "use_stft_loss": False})
    tc = tcrit.build_criterion(CRIT_CONFIG | {"use_mel_loss": False, "use_stft_loss": False},
                               device="cpu")
    p_hat, p = _disc_outputs(rng), _disc_outputs(rng)
    for natural in (True, False):
        jv, jfr = jcrit.adv_loss(jc, CRIT_CONFIG, _to(p_hat, jnp.asarray),
                                 _to(p, jnp.asarray) if natural else None)
        tv, tfr = tcrit.adv_loss(tc, CRIT_CONFIG, _to(p_hat, torch.from_numpy),
                                 _to(p, torch.from_numpy) if natural else None)
        assert sorted(tfr) == sorted(jfr)
        for k in jfr:
            np.testing.assert_allclose(tfr[k].item(), float(jfr[k]), rtol=RTOL)
        np.testing.assert_allclose(tv.item(), float(jv), rtol=RTOL)
    jv, jfr = jcrit.dis_loss(jc, CRIT_CONFIG, _to(p_hat, jnp.asarray), _to(p, jnp.asarray))
    tv, tfr = tcrit.dis_loss(tc, CRIT_CONFIG, _to(p_hat, torch.from_numpy),
                             _to(p, torch.from_numpy))
    np.testing.assert_allclose([tv.item(), tfr["real_loss"].item(), tfr["fake_loss"].item()],
                               [float(jv), float(jfr["real_loss"]), float(jfr["fake_loss"])],
                               rtol=RTOL)
