"""The port's discriminators (HiFiGAN MPD / MSD, UnivNet MRSD), its 2-D conv,
spectral norm and spectrogram against the JAX package (CPU, f32).

Params are drawn with numpy in the tree of the JAX ``init``
(:func:`disc_params`: every weight-norm ``g`` set to about unit gain, so
unlike ``||v||``, biases drawn larger), carried into the port with
``discriminator_from_jax_params``; inputs are seeded numpy. The port's
features are channels-first (MSD (B, C, T), MPD and MRSD NCHW) and are
transposed to the JAX package's channels-last before comparing.

Tolerances: every feature map within 1e-5 of its largest |value| (f32 convs
summed in another order); where a layer is spectral-normed, 1e-4 relative:
the port's power iteration starts from another vector than JAX's
``PRNGKey(0)`` draw, so the two agree at the converged sigma, which each
holds within 1e-4 of the SVD's at these widths. The spectral-normed layers
of the feature and gradient checks get weights whose largest singular value
stands clear of the next (:func:`spiked`), so that both iterations converge. At the configs' full
widths 100 iterations do not converge that far (the largest singular
values lie within 0.3-0.5 % of each other): there both estimates are held
as lower bounds within 1e-2 of the SVD's (5.2e-3 seen), a limit of the
JAX package's own algorithm (ROADMAP §3). Gradients of a seeded weighted
sum of every feature, with respect to the input and every parameter,
against ``jax.grad``: rtol 1e-4 of each tensor's largest.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dl_speech_enhancement_tpu.dsp.stft import hann_window as jhann, spectrogram as jspectrogram
from dl_speech_enhancement_tpu.models import discriminator as jdisc
from dl_speech_enhancement_tpu.models import (
    HiFiGANDiscriminator as JaxHiFiGANDisc,
    UnivNetDiscriminator as JaxUnivNetDisc,
)
from dl_speech_enhancement_tpu.nn import conv as jconv
from dl_speech_enhancement_tpu_torch.dsp.stft import hann_window, spectrogram
from dl_speech_enhancement_tpu_torch.models import (
    HiFiGANDiscriminator,
    UnivNetDiscriminator,
)
from dl_speech_enhancement_tpu_torch.models import discriminator as tdisc
from dl_speech_enhancement_tpu_torch.nn import conv as tconv
from dl_speech_enhancement_tpu_torch.utils.config import load_config
from dl_speech_enhancement_tpu_torch.utils.jax_params import (
    _load_mpd,
    discriminator_from_jax_params,
    load_conv,
)
from dl_speech_enhancement_tpu_torch.utils.model_factory import build_discriminator
from test_torch_port_hifigan import seeded_init
from test_torch_port_train import TINY_DISC
from torch_port_threads import one_thread  # noqa: F401

FEAT_RTOL = 1e-5
SPECTRAL_RTOL = 1e-4
FULL_WIDTH_SIGMA_RTOL = 1e-2
GRAD_RTOL = 1e-4
TINY_UNIV = dict(
    fft_sizes=(256, 512), hop_sizes=(32, 64), win_lengths=(128, 256),
    spectral_discriminator_params={"channels": 4, "nonlinear_activation": "LeakyReLU",
                                   "nonlinear_activation_params": {"negative_slope": 0.2}},
    periods=(2, 3), period_discriminator_params=TINY_DISC["period_discriminator_params"])
COURSE = "configs/denoise/symAD_48MelWaveL1.yaml"
UNIV = "configs/autoencoder/symADuniv_vctk_48000_hop300.yaml"


def _with_norm(**norm):
    """TINY_DISC with ``norm`` set on both discriminators' layers."""
    return dict(TINY_DISC,
                scale_discriminator_params=dict(TINY_DISC["scale_discriminator_params"], **norm),
                period_discriminator_params=dict(TINY_DISC["period_discriminator_params"],
                                                 **norm))


def disc_params(model, seed):
    """:func:`seeded_init`'s params of the JAX ``model``, each weight-norm
    ``g`` set to U(0.8, 1.25) (about unit gain, unlike ``||v||``) and each
    bias drawn from N(0, 0.1^2), seeded."""
    rng = np.random.default_rng(seed + 1000)

    def walk(p):
        if isinstance(p, list):
            return [walk(q) for q in p]
        if not isinstance(p, dict):
            return p
        out = {k: walk(v) for k, v in p.items()}
        if "g" in p:
            out["g"] = rng.uniform(0.8, 1.25, np.shape(p["g"])).astype(np.float32)
        if "b" in p:
            out["b"] = (0.1 * rng.standard_normal(np.shape(p["b"]))).astype(np.float32)
        return out

    return walk(seeded_init(model, seed))


def spiked(w: np.ndarray, rng) -> np.ndarray:
    """``w`` (JAX layout, out last) plus a rank-one term that makes its
    largest singular value about twice the next, so that 100 power-iteration
    steps converge from any start (near-equal leading singular values do
    not; test_spectral_norm_at_config_widths holds that case)."""
    mat = w.reshape(-1, w.shape[-1]).astype(np.float64)
    a, b = rng.standard_normal(mat.shape[0]), rng.standard_normal(mat.shape[1])
    s1 = np.linalg.svd(mat, compute_uv=False)[0]
    mat = mat + 2.0 * s1 * np.outer(a / np.linalg.norm(a), b / np.linalg.norm(b))
    return mat.reshape(w.shape).astype(np.float32)


def _spike_all(params, seed):
    rng = np.random.default_rng(seed + 2000)

    def walk(p):
        if isinstance(p, list):
            return [walk(q) for q in p]
        if not isinstance(p, dict):
            return p
        out = {k: walk(v) for k, v in p.items()}
        if "w" in p:
            out["w"] = spiked(np.asarray(p["w"]), rng)
        return out

    return walk(params)


def _pair(jcls, tcls, kw, seed=0, spike=False):
    jmodel = jcls(**kw)
    params = disc_params(jmodel, seed)
    if spike:
        params = _spike_all(params, seed)
    return jmodel, params, discriminator_from_jax_params(tcls(**kw, device="cpu"), params)


def _channels_last(t) -> np.ndarray:
    a = t.detach().numpy()
    if a.ndim == 4:
        return a.transpose(0, 2, 3, 1)
    if a.ndim == 3:
        return a.transpose(0, 2, 1)
    return a


def _flat(outs):
    for o in outs:
        yield from (o if isinstance(o, (list, tuple)) else [o])


def assert_features(jouts, touts, rtol=FEAT_RTOL):
    jf, tf = list(_flat(jouts)), list(_flat(touts))
    assert len(jf) == len(tf)
    for i, (a, b) in enumerate(zip(jf, tf)):
        a, b = np.asarray(a), _channels_last(b)
        assert a.shape == b.shape, (i, a.shape, b.shape)
        np.testing.assert_allclose(b, a, rtol=0, atol=rtol * np.abs(a).max(),
                                   err_msg=f"feature {i}")


def _wave(rng, b=2, t=241, c=1):
    return (0.5 * rng.standard_normal((b, t, c))).astype(np.float32)


@pytest.mark.parametrize("norm,rtol", [
    ({}, FEAT_RTOL),
    ({"use_weight_norm": True}, FEAT_RTOL),
    ({"use_spectral_norm": True}, SPECTRAL_RTOL),
], ids=["as-run", "weight-norm", "spectral-norm"])
def test_hifigan_discriminator_matches_jax(rng, norm, rtol):
    """MSD + MPD at T = 241, which no period divides (the MPD's reflect pad),
    with the norms as the reference runs them, weight norm on the MSD too,
    and spectral norm on every layer."""
    jmodel, params, tmodel = _pair(JaxHiFiGANDisc, HiFiGANDiscriminator, _with_norm(**norm),
                                   spike="use_spectral_norm" in norm)
    x = _wave(rng)
    with torch.no_grad():
        touts = tmodel(torch.from_numpy(x))
    assert len(touts) == tmodel.num_subs == 4
    assert_features(jmodel(params, jnp.asarray(x)), touts, rtol)


@pytest.mark.parametrize("t", [241, 242, 330])
def test_mpd_reflect_pad_matches_jax(rng, t):
    """Periods 2-11 at T = 241 (none divides it), 242 and 330: the pad is
    JAX's ``x[:, t - n_pad - 1 : t - 1][::-1]``."""
    kw = dict(periods=(2, 3, 5, 7, 11),
              discriminator_params=TINY_DISC["period_discriminator_params"])
    jmodel = jdisc.HiFiGANMultiPeriodDiscriminator(**kw)
    params = disc_params(jmodel, 3)
    tmodel = tdisc.HiFiGANMultiPeriodDiscriminator(**kw)
    _load_mpd(tmodel, params)
    x = _wave(rng, t=t)
    with torch.no_grad():
        touts = tmodel(torch.from_numpy(x))
    assert_features(jmodel(params, jnp.asarray(x)), touts)


def test_apply_sub_and_num_subs(rng):
    """``apply_sub(i)`` equals ``forward(x)[i]`` bit for bit (the MSD scales
    pre-pooled i times) and JAX's ``apply_sub``; ``num_subs`` counts scales
    and periods."""
    kw = dict(TINY_DISC, scales=3)
    jmodel, params, tmodel = _pair(JaxHiFiGANDisc, HiFiGANDiscriminator, kw, seed=1)
    assert tmodel.num_subs == jmodel.num_subs == 5
    x = _wave(rng, t=300)
    with torch.no_grad():
        whole = tmodel(torch.from_numpy(x))
        for i in range(tmodel.num_subs):
            sub = tmodel.apply_sub(i, torch.from_numpy(x))
            assert all(torch.equal(a, b) for a, b in zip(sub, whole[i])), i
            assert_features([jmodel.apply_sub(params, i, jnp.asarray(x))], [sub])


@pytest.mark.parametrize("cls", ["hifigan", "univnet"])
def test_multichannel_input_folds_into_batch(rng, cls):
    """(B, T, 2) input: each channel a batch row, as JAX folds it."""
    jcls, tcls, kw, t = ((JaxHiFiGANDisc, HiFiGANDiscriminator, TINY_DISC, 241)
                         if cls == "hifigan" else
                         (JaxUnivNetDisc, UnivNetDiscriminator, TINY_UNIV, 1201))
    jmodel, params, tmodel = _pair(jcls, tcls, kw, seed=2)
    x = _wave(rng, t=t, c=2)
    with torch.no_grad():
        touts = tmodel(torch.from_numpy(x))
        single = tmodel(torch.from_numpy(np.ascontiguousarray(x[1:2, :, 1:])))
    assert_features(jmodel(params, jnp.asarray(x)), touts)
    for a, b in zip(_flat(touts), _flat(single)):
        assert a.shape[0] == 4
        torch.testing.assert_close(a[3:4], b, rtol=0, atol=FEAT_RTOL * float(b.abs().max()))


def test_univnet_discriminator_matches_jax(rng):
    """MRSD (final maps only) + MPD."""
    jmodel, params, tmodel = _pair(JaxUnivNetDisc, UnivNetDiscriminator, TINY_UNIV, seed=3)
    x = _wave(rng, t=1201)
    with torch.no_grad():
        touts = tmodel(torch.from_numpy(x))
    assert all(isinstance(o, torch.Tensor) for o in touts[:2])
    assert all(isinstance(o, list) for o in touts[2:])
    assert_features(jmodel(params, jnp.asarray(x)), touts)


@pytest.mark.parametrize("n_fft,hop,win,pad", [(256, 32, 128, 64), (512, 50, 240, 120),
                                               (128, 40, 128, 0)])
def test_spectrogram_matches_jax(rng, n_fft, hop, win, pad):
    x = _wave(rng, t=900)[..., 0]
    x[0, :300] = 0.0  # silent frames: the eps floor under the sqrt
    got = spectrogram(torch.from_numpy(x), hann_window(win), n_fft=n_fft, hop=hop,
                      win_length=win, pad=pad)
    want = jspectrogram(jnp.asarray(x), jhann(win), n_fft=n_fft, hop=hop, win_length=win,
                        pad=pad)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))
    assert float(got.min()) >= np.sqrt(1e-9) * (1 - 1e-6)


def test_spectrogram_gradient_is_finite_at_silence():
    x = torch.zeros(1, 600, requires_grad=True)
    spectrogram(x, hann_window(120), n_fft=256, hop=30, win_length=120,
                pad=60).sum().backward()
    assert torch.isfinite(x.grad).all()


def test_conv2d_weight_norm_and_layout_match_jax(rng):
    """Conv2d weight norm per output channel (g not ||v||), HWIO carried to
    (out, in, kh, kw), strides and padding as JAX's NHWC conv."""
    jl = jconv.Conv2d(3, 5, (5, 3), (2, 1), (2, 1), weight_norm=True)
    p = disc_params(jl, 5)
    tl = tconv.Conv2d(3, 5, (5, 3), (2, 1), (2, 1), weight_norm=True, device="cpu")
    load_conv(tl, p)
    assert tuple(tl.g.shape) == (5, 1, 1, 1)
    x = rng.standard_normal((2, 11, 7, 3)).astype(np.float32)  # NHWC
    with torch.no_grad():
        got = tl(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    np.testing.assert_allclose(_channels_last(got), np.asarray(jl(p, jnp.asarray(x))),
                               rtol=0, atol=1e-5)
    w = tl.weight.detach()
    norms = torch.sqrt((w * w).sum(dim=(1, 2, 3)))
    torch.testing.assert_close(norms, tl.g.detach().reshape(-1))


def test_norm_weight_unchanged_for_1d():
    """The generalised weight norm gives Conv1d's and ConvTranspose1d's
    (out/in, ., k) weights the same bits as the norm over dims (1, 2)."""
    g = torch.Generator().manual_seed(0)
    for layer in (tconv.Conv1d(6, 8, 5, groups=2, weight_norm=True, generator=g, device="cpu"),
                  tconv.ConvTranspose1d(6, 4, 6, 3, weight_norm=True, generator=g,
                                        device="cpu")):
        with torch.no_grad():
            layer.g.mul_(torch.rand(layer.g.shape, generator=g) + 0.5)
        v, gain = layer.v.detach(), layer.g.detach()
        norm = torch.sqrt((v * v).sum(dim=(1, 2), keepdim=True))
        assert torch.equal(layer.weight.detach(), v * (gain / torch.clamp(norm, min=1e-12)))


def _sigma(normed, w) -> float:
    i = int(np.abs(w).argmax())
    return float(w.reshape(-1)[i] / normed.reshape(-1)[i])


@pytest.mark.parametrize("shape", [(8, 4, 41), (32, 8, 41), (16, 4, 5, 1), (4, 4, 3, 9)])
def test_spectral_norm_sigma_matches_svd(rng, shape):
    """At the test widths both packages' sigma within 1e-4 of the SVD's."""
    w = rng.uniform(-0.3, 0.3, shape).astype(np.float32)
    s1 = np.linalg.svd(w.reshape(shape[0], -1).astype(np.float64), compute_uv=False)[0]
    port = tconv._spectral_norm_weight(torch.from_numpy(w)).numpy()
    jax_w = np.moveaxis(w, 0, -1)  # JAX's (..., out)
    ref = np.asarray(jconv._spectral_norm_weight(jnp.asarray(jax_w), jax_w.ndim - 1))
    assert abs(_sigma(port, w) - s1) <= SPECTRAL_RTOL * s1
    assert abs(_sigma(ref, jax_w) - s1) <= SPECTRAL_RTOL * s1


@pytest.mark.parametrize("config", [COURSE, UNIV], ids=["course", "symADuniv"])
def test_spectral_norm_at_config_widths(config):
    """Every conv weight shape of a config's discriminator, freshly drawn:
    both packages' 100-step estimates are lower bounds of the SVD's sigma
    within FULL_WIDTH_SIGMA_RTOL (power iteration approaches from below;
    near-equal leading singular values slow it)."""
    cfg = load_config(config)
    disc = build_discriminator(cfg.get("model_type", "symAudioDec"), cfg["discriminator_params"],
                               device="cpu")
    shapes = {}
    for name, p in disc.named_parameters():
        if p.ndim >= 3 and not name.endswith(".g"):
            shapes.setdefault(tuple(p.shape), p.detach().numpy())
    for shape, w in shapes.items():
        s1 = np.linalg.svd(w.reshape(shape[0], -1).astype(np.float64), compute_uv=False)[0]
        port = _sigma(tconv._spectral_norm_weight(torch.from_numpy(w)).numpy(), w)
        jax_w = np.moveaxis(w, 0, -1)
        ref = _sigma(np.asarray(jconv._spectral_norm_weight(jnp.asarray(jax_w),
                                                             jax_w.ndim - 1)), jax_w)
        for est in (port, ref):
            assert s1 * (1 - FULL_WIDTH_SIGMA_RTOL) <= est <= s1 * (1 + 1e-5), (shape, est, s1)


def test_spectral_norm_has_no_buffer_and_detached_iterates():
    """Parameters are ``weight`` and ``bias`` with the flag on; the gradient
    flows through sigma with u, v constant (JAX's VJP)."""
    layer = tconv.Conv1d(4, 6, 3, spectral_norm=True, device="cpu")
    assert sorted(n for n, _ in layer.named_parameters()) == ["bias", "weight"]
    assert not list(layer.buffers())
    with pytest.raises(ValueError, match="mutually exclusive"):
        tconv.Conv1d(4, 6, 3, spectral_norm=True, weight_norm=True, device="cpu")
    rng = np.random.default_rng(7)
    w = np.moveaxis(spiked(rng.uniform(-0.5, 0.5, (4, 3, 6)).astype(np.float32), rng), -1, 0)
    probe = np.random.default_rng(8).standard_normal(w.shape).astype(np.float32)
    wt = torch.from_numpy(w).requires_grad_(True)
    (tconv._spectral_norm_weight(wt) * torch.from_numpy(probe)).sum().backward()
    jw, jp = np.moveaxis(w, 0, -1), np.moveaxis(probe, 0, -1)
    jg = jax.grad(lambda a: jnp.sum(jconv._spectral_norm_weight(a, 2) * jp))(jnp.asarray(jw))
    np.testing.assert_allclose(wt.grad.numpy(), np.moveaxis(np.asarray(jg), -1, 0),
                               rtol=0, atol=SPECTRAL_RTOL * float(np.abs(jg).max()))


@pytest.mark.parametrize("cls", ["hifigan", "univnet"])
def test_gradient_matches_jax(rng, cls):
    """d/d(input, params) of a seeded weighted sum of every feature map."""
    jcls, tcls, kw, t = ((JaxHiFiGANDisc, HiFiGANDiscriminator, _with_norm(use_weight_norm=True),
                          241) if cls == "hifigan" else
                         (JaxUnivNetDisc, UnivNetDiscriminator, TINY_UNIV, 1201))
    jmodel, params, tmodel = _pair(jcls, tcls, kw, seed=6)
    x = _wave(rng, t=t)
    with torch.no_grad():
        probe_shapes = [tuple(_channels_last(f).shape) for f in _flat(tmodel(torch.from_numpy(x)))]
    probes = [np.random.default_rng(10 + i).standard_normal(s).astype(np.float32)
              for i, s in enumerate(probe_shapes)]

    def jloss(p, xx):
        return sum(jnp.sum(f * w) for f, w in zip(_flat(jmodel(p, xx)), probes))

    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jax.tree_util.tree_map(jnp.asarray, params),
                                               jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    total = 0.0
    for f, w in zip(_flat(tmodel(xt)), probes):
        a = torch.from_numpy(w)
        if f.ndim == 4:
            a = a.permute(0, 3, 1, 2)
        elif f.ndim == 3:
            a = a.permute(0, 2, 1)
        total = total + (f * a).sum()
    total.backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=0,
                               atol=GRAD_RTOL * float(np.abs(jgx).max()))
    ref = discriminator_from_jax_params(tcls(**kw, device="cpu"),
                                        jax.tree_util.tree_map(np.asarray, jgp))
    got = dict(tmodel.named_parameters())
    for name, g_ref in ref.named_parameters():
        g_ref = g_ref.detach()
        torch.testing.assert_close(got[name].grad, g_ref, rtol=0,
                                   atol=GRAD_RTOL * float(g_ref.abs().max()), msg=name)


def test_build_discriminator_dispatch():
    course = load_config(COURSE)
    univ = load_config(UNIV)
    d = build_discriminator("symAudioDec", course["discriminator_params"], device="cpu")
    assert isinstance(d, HiFiGANDiscriminator) and d.num_subs == 8
    assert d.msd.discriminators[0].layers[4].groups == 16
    assert d.mpd.discriminators[0].convs[0].weight_norm
    assert not d.msd.discriminators[0].layers[0].weight_norm  # follow_official_norm: no-op
    u = build_discriminator(univ["model_type"], univ["discriminator_params"], device="cpu")
    assert isinstance(u, UnivNetDiscriminator) and len(u.mrsd.discriminators) == 3
    assert isinstance(build_discriminator("HiFiGAN", {}, device="cpu"), HiFiGANDiscriminator)
    assert isinstance(build_discriminator("UnivNet", {}, device="cpu"), UnivNetDiscriminator)
    with pytest.raises(NotImplementedError):
        build_discriminator("WaveNet", {}, device="cpu")
    # seeded: the same seed gives the same weights
    again = build_discriminator("symAudioDec", course["discriminator_params"], device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(d.state_dict().values(),
                                                 again.state_dict().values()))


def test_carry_refuses_a_mismatch():
    jmodel = JaxHiFiGANDisc(**TINY_DISC)
    params = disc_params(jmodel, 0)
    wider = dict(TINY_DISC, scale_discriminator_params=dict(
        TINY_DISC["scale_discriminator_params"], channels=16))
    with pytest.raises(ValueError, match="does not fit"):
        discriminator_from_jax_params(HiFiGANDiscriminator(**wider, device="cpu"), params)
    with pytest.raises(ValueError, match="weight_norm"):
        discriminator_from_jax_params(
            HiFiGANDiscriminator(**_with_norm(use_weight_norm=True), device="cpu"), params)
    with pytest.raises(ValueError):
        discriminator_from_jax_params(
            HiFiGANDiscriminator(**dict(TINY_DISC, periods=(2,)), device="cpu"), params)
