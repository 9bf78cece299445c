"""The port's metric battery and DNSMOS scorer against the JAX package's
(CPU): eval/metrics.py and eval/dnsmos.py.

The same seeded numpy signals go through both. Tolerances:

- STOI, ESTOI, SDR and ``si_sdr_best_lag`` (value; the lag exactly) within
  1e-10: the same float64 numpy on both sides;
- SNR and SI-SDR (f32, torch against jnp) within 1e-4 dB;
- ``mel_l1`` (the FFT route) within rtol 1e-5;
- DNSMOS: the P.808 front end ``_audio_melspec`` and whole-clip scores
  within 1e-4, on two seeded stand-in graphs at the real graphs' interfaces
  (``chip_smoke.py::dnsmos_standins``; the real graphs are not in the
  repository).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dl_speech_enhancement_tpu.eval import dnsmos as jdnsmos
from dl_speech_enhancement_tpu.eval import metrics as jmetrics
from dl_speech_enhancement_tpu_torch.eval import dnsmos, metrics
from chip_smoke import dnsmos_standins
from torch_port_threads import one_thread  # noqa: F401

EXACT = 1e-10
DB_ATOL = 1e-4
MEL_RTOL = 1e-5
DNSMOS_ATOL = 1e-4


def _speechlike(rng, sr: int, seconds: float) -> np.ndarray:
    t = np.arange(int(sr * seconds)) / sr
    f0 = rng.uniform(100.0, 250.0) * (1.0 + 0.1 * np.sin(np.pi * t))
    phase = 2.0 * np.pi * np.cumsum(f0) / sr
    x = sum(0.3 / h * np.sin(h * phase) for h in (1, 2, 3, 4))
    x *= 0.2 + np.sin(2.0 * np.pi * rng.uniform(1.0, 4.0) * t) ** 2
    return (x + 1e-3 * rng.standard_normal(t.shape)).astype(np.float32)


def _pair(rng, sr, seconds=1.5, noise=0.3):
    clean = _speechlike(rng, sr, seconds)
    return clean, (0.8 * clean + noise * rng.standard_normal(clean.shape)).astype(np.float32)


@pytest.mark.parametrize("sr", [10000, 16000])
@pytest.mark.parametrize("extended", [False, True], ids=["stoi", "estoi"])
def test_stoi_matches_jax(rng, sr, extended):
    clean, noisy = _pair(rng, sr)
    got = metrics.stoi(clean, noisy, sr, extended=extended)
    want = jmetrics.stoi(clean, noisy, sr, extended=extended)
    assert 0.0 < got < 1.0
    assert abs(got - want) <= EXACT


def test_sdr_matches_jax(rng):
    clean, noisy = _pair(rng, 16000, 1.0)
    for kw in ({}, {"zero_mean": True}, {"filter_length": 64}):
        assert abs(metrics.sdr(noisy, clean, **kw) - jmetrics.sdr(noisy, clean, **kw)) <= EXACT


@pytest.mark.parametrize("shift", [0, 72, -40])
def test_si_sdr_best_lag_matches_jax(rng, shift):
    clean, noisy = _pair(rng, 16000, 1.0, noise=0.05)
    est = np.roll(noisy, shift)
    got, got_lag = metrics.si_sdr_best_lag(est, clean, max_lag=200)
    want, want_lag = jmetrics.si_sdr_best_lag(est, clean, max_lag=200)
    assert got_lag == want_lag == shift
    assert abs(got - want) <= EXACT


def test_snr_si_sdr_mae_match_jax(rng):
    clean, noisy = _pair(rng, 16000, 1.0)
    p, c = torch.from_numpy(noisy[None]), torch.from_numpy(clean[None])
    jp, jc = jnp.asarray(noisy[None]), jnp.asarray(clean[None])
    for name in ("signal_noise_ratio", "scale_invariant_sdr"):
        got = float(getattr(metrics, name)(p, c))
        assert abs(got - float(getattr(jmetrics, name)(jp, jc))) <= DB_ATOL, name
    got = float(metrics.mean_absolute_error(p, c))
    assert got == pytest.approx(float(jmetrics.mean_absolute_error(jp, jc)), rel=1e-6)


@pytest.mark.parametrize("sr", [16000, 48000])
def test_mel_l1_matches_jax(rng, sr):
    clean, noisy = _pair(rng, sr, 1.0)
    got = metrics.mel_l1(noisy, clean, sr)
    assert got == pytest.approx(jmetrics.mel_l1(noisy, clean, sr), rel=MEL_RTOL)
    kw = dict(fft_sizes=[512, 1024], hop_sizes=[120, 240], win_lengths=[480, None],
              num_mels=40, fmin=50, fmax=sr // 4, log_base=10.0)
    got = metrics.mel_l1(torch.from_numpy(noisy), clean, sr, **kw)
    assert got == pytest.approx(jmetrics.mel_l1(noisy, clean, sr, **kw), rel=MEL_RTOL)


# ---------------------------------------------------------------- DNSMOS


@pytest.fixture(scope="module")
def scorers(tmp_path_factory):
    primary, p808 = dnsmos_standins(str(tmp_path_factory.mktemp("dnsmos")))
    return (dnsmos.ComputeScore(primary, p808, device="cpu"),
            jdnsmos.ComputeScore(primary, p808))


def test_melspec_front_end_matches_jax(rng, scorers):
    port, jax_scorer = scorers
    audio = (0.1 * rng.standard_normal((2, 144000))).astype(np.float32)
    audio[1] *= np.linspace(0.0, 2.0, 144000, dtype=np.float32)
    got = port._audio_melspec(torch.from_numpy(audio)).numpy()
    want = np.asarray(jax_scorer._audio_melspec(jnp.asarray(audio)))
    assert got.shape == want.shape == (2, 900, 120)
    np.testing.assert_allclose(got, want, rtol=0, atol=DNSMOS_ATOL)


@pytest.mark.parametrize("seconds,personalized,segments", [(4.0, False, 7), (12.5, True, 3)],
                         ids=["repeated", "three-segments"])
def test_scores_match_jax(rng, scorers, seconds, personalized, segments):
    """A short clip (repeated past 9.01 s: 16 s, seven segments) and a long
    one (three), from an array at 48 kHz (resampled); the JAX package pads
    the segments to its power-of-two bucket, the port does not."""
    port, jax_scorer = scorers
    audio = _speechlike(rng, 48000, seconds)
    got = port(audio, 48000, personalized)
    want = jax_scorer(audio, 48000, personalized)
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, float):
            assert abs(got[k] - v) <= DNSMOS_ATOL, k
        else:
            assert got[k] == v, k
    assert got["num_hops"] == segments


def test_scores_of_a_wav_match_jax(rng, scorers, tmp_path):
    from dl_speech_enhancement_tpu_torch.data import write_wav

    port, jax_scorer = scorers
    path = str(tmp_path / "clip.wav")
    write_wav(path, _speechlike(rng, 16000, 3.0), 16000)
    got, want = port(path), jax_scorer(path)
    for k in ("OVRL", "SIG", "BAK", "P808_MOS", "OVRL_raw"):
        assert abs(got[k] - want[k]) <= DNSMOS_ATOL, k
    assert got["filename"] == want["filename"] == path


def test_default_model_paths_follow_the_reference_layout():
    assert dnsmos.default_model_paths(False, "d") == ("d/DNSMOS/sig_bak_ovr.onnx",
                                                      "d/DNSMOS/model_v8.onnx")
    assert dnsmos.default_model_paths(True, "d")[0] == "d/pDNSMOS/sig_bak_ovr.onnx"
