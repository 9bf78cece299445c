"""The port's STFT and log-mel front end against the JAX package.

Inputs are drawn with numpy from a seed and given to both. Tolerances: atol
1e-5 for the window, frames, STFT, magnitudes and the ``'eager'`` log-mel
(both sides are an FFT in f32 on the CPU), 1e-7 for the filterbank (the same
f64 numpy formulas, rounded to f32).
"""

import importlib

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from dl_speech_enhancement_tpu_torch.dsp import mel, stft
from torch_port_threads import one_thread  # noqa: F401

# the JAX package's dsp/__init__.py exports functions named like its modules
jmel = importlib.import_module("dl_speech_enhancement_tpu.dsp.mel")
jstft = importlib.import_module("dl_speech_enhancement_tpu.dsp.stft")
ATOL = 1e-5


@pytest.mark.parametrize("win_length", [240, 512, 2048])
def test_hann_window(win_length):
    np.testing.assert_allclose(stft.hann_window(win_length).numpy(),
                               np.asarray(jstft.hann_window(win_length)), atol=ATOL)


def test_frame_signal(rng):
    x = rng.standard_normal((2, 1000)).astype(np.float32)
    got = stft.frame_signal(torch.from_numpy(x), 256, 60).numpy()
    np.testing.assert_array_equal(got, np.asarray(jstft.frame_signal(jnp.asarray(x), 256, 60)))
    assert got.shape == (2, (1000 - 256) // 60 + 1, 256)


@pytest.mark.parametrize("n_fft,hop,win", [(512, 120, 240), (1024, 120, 600), (256, 64, 256)])
def test_stft_and_magnitude(rng, n_fft, hop, win):
    x = rng.standard_normal((3, 2400)).astype(np.float32) * 0.3
    w_j, w_t = jstft.hann_window(win), stft.hann_window(win)
    ref = np.asarray(jstft.stft(jnp.asarray(x), w_j, n_fft=n_fft, hop=hop, win_length=win))
    got = stft.stft(torch.from_numpy(x), w_t, n_fft=n_fft, hop=hop, win_length=win).numpy()
    np.testing.assert_allclose(got.real, ref.real, atol=ATOL)
    np.testing.assert_allclose(got.imag, ref.imag, atol=ATOL)
    ref_m = np.asarray(jstft.stft_magnitude(jnp.asarray(x), w_j, n_fft=n_fft, hop=hop,
                                            win_length=win))
    got_m = stft.stft_magnitude(torch.from_numpy(x), w_t, n_fft=n_fft, hop=hop,
                                win_length=win).numpy()
    np.testing.assert_allclose(got_m, ref_m, atol=ATOL)


@pytest.mark.parametrize("sr,n_fft,n_mels,fmin,fmax",
                         [(48000, 2048, 80, 0, 24000), (24000, 512, 40, 0, 12000),
                          (22050, 1024, 80, 80, 7600), (4800, 256, 20, 0, 2400)])
def test_mel_filterbank(sr, n_fft, n_mels, fmin, fmax):
    got = mel.mel_filterbank(sr, n_fft, n_mels, fmin=fmin, fmax=fmax)
    ref = jmel.mel_filterbank(sr, n_fft, n_mels, fmin=fmin, fmax=fmax)
    assert got.shape == (n_fft // 2 + 1, n_mels) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-7)
    f = np.linspace(0.0, sr / 2, 50)
    np.testing.assert_allclose(mel.hz_to_mel(f), jmel.hz_to_mel(f), rtol=1e-12)
    np.testing.assert_allclose(mel.mel_to_hz(mel.hz_to_mel(f)), f, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("kw", [
    dict(fs=48000, fft_size=2048, hop_size=300, win_length=None, num_mels=80, fmin=0,
         fmax=24000, log_base=None),
    dict(fs=24000, fft_size=512, hop_size=120, win_length=240, num_mels=40, fmin=0,
         fmax=12000, log_base=10.0),
    dict(fs=22050, fft_size=1024, hop_size=256, win_length=None, num_mels=80, fmin=80,
         fmax=7600, log_base=2.0),
], ids=["course", "log10-short-window", "log2"])
def test_mel_spectrogram_eager_matches_xla(rng, kw):
    x = rng.standard_normal((2, 1, 4800)).astype(np.float32) * 0.3
    ref = np.asarray(jmel.MelSpectrogram(**kw, backend="xla")(jnp.asarray(x)))
    spec = mel.MelSpectrogram(**kw, backend="eager", device="cpu")
    assert spec.backend == "eager"
    np.testing.assert_allclose(spec(torch.from_numpy(x)).numpy(), ref, atol=ATOL)


def test_mel_spectrogram_routes():
    auto = mel.MelSpectrogram(fs=4800, fft_size=256, hop_size=60, device="cpu")
    assert auto.backend == "eager"  # 'auto' on the CPU is the FFT route
    with pytest.raises(ValueError, match="'cuda'"):
        mel.MelSpectrogram(fs=4800, fft_size=256, hop_size=60, backend="cuda", device="cpu")
    with pytest.raises(ValueError, match="backend"):
        mel.MelSpectrogram(fs=4800, fft_size=256, hop_size=60, backend="xla", device="cpu")
    with pytest.raises(ValueError, match="log_base"):
        mel.MelSpectrogram(fs=4800, fft_size=256, hop_size=60, log_base=5.0, device="cpu")


def test_mel_spectrogram_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mel.MelSpectrogram(fs=4800, fft_size=256, hop_size=60)
