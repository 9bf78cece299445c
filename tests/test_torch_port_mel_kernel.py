"""The plain versions of the port's DFT kernels (K6 log-mel, K7 STFT
magnitude) against the JAX package's Pallas kernels in interpret mode.

The plain versions are what the kernel wrappers run on CPU tensors; the
kernels themselves are held to them on the card
(tests/test_torch_port_cuda.py, chip_smoke.py). Tolerances: forward atol
1e-4 (log-mel; the STFT magnitude 1e-4 of its largest value): the same DFT
as matmuls in f32, summed in another order over n_fft = 512 terms (measured
~1e-5). VJP 1e-5 of the largest gradient: the same analytic backward in
both packages, three chained f32 matmuls. The autograd.Functions pass
``torch.autograd.gradcheck`` in f64 at a tiny shape.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dl_speech_enhancement_tpu.ops.mel_kernel import (
    make_fused_log_mel as jax_log_mel,
    make_fused_stft_magnitude as jax_stft_magnitude,
)
from dl_speech_enhancement_tpu_torch.ops import mel_kernel
from torch_port_threads import one_thread  # noqa: F401

FWD_ATOL = 1e-4
VJP_RTOL = 1e-5

# tests/test_ops.py's shapes: the course's 48 kHz log-mel at n_fft 512, and a
# 24 kHz one with a window shorter than the FFT, in log10
LOG_MEL_CASES = {
    "48k-512-300": dict(sr=48000, n_fft=512, hop=300, win_length=None, n_mels=80, fmin=0,
                        fmax=24000, log_base=None),
    "24k-512-120-240-log10": dict(sr=24000, n_fft=512, hop=120, win_length=240, n_mels=40,
                                  fmin=0, fmax=12000, log_base=10.0),
}
STFT_CASES = {"512-120-240": (512, 120, 240), "512-300-512": (512, 300, 512),
              "256-50-200": (256, 50, 200)}


def _log_mel_pair(kw):
    jf = jax_log_mel(kw["sr"], kw["n_fft"], kw["hop"], kw["win_length"], kw["n_mels"],
                     kw["fmin"], kw["fmax"], log_base=kw["log_base"], interpret=True)
    tf = mel_kernel.make_fused_log_mel(kw["sr"], kw["n_fft"], kw["hop"], kw["win_length"],
                                       kw["n_mels"], kw["fmin"], kw["fmax"],
                                       log_base=kw["log_base"], device="cpu")
    return jf, tf


def _vjp_both(jf, tf, x, g):
    _, vjp = jax.vjp(jf, jnp.asarray(x))
    ref = np.asarray(vjp(jnp.asarray(g))[0])
    xt = torch.from_numpy(x).requires_grad_()
    tf(xt).backward(torch.from_numpy(g))
    return xt.grad.numpy(), ref


@pytest.mark.parametrize("name", LOG_MEL_CASES)
def test_log_mel_plain_matches_pallas(rng, name):
    jf, tf = _log_mel_pair(LOG_MEL_CASES[name])
    x = rng.standard_normal((2, 4800)).astype(np.float32) * 0.3
    ref = np.asarray(jf(jnp.asarray(x)))
    got = tf(torch.from_numpy(x))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.detach().numpy(), ref, atol=FWD_ATOL)
    g = rng.standard_normal(ref.shape).astype(np.float32)
    got_g, ref_g = _vjp_both(jf, tf, x, g)
    assert np.abs(got_g - ref_g).max() <= VJP_RTOL * np.abs(ref_g).max()


@pytest.mark.parametrize("name", STFT_CASES)
def test_stft_magnitude_plain_matches_pallas(rng, name):
    n_fft, hop, win = STFT_CASES[name]
    jf = jax_stft_magnitude(n_fft, hop, win, interpret=True)
    tf = mel_kernel.make_fused_stft_magnitude(n_fft, hop, win, device="cpu")
    x = rng.standard_normal((2, 2400)).astype(np.float32) * 0.3
    ref = np.asarray(jf(jnp.asarray(x)))
    got = tf(torch.from_numpy(x)).detach().numpy()
    assert got.shape == ref.shape == (2, 2400 // hop + 1, n_fft // 2 + 1)
    np.testing.assert_allclose(got, ref, atol=FWD_ATOL * np.abs(ref).max())
    g = rng.standard_normal(ref.shape).astype(np.float32)
    got_g, ref_g = _vjp_both(jf, tf, x, g)
    assert np.abs(got_g - ref_g).max() <= VJP_RTOL * np.abs(ref_g).max()


def test_channels_fold_into_the_batch(rng):
    """(B, C, T) input is (B*C, T), as the JAX builders take it."""
    kw = LOG_MEL_CASES["48k-512-300"]
    jf, tf = _log_mel_pair(kw)
    x = rng.standard_normal((2, 2, 2400)).astype(np.float32) * 0.3
    got = tf(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jf(jnp.asarray(x))), atol=FWD_ATOL)
    np.testing.assert_array_equal(got, tf(torch.from_numpy(x.reshape(4, 2400))).numpy())


def test_a_batch_equals_its_examples(rng):
    """The JAX kernel's chunked path equals its single call row for row
    (tests/test_ops.py); the port has no chunks, and a batch's rows equal
    each example's own call. Bit for bit is the kernel's property (every row
    summed in one fixed order), held on the card
    (tests/test_torch_port_cuda.py, chip_smoke.py); the plain version's CPU
    matmul may block a batch otherwise than one row, so here within 1e-6."""
    kw = LOG_MEL_CASES["48k-512-300"]
    _, tf = _log_mel_pair(kw)
    x = torch.from_numpy(rng.standard_normal((6, 4800)).astype(np.float32) * 0.2)
    big = tf(x)
    small = torch.cat([tf(x[i:i + 1]) for i in range(6)])
    torch.testing.assert_close(big, small, atol=1e-6, rtol=0)


def _tiny_frames(rng):
    """(2, 3, 32) f64 frames, each its own memory (gradcheck perturbs one
    element at a time, which overlapping frames of a view would share)."""
    return torch.from_numpy(rng.standard_normal((2, 3, 32)) * 0.3).requires_grad_()


def test_log_mel_function_gradcheck(rng):
    cos_np, sin_np = mel_kernel._dft_bases(32, 24)
    melmat = mel_kernel.mel_filterbank(8000, 32, 6, fmin=0, fmax=4000)
    melmat = np.pad(melmat, ((0, cos_np.shape[1] - melmat.shape[0]), (0, 0)))
    cos_b, sin_b, mel_m = (torch.from_numpy(np.asarray(a, np.float64))
                           for a in (cos_np, sin_np, melmat))
    frames = _tiny_frames(rng)
    for log_base in (None, 10.0):
        assert torch.autograd.gradcheck(
            lambda f: mel_kernel.LogMelFunction.apply(f, cos_b, sin_b, mel_m, 1e-10, log_base),
            (frames,))


def test_stft_magnitude_function_gradcheck(rng):
    cos_b, sin_b = (torch.from_numpy(a.astype(np.float64))
                    for a in mel_kernel._dft_bases(32, 24))
    frames = _tiny_frames(rng)
    assert torch.autograd.gradcheck(
        lambda f: mel_kernel.StftMagnitudeFunction.apply(f, cos_b, sin_b, 17, 1e-7),
        (frames,))


def test_wrappers_refuse_what_the_kernels_do_not_take(rng):
    with pytest.raises(ValueError, match="log_base"):
        mel_kernel.make_fused_log_mel(48000, 512, 300, None, 80, log_base=5.0, device="cpu")
    f = mel_kernel.make_fused_stft_magnitude(256, 50, 200, device="cpu")
    with pytest.raises(ValueError, match="audio"):
        f(torch.zeros(2, 3, 4, 500))
    with pytest.raises(ValueError, match="unsupported device"):
        mel_kernel.log_mel(torch.zeros(1, 2, 8, device="meta"), None, None, None, 1e-10, None)


@pytest.mark.parametrize("name", [*LOG_MEL_CASES, *STFT_CASES])
def test_builders_expose_the_kernel_operands(rng, name):
    """``fn.frames_of`` and ``fn.bases`` (and ``fn.mel_m``) are what the
    builder's kernel call reads: the wrapper called alone on them gives the
    builder's output exactly, and the JAX kernel's within FWD_ATOL."""
    x = rng.standard_normal((2, 2400)).astype(np.float32) * 0.3
    xt = torch.from_numpy(x)
    if name in LOG_MEL_CASES:
        kw = LOG_MEL_CASES[name]
        jf, tf = _log_mel_pair(kw)
        alone = mel_kernel.log_mel(tf.frames_of(xt), *tf.bases, tf.mel_m, 1e-10,
                                   kw["log_base"])
    else:
        n_fft, hop, win = STFT_CASES[name]
        jf = jax_stft_magnitude(n_fft, hop, win, interpret=True)
        tf = mel_kernel.make_fused_stft_magnitude(n_fft, hop, win, device="cpu")
        alone = mel_kernel.stft_magnitude(tf.frames_of(xt), *tf.bases, n_fft // 2 + 1, 1e-7)
    got = tf(xt)
    np.testing.assert_array_equal(alone.reshape(got.shape).numpy(), got.numpy())
    atol = FWD_ATOL if name in LOG_MEL_CASES else FWD_ATOL * float(got.abs().max())
    np.testing.assert_allclose(got.numpy(), np.asarray(jf(jnp.asarray(x))), atol=atol)
