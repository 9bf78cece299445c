"""The fused log-mel (K6) and STFT-magnitude (K7) DFT kernels.

Counterpart of dl_speech_enhancement_tpu/ops/mel_kernel.py. The training
losses' spectral front end is a real DFT written as two products against
windowed cosine and sine bases,

    re, im = frames @ [win*cos, -win*sin]      (rows, n_fft) @ (n_fft, n_freq_p)
    amp    = sqrt(max(re^2 + im^2, eps))
    K6:  log(max(amp @ melmat, eps))          (rows, n_mels)
    K7:  amp                                  (rows, n_freq)

and csrc/dft_spectrum.cu computes each in one launch, reading the frames
as a strided view of the reflect-padded signal (no frames tensor) and
writing only the result. :func:`log_mel` and :func:`stft_magnitude` are the
kernel wrappers: a CPU tensor takes the plain PyTorch version beside each
(:func:`log_mel_plain`, :func:`stft_magnitude_plain`, the same two matmuls),
a CUDA tensor launches the kernel or raises; ``<wrapper>.launches`` counts
kernel launches. Each kernel is wrapped in a ``torch.autograd.Function``
whose backward is the JAX package's analytic VJP (``core_bwd``) in torch
ops, as the JAX package leaves it to XLA.

The JAX module's static chunk loop (``_run_chunked``) is a workaround for
the TPU's scoped memory and is not carried over: the kernels take any row
count.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from dl_speech_enhancement_tpu_torch.dsp.mel import apply_log, mel_filterbank
from dl_speech_enhancement_tpu_torch.dsp.stft import frame_signal, hann_window, reflect_pad
from dl_speech_enhancement_tpu_torch.ops import _cuda
from dl_speech_enhancement_tpu_torch.utils.device import resolve_device

FREQ_TILE = 64  # frequencies per tile of csrc/dft_spectrum.cu (kBN)
MAX_MELS = 128  # mel columns the log-mel kernel's accumulators hold
BACKENDS = ("auto", "cuda", "plain", "eager")
_LOG_KIND = {None: 0, 2.0: 2, 10.0: 10}


def resolve_spectrum_backend(backend: str, device: torch.device) -> str:
    """The route of a spectral front end: ``'auto'`` is ``'cuda'`` (the
    kernels) on a CUDA device and ``'eager'`` (the FFT) on the CPU;
    ``'cuda'`` off the card raises."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}; expected one of {BACKENDS}")
    if backend == "auto":
        return "cuda" if device.type == "cuda" else "eager"
    if backend == "cuda" and device.type != "cuda":
        raise ValueError(f"backend 'cuda' runs the DFT kernels on a CUDA device, not on "
                         f"{device}; use 'eager' or 'plain' there")
    return backend


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@functools.lru_cache(maxsize=16)
def _dft_bases(n_fft: int, win_length: int) -> tuple[np.ndarray, np.ndarray]:
    """Windowed real-DFT bases ``(n_fft, n_freq_p)`` f32, as the JAX
    ``_dft_bases`` builds them (in f64, then rounded), the frequency axis
    zero-padded to a multiple of FREQ_TILE."""
    n_freq = n_fft // 2 + 1
    win = np.zeros(n_fft, np.float32)
    left = (n_fft - win_length) // 2
    win[left: left + win_length] = hann_window(win_length).numpy()
    t = np.arange(n_fft)[:, None]
    k = np.arange(n_freq)[None, :]
    ang = 2.0 * np.pi * t * k / n_fft
    pad = ((0, 0), (0, _round_up(n_freq, FREQ_TILE) - n_freq))
    cos_b = np.pad((np.cos(ang) * win[:, None]).astype(np.float32), pad)
    sin_b = np.pad((-np.sin(ang) * win[:, None]).astype(np.float32), pad)
    return cos_b, sin_b


def _check_frames(what: str, frames: torch.Tensor, bases) -> None:
    if frames.dim() != 3 or frames.stride(-1) != 1:
        raise ValueError(f"{what}: frames must be a (signals, n_frames, n_fft) view with "
                         f"unit sample stride, got {tuple(frames.shape)} at {frames.stride()}")
    for t in (frames, *bases):
        if t.device != frames.device or t.dtype != torch.float32:
            raise ValueError(f"{what}: operands must be float32 on {frames.device}, got "
                             f"{t.dtype} on {t.device}")
    for t in bases:
        if not t.is_contiguous():
            raise ValueError(f"{what}: bases must be contiguous")
    if bases[0].shape[0] != frames.shape[-1] or bases[0].shape[1] % FREQ_TILE:
        raise ValueError(f"{what}: bases {tuple(bases[0].shape)} do not fit n_fft "
                         f"{frames.shape[-1]} and a frequency axis of FREQ_TILE multiples")


def _frame_geometry(frames: torch.Tensor) -> tuple[int, int, int, int, int]:
    """(signal stride, hop, frames per signal, rows, n_fft) of a frames view."""
    signals, n_frames, n_fft = frames.shape
    return (frames.stride(0), frames.stride(1), n_frames, signals * n_frames, n_fft)


def log_mel_plain(frames, cos_b, sin_b, mel_m, eps: float, log_base) -> torch.Tensor:
    """Plain PyTorch version of :func:`log_mel`, ``(rows, n_mels)``."""
    flat = frames.reshape(-1, frames.shape[-1])
    re, im = flat @ cos_b, flat @ sin_b
    amp = torch.sqrt(torch.clamp(re * re + im * im, min=eps))
    return apply_log(torch.clamp(amp @ mel_m, min=eps), log_base)


def log_mel(frames, cos_b, sin_b, mel_m, eps: float, log_base) -> torch.Tensor:
    """K6: log-mel ``(rows, n_mels)`` f32 of the ``(signals, n_frames, n_fft)``
    frames view, rows signal-major; the bases ``(n_fft, n_freq_p)`` and the
    mel matrix ``(n_freq_p, n_mels)`` as :func:`make_fused_log_mel` builds
    them."""
    if frames.device.type == "cpu":
        return log_mel_plain(frames, cos_b, sin_b, mel_m, eps, log_base)
    if frames.device.type != "cuda":
        raise ValueError(f"log_mel: unsupported device {frames.device}")
    _check_frames("log_mel", frames, (cos_b, sin_b, mel_m))
    n_mels = mel_m.shape[1]
    if mel_m.shape[0] != cos_b.shape[1] or n_mels > MAX_MELS:
        raise ValueError(f"log_mel: mel matrix {tuple(mel_m.shape)} does not fit bases "
                         f"{tuple(cos_b.shape)} (at most {MAX_MELS} mels)")
    stride, hop, n_frames, rows, n_fft = _frame_geometry(frames)
    out = torch.empty(rows, n_mels, dtype=torch.float32, device=frames.device)
    if rows == 0:
        return out
    lib = _cuda.load("dft_spectrum")
    err = lib.dse_log_mel(frames.data_ptr(), stride, hop, n_frames, rows, n_fft,
                          cos_b.data_ptr(), sin_b.data_ptr(), cos_b.shape[1], mel_m.data_ptr(),
                          n_mels, eps, _LOG_KIND[log_base], out.data_ptr(),
                          _cuda.stream_handle(frames))
    _cuda.check(lib, err, "log_mel")
    log_mel.launches += 1
    return out


log_mel.launches = 0


def stft_magnitude_plain(frames, cos_b, sin_b, n_freq: int, eps: float) -> torch.Tensor:
    """Plain PyTorch version of :func:`stft_magnitude`, ``(rows, n_freq)``."""
    flat = frames.reshape(-1, frames.shape[-1])
    re, im = flat @ cos_b[:, :n_freq], flat @ sin_b[:, :n_freq]
    return torch.sqrt(torch.clamp(re * re + im * im, min=eps))


def stft_magnitude(frames, cos_b, sin_b, n_freq: int, eps: float) -> torch.Tensor:
    """K7: ``sqrt(max(|DFT|^2, eps))`` ``(rows, n_freq)`` f32 of the frames
    view, with the bases of :func:`make_fused_stft_magnitude`."""
    if frames.device.type == "cpu":
        return stft_magnitude_plain(frames, cos_b, sin_b, n_freq, eps)
    if frames.device.type != "cuda":
        raise ValueError(f"stft_magnitude: unsupported device {frames.device}")
    _check_frames("stft_magnitude", frames, (cos_b, sin_b))
    if n_freq > cos_b.shape[1]:
        raise ValueError(f"stft_magnitude: {n_freq} frequencies for bases "
                         f"{tuple(cos_b.shape)}")
    stride, hop, n_frames, rows, n_fft = _frame_geometry(frames)
    out = torch.empty(rows, n_freq, dtype=torch.float32, device=frames.device)
    if rows == 0:
        return out
    lib = _cuda.load("dft_spectrum")
    err = lib.dse_stft_magnitude(frames.data_ptr(), stride, hop, n_frames, rows, n_fft,
                                 cos_b.data_ptr(), sin_b.data_ptr(), cos_b.shape[1], n_freq,
                                 eps, out.data_ptr(), _cuda.stream_handle(frames))
    _cuda.check(lib, err, "stft_magnitude")
    stft_magnitude.launches += 1
    return out


stft_magnitude.launches = 0


def _dft_backward(frames, cos_b, sin_b, d_power_of):
    """d frames of a DFT-magnitude front end, as the JAX ``core_bwd``:
    recompute re, im and the power, take ``d_power = d_power_of(power,
    amp)`` and return ``(2 re d_power) @ cos^T + (2 im d_power) @ sin^T``."""
    flat = frames.reshape(-1, frames.shape[-1])
    re, im = flat @ cos_b, flat @ sin_b
    power = re * re + im * im
    d_power = d_power_of(power)
    d_flat = (2.0 * re * d_power) @ cos_b.T + (2.0 * im * d_power) @ sin_b.T
    return d_flat.reshape(frames.shape)


class LogMelFunction(torch.autograd.Function):
    """:func:`log_mel` with the JAX package's analytic VJP."""

    @staticmethod
    def forward(ctx, frames, cos_b, sin_b, mel_m, eps, log_base):
        ctx.save_for_backward(frames, cos_b, sin_b, mel_m)
        ctx.eps, ctx.log_base = eps, log_base
        return log_mel(frames, cos_b, sin_b, mel_m, eps, log_base)

    @staticmethod
    def backward(ctx, g):
        frames, cos_b, sin_b, mel_m = ctx.saved_tensors
        eps = ctx.eps
        scale = 1.0 if ctx.log_base is None else 1.0 / float(np.log(ctx.log_base))

        def d_power_of(power):
            amp = torch.sqrt(torch.clamp(power, min=eps))
            mel_raw = amp @ mel_m
            mel = torch.clamp(mel_raw, min=eps)
            d_mel = torch.where(mel_raw >= eps, g * scale / mel, 0.0)
            d_amp = d_mel @ mel_m.T
            return torch.where(power >= eps, d_amp * 0.5 / amp, 0.0)

        return _dft_backward(frames, cos_b, sin_b, d_power_of), None, None, None, None, None


class StftMagnitudeFunction(torch.autograd.Function):
    """:func:`stft_magnitude` with the JAX package's analytic VJP."""

    @staticmethod
    def forward(ctx, frames, cos_b, sin_b, n_freq, eps):
        ctx.save_for_backward(frames, cos_b, sin_b)
        ctx.n_freq, ctx.eps = n_freq, eps
        return stft_magnitude(frames, cos_b, sin_b, n_freq, eps)

    @staticmethod
    def backward(ctx, g):
        frames, cos_b, sin_b = ctx.saved_tensors
        cos_b, sin_b = cos_b[:, :ctx.n_freq], sin_b[:, :ctx.n_freq]
        eps = ctx.eps

        def d_power_of(power):
            amp = torch.sqrt(torch.clamp(power, min=eps))
            return torch.where(power >= eps, g * 0.5 / amp, 0.0)

        return _dft_backward(frames, cos_b, sin_b, d_power_of), None, None, None, None


def _framed(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """(B, T) or (B, C, T) -> the (B', n_frames, n_fft) frames view of the
    reflect-padded signals (centre padding, as torch.stft)."""
    if x.dim() == 3:
        x = x.reshape(-1, x.shape[-1])
    if x.dim() != 2:
        raise ValueError(f"expected (B, T) or (B, C, T) audio, got {tuple(x.shape)}")
    return frame_signal(reflect_pad(x, n_fft // 2), n_fft, hop)


def make_fused_log_mel(sr: int, n_fft: int, hop: int, win_length: int | None, n_mels: int,
                       fmin: float = 0.0, fmax: float | None = None, eps: float = 1e-10,
                       log_base: float | None = None, *, device="cuda", plain: bool = False):
    """Build ``f(x (B, T) or (B, C, T)) -> (B', n_frames, n_mels)``, the
    log-mel of dsp.mel.log_mel_spectrogram (centre reflect padding) through
    K6, its bases and mel matrix uploaded to ``device`` once. ``plain=True``
    runs the kernel's plain version under autograd instead (the ``'plain'``
    route of the losses). ``fn.frames_of(x)`` is the frames view the kernel
    reads and ``fn.bases``, ``fn.mel_m`` are its operands on ``device``, so
    :func:`log_mel` can be called alone on them."""
    if win_length is None:
        win_length = n_fft
    if fmax is None:
        fmax = sr / 2
    if log_base not in _LOG_KIND:
        raise ValueError(f"unsupported log_base: {log_base}")
    device = resolve_device(device)
    cos_np, sin_np = _dft_bases(n_fft, win_length)
    mel_np = mel_filterbank(sr, n_fft, n_mels, fmin=fmin, fmax=fmax)
    mel_np = np.ascontiguousarray(  # the filterbank comes as a transposed (F-order) array
        np.pad(mel_np, ((0, cos_np.shape[1] - mel_np.shape[0]), (0, 0))))
    cos_b, sin_b, mel_m = (torch.tensor(a, device=device) for a in (cos_np, sin_np, mel_np))

    def fn(x: torch.Tensor) -> torch.Tensor:
        if x.device != device:
            raise ValueError(f"log-mel built for {device} got audio on {x.device}")
        frames = _framed(x, n_fft, hop)
        c, s, m = (t.to(x.dtype) for t in (cos_b, sin_b, mel_m))
        if plain:
            out = log_mel_plain(frames, c, s, m, eps, log_base)
        else:
            out = LogMelFunction.apply(frames, c, s, m, eps, log_base)
        return out.reshape(frames.shape[0], frames.shape[1], n_mels)

    fn.frames_of = functools.partial(_framed, n_fft=n_fft, hop=hop)
    fn.bases, fn.mel_m = (cos_b, sin_b), mel_m  # the kernel's operands, to call it alone
    return fn


def make_fused_stft_magnitude(n_fft: int, hop: int, win_length: int, eps: float = 1e-7, *,
                              device="cuda", plain: bool = False):
    """Build ``f(x (B, T) or (B, C, T)) -> (B', n_frames, n_fft // 2 + 1)``,
    dsp.stft.stft_magnitude through K7 (``plain``, ``fn.frames_of`` and
    ``fn.bases`` as in :func:`make_fused_log_mel`)."""
    device = resolve_device(device)
    n_freq = n_fft // 2 + 1
    cos_b, sin_b = (torch.tensor(a, device=device) for a in _dft_bases(n_fft, win_length))

    def fn(x: torch.Tensor) -> torch.Tensor:
        if x.device != device:
            raise ValueError(f"STFT magnitude built for {device} got audio on {x.device}")
        frames = _framed(x, n_fft, hop)
        c, s = cos_b.to(x.dtype), sin_b.to(x.dtype)
        if plain:
            out = stft_magnitude_plain(frames, c, s, n_freq, eps)
        else:
            out = StftMagnitudeFunction.apply(frames, c, s, n_freq, eps)
        return out.reshape(frames.shape[0], frames.shape[1], n_freq)

    fn.frames_of = functools.partial(_framed, n_fft=n_fft, hop=hop)
    fn.bases = (cos_b, sin_b)
    return fn
