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
writing only the result. Each kernel has two arms, picked by n_fft alone
(:func:`spectrum_arm`): ``'fft'``, a real FFT in shared memory fused with
the window, the magnitude and (K6) the sparse mel projection, for a power
of two in ``FFT_N_FFT``; ``'gemm'``, the DFT as two GEMMs against the bases,
for any other n_fft. :func:`log_mel` and :func:`stft_magnitude` are the
kernel wrappers: a CPU tensor takes the plain PyTorch version beside each
(:func:`log_mel_plain`, :func:`stft_magnitude_plain`, the same two matmuls),
a CUDA tensor launches the kernel or raises; ``<wrapper>.launches`` counts
kernel launches and ``<wrapper>.arm_launches`` splits them by arm. Each
kernel is wrapped in a ``torch.autograd.Function`` whose backward is the
JAX package's analytic VJP (``core_bwd``) in torch ops, as the JAX package
leaves it to XLA.

The JAX module's static chunk loop (``_run_chunked``) is a workaround for
the TPU's scoped memory and is not carried over: the kernels take any row
count.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from dl_speech_enhancement_tpu_torch.dsp.mel import apply_log, mel_filterbank
from dl_speech_enhancement_tpu_torch.dsp.stft import frame_signal, hann_window, reflect_pad
from dl_speech_enhancement_tpu_torch.ops import _cuda
from dl_speech_enhancement_tpu_torch.utils.device import resolve_device

FREQ_TILE = 64  # frequencies per tile of csrc/dft_spectrum.cu's GEMM arm (kBN)
MAX_MELS = 128  # mel columns the log-mel kernel's accumulators hold
FFT_N_FFT = (64, 4096)  # the FFT arm's powers of two (dse::fft::kMinLogN, kMaxLogN)
ARMS = ("fft", "gemm")
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


def _window(n_fft: int, win_length: int) -> np.ndarray:
    """The periodic Hann window of ``win_length`` f32, centred in ``n_fft``
    zeros (torch.stft's convention)."""
    win = np.zeros(n_fft, np.float32)
    left = (n_fft - win_length) // 2
    win[left: left + win_length] = hann_window(win_length).numpy()
    return win


@functools.lru_cache(maxsize=16)
def _dft_bases(n_fft: int, win_length: int) -> tuple[np.ndarray, np.ndarray]:
    """Windowed real-DFT bases ``(n_fft, n_freq_p)`` f32, as the JAX
    ``_dft_bases`` builds them (in f64, then rounded), the frequency axis
    zero-padded to a multiple of FREQ_TILE."""
    n_freq = n_fft // 2 + 1
    win = _window(n_fft, win_length)
    t = np.arange(n_fft)[:, None]
    k = np.arange(n_freq)[None, :]
    ang = 2.0 * np.pi * t * k / n_fft
    pad = ((0, 0), (0, _round_up(n_freq, FREQ_TILE) - n_freq))
    cos_b = np.pad((np.cos(ang) * win[:, None]).astype(np.float32), pad)
    sin_b = np.pad((-np.sin(ang) * win[:, None]).astype(np.float32), pad)
    return cos_b, sin_b


def spectrum_arm(n_fft: int) -> str:
    """The kernels' arm for an n_fft, by shape alone: ``'fft'`` (the
    shared-memory real FFT) for a power of two in FFT_N_FFT, ``'gemm'`` (the
    DFT as two GEMMs against the bases) for any other."""
    lo, hi = FFT_N_FFT
    return "fft" if lo <= n_fft <= hi and n_fft & (n_fft - 1) == 0 else "gemm"


@functools.lru_cache(maxsize=16)
def fft_twiddles(n_fft: int) -> np.ndarray:
    """``(n_fft, 2)`` f32 ``W^k = exp(-2 pi i k / n_fft)``, computed in f64 and
    rounded: the FFT arm's passes read ``W^(2 k)`` (the ``n_fft / 2``-point
    transform's twiddles) and its real-FFT split step ``W^k``."""
    ang = 2.0 * np.pi * np.arange(n_fft) / n_fft
    return np.stack([np.cos(ang), -np.sin(ang)], axis=1).astype(np.float32)


def mel_bands(mel: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The FFT arm's band table of a dense ``(n_freq, n_mels)`` filterbank:
    ``(n_mels, 3)`` int32 (first bin, bins, offset into the weights) of each
    band's nonzeros, and those weights packed band after band (f32). Raises
    ValueError if a band's nonzeros are not one contiguous range of bins."""
    bands, weights = np.zeros((mel.shape[1], 3), np.int32), []
    offset = 0
    for m in range(mel.shape[1]):
        nz = np.flatnonzero(mel[:, m])
        if nz.size and nz[-1] - nz[0] + 1 != nz.size:
            raise ValueError(f"mel band {m}: its nonzeros are not contiguous (bins {nz})")
        first, count = (int(nz[0]), int(nz.size)) if nz.size else (0, 0)
        bands[m] = (first, count, offset)
        weights.append(mel[first: first + count, m])
        offset += count
    return bands, np.concatenate(weights).astype(np.float32)


class FftTables(NamedTuple):
    """What the FFT arm reads beside the frames, on the operands' device: the
    ``(n_fft,)`` window and its nonzero range ``[lo, hi)``, the ``(n_fft, 2)``
    twiddles (:func:`fft_twiddles`) and, for K6, :func:`mel_bands`'s table
    and weights; ``operands`` are the bases (and, for K6, the mel matrix)
    they were derived with, the only ones the wrappers take them beside."""
    window: torch.Tensor
    lo: int
    hi: int
    twiddles: torch.Tensor
    operands: tuple
    bands: torch.Tensor | None = None
    band_weights: torch.Tensor | None = None


def fft_tables(n_fft: int, win_length: int, operands: tuple,
               mel: np.ndarray | None = None) -> FftTables:
    """The FFT arm's tables for one n_fft, window and (K6) filterbank ``mel``,
    on the device of ``operands``, the bases ``(cos_b, sin_b)`` (and
    ``mel_m``) built from the same n_fft, window and filterbank."""
    device = operands[0].device
    lo = (n_fft - win_length) // 2
    window, twiddles = (torch.tensor(a, device=device)
                        for a in (_window(n_fft, win_length), fft_twiddles(n_fft)))
    bands = () if mel is None else (torch.tensor(a, device=device) for a in mel_bands(mel))
    return FftTables(window, lo, lo + win_length, twiddles, tuple(operands), *bands)


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


def plan_spectrum(what: str, frames: torch.Tensor, bases, n_mels: int | None = None) -> str:
    """The arm of a kernel call (:func:`spectrum_arm` of the frames' n_fft),
    after the checks both arms need: the frames view and its operands
    (:func:`_check_frames`) and, for a log-mel, at most MAX_MELS mels."""
    _check_frames(what, frames, bases)
    if n_mels is not None and not 1 <= n_mels <= MAX_MELS:
        raise ValueError(f"{what}: {n_mels} mels (the kernels take 1 to {MAX_MELS})")
    return spectrum_arm(frames.shape[-1])


def _check_tables(what: str, fft: FftTables | None, frames: torch.Tensor,
                  operands: tuple) -> None:
    """The FFT arm's tables must be those derived with these very operands
    (the bases and, for K6, the mel matrix), so the forward's window and band
    table agree with the bases and filterbank its backward uses."""
    if fft is None:
        raise ValueError(f"{what}: the FFT arm (n_fft {frames.shape[-1]}) needs the "
                         f"builder's tables (fn.fft_tables)")
    if len(fft.operands) != len(operands) or any(
            a is not b for a, b in zip(fft.operands, operands)):
        raise ValueError(f"{what}: the FFT tables were derived with other operands; pass "
                         f"the tables of the builder whose bases and mel matrix these are")


def _frame_geometry(frames: torch.Tensor) -> tuple[int, int, int, int, int]:
    """(signal stride, hop, frames per signal, rows, n_fft) of a frames view."""
    signals, n_frames, n_fft = frames.shape
    return (frames.stride(0), frames.stride(1), n_frames, signals * n_frames, n_fft)


def _launch(arm: str, frames, out, bases, eps: float, fft: FftTables | None = None,
            mel: tuple | None = None) -> None:
    """Launch ``arm``'s kernel on the frames view into ``out``: K6 when
    ``mel`` is ``(mel_m, log kind)``, ``out`` (rows, n_mels); K7 when it is
    None, ``out`` (rows, n_freq). The operands are the caller's to check.
    Counts nothing: the wrappers count their launches."""
    kind = "stft_magnitude" if mel is None else "log_mel"
    stride, hop, n_frames, rows, n_fft = _frame_geometry(frames)
    args = [frames.data_ptr(), stride, hop, n_frames, rows, n_fft]
    if arm == "fft":
        args += [fft.window.data_ptr(), fft.lo, fft.hi, fft.twiddles.data_ptr()]
        if mel is not None:
            args += [fft.bands.data_ptr(), fft.band_weights.data_ptr()]
    else:
        args += [bases[0].data_ptr(), bases[1].data_ptr(), bases[0].shape[1]]
        if mel is not None:
            args.append(mel[0].data_ptr())
    args += [out.shape[1], eps, *(() if mel is None else mel[1:]), out.data_ptr(),
             _cuda.stream_handle(frames)]
    lib = _cuda.load("dft_spectrum")
    err = getattr(lib, f"dse_{kind}_fft" if arm == "fft" else f"dse_{kind}")(*args)
    _cuda.check(lib, err, f"{kind} ({arm} arm)")


def log_mel_plain(frames, cos_b, sin_b, mel_m, eps: float, log_base) -> torch.Tensor:
    """Plain PyTorch version of :func:`log_mel`, ``(rows, n_mels)``."""
    flat = frames.reshape(-1, frames.shape[-1])
    re, im = flat @ cos_b, flat @ sin_b
    amp = torch.sqrt(torch.clamp(re * re + im * im, min=eps))
    return apply_log(torch.clamp(amp @ mel_m, min=eps), log_base)


def log_mel(frames, cos_b, sin_b, mel_m, eps: float, log_base,
            fft: FftTables | None = None) -> torch.Tensor:
    """K6: log-mel ``(rows, n_mels)`` f32 of the ``(signals, n_frames, n_fft)``
    frames view, rows signal-major; the bases ``(n_fft, n_freq_p)``, the mel
    matrix ``(n_freq_p, n_mels)`` (at most MAX_MELS mels) and, for a power of
    two n_fft from 64 to 4096 (the FFT arm), the tables ``fft`` as
    :func:`make_fused_log_mel` builds them."""
    if frames.device.type == "cpu":
        return log_mel_plain(frames, cos_b, sin_b, mel_m, eps, log_base)
    if frames.device.type != "cuda":
        raise ValueError(f"log_mel: unsupported device {frames.device}")
    n_mels = mel_m.shape[1]
    arm = plan_spectrum("log_mel", frames, (cos_b, sin_b, mel_m), n_mels)
    if mel_m.shape[0] != cos_b.shape[1]:
        raise ValueError(f"log_mel: mel matrix {tuple(mel_m.shape)} does not fit bases "
                         f"{tuple(cos_b.shape)}")
    if arm == "fft":
        _check_tables("log_mel", fft, frames, (cos_b, sin_b, mel_m))
    out = torch.empty(frames.shape[0] * frames.shape[1], n_mels, dtype=torch.float32,
                      device=frames.device)
    if out.shape[0] == 0:
        return out
    _launch(arm, frames, out, (cos_b, sin_b), eps, fft, (mel_m, _LOG_KIND[log_base]))
    log_mel.launches += 1
    log_mel.arm_launches[arm] += 1
    return out


log_mel.launches = 0
log_mel.arm_launches = dict.fromkeys(ARMS, 0)


def stft_magnitude_plain(frames, cos_b, sin_b, n_freq: int, eps: float) -> torch.Tensor:
    """Plain PyTorch version of :func:`stft_magnitude`, ``(rows, n_freq)``."""
    flat = frames.reshape(-1, frames.shape[-1])
    re, im = flat @ cos_b[:, :n_freq], flat @ sin_b[:, :n_freq]
    return torch.sqrt(torch.clamp(re * re + im * im, min=eps))


def stft_magnitude(frames, cos_b, sin_b, n_freq: int, eps: float,
                   fft: FftTables | None = None) -> torch.Tensor:
    """K7: ``sqrt(max(|DFT|^2, eps))`` ``(rows, n_freq)`` f32 of the frames
    view, with the bases and, for a power of two n_fft from 64 to 4096 (the
    FFT arm), the tables ``fft`` of :func:`make_fused_stft_magnitude`."""
    if frames.device.type == "cpu":
        return stft_magnitude_plain(frames, cos_b, sin_b, n_freq, eps)
    if frames.device.type != "cuda":
        raise ValueError(f"stft_magnitude: unsupported device {frames.device}")
    arm = plan_spectrum("stft_magnitude", frames, (cos_b, sin_b))
    if n_freq > cos_b.shape[1] or (arm == "fft" and n_freq > frames.shape[-1] // 2 + 1):
        raise ValueError(f"stft_magnitude: {n_freq} frequencies for bases "
                         f"{tuple(cos_b.shape)}")
    if arm == "fft":
        _check_tables("stft_magnitude", fft, frames, (cos_b, sin_b))
    out = torch.empty(frames.shape[0] * frames.shape[1], n_freq, dtype=torch.float32,
                      device=frames.device)
    if out.shape[0] == 0:
        return out
    _launch(arm, frames, out, (cos_b, sin_b), eps, fft)
    stft_magnitude.launches += 1
    stft_magnitude.arm_launches[arm] += 1
    return out


stft_magnitude.launches = 0
stft_magnitude.arm_launches = dict.fromkeys(ARMS, 0)


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
    def forward(ctx, frames, cos_b, sin_b, mel_m, eps, log_base, fft=None):
        ctx.save_for_backward(frames, cos_b, sin_b, mel_m)
        ctx.eps, ctx.log_base = eps, log_base
        return log_mel(frames, cos_b, sin_b, mel_m, eps, log_base, fft)

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

        return (_dft_backward(frames, cos_b, sin_b, d_power_of),
                None, None, None, None, None, None)


class StftMagnitudeFunction(torch.autograd.Function):
    """:func:`stft_magnitude` with the JAX package's analytic VJP."""

    @staticmethod
    def forward(ctx, frames, cos_b, sin_b, n_freq, eps, fft=None):
        ctx.save_for_backward(frames, cos_b, sin_b)
        ctx.n_freq, ctx.eps = n_freq, eps
        return stft_magnitude(frames, cos_b, sin_b, n_freq, eps, fft)

    @staticmethod
    def backward(ctx, g):
        frames, cos_b, sin_b = ctx.saved_tensors
        cos_b, sin_b = cos_b[:, :ctx.n_freq], sin_b[:, :ctx.n_freq]
        eps = ctx.eps

        def d_power_of(power):
            amp = torch.sqrt(torch.clamp(power, min=eps))
            return torch.where(power >= eps, g * 0.5 / amp, 0.0)

        return _dft_backward(frames, cos_b, sin_b, d_power_of), None, None, None, None, None


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
    reads and ``fn.bases``, ``fn.mel_m`` and ``fn.fft_tables`` (None on the
    GEMM arm) are its operands on ``device``, so :func:`log_mel` can be called
    alone on them; ``fn.arm`` is the arm its calls take."""
    if win_length is None:
        win_length = n_fft
    if fmax is None:
        fmax = sr / 2
    if log_base not in _LOG_KIND:
        raise ValueError(f"unsupported log_base: {log_base}")
    device = resolve_device(device)
    cos_np, sin_np = _dft_bases(n_fft, win_length)
    mel_np = mel_filterbank(sr, n_fft, n_mels, fmin=fmin, fmax=fmax)
    mel_p = np.ascontiguousarray(  # the filterbank comes as a transposed (F-order) array
        np.pad(mel_np, ((0, cos_np.shape[1] - mel_np.shape[0]), (0, 0))))
    cos_b, sin_b, mel_m = (torch.tensor(a, device=device) for a in (cos_np, sin_np, mel_p))
    arm = spectrum_arm(n_fft)
    tables = (fft_tables(n_fft, win_length, (cos_b, sin_b, mel_m), mel_np) if arm == "fft"
              else None)

    def fn(x: torch.Tensor) -> torch.Tensor:
        if x.device != device:
            raise ValueError(f"log-mel built for {device} got audio on {x.device}")
        frames = _framed(x, n_fft, hop)
        c, s, m = (t.to(x.dtype) for t in (cos_b, sin_b, mel_m))
        if plain:
            out = log_mel_plain(frames, c, s, m, eps, log_base)
        else:
            out = LogMelFunction.apply(frames, c, s, m, eps, log_base, tables)
        return out.reshape(frames.shape[0], frames.shape[1], n_mels)

    fn.frames_of = functools.partial(_framed, n_fft=n_fft, hop=hop)
    fn.bases, fn.mel_m = (cos_b, sin_b), mel_m  # the kernel's operands, to call it alone
    fn.fft_tables, fn.arm = tables, arm
    return fn


def make_fused_stft_magnitude(n_fft: int, hop: int, win_length: int, eps: float = 1e-7, *,
                              device="cuda", plain: bool = False):
    """Build ``f(x (B, T) or (B, C, T)) -> (B', n_frames, n_fft // 2 + 1)``,
    dsp.stft.stft_magnitude through K7 (``plain``, ``fn.frames_of``,
    ``fn.bases``, ``fn.fft_tables`` and ``fn.arm`` as in
    :func:`make_fused_log_mel`)."""
    device = resolve_device(device)
    n_freq = n_fft // 2 + 1
    cos_b, sin_b = (torch.tensor(a, device=device) for a in _dft_bases(n_fft, win_length))
    arm = spectrum_arm(n_fft)
    tables = fft_tables(n_fft, win_length, (cos_b, sin_b)) if arm == "fft" else None

    def fn(x: torch.Tensor) -> torch.Tensor:
        if x.device != device:
            raise ValueError(f"STFT magnitude built for {device} got audio on {x.device}")
        frames = _framed(x, n_fft, hop)
        c, s = cos_b.to(x.dtype), sin_b.to(x.dtype)
        if plain:
            out = stft_magnitude_plain(frames, c, s, n_freq, eps)
        else:
            out = StftMagnitudeFunction.apply(frames, c, s, n_freq, eps, tables)
        return out.reshape(frames.shape[0], frames.shape[1], n_freq)

    fn.frames_of = functools.partial(_framed, n_fft=n_fft, hop=hop)
    fn.bases = (cos_b, sin_b)
    fn.fft_tables, fn.arm = tables, arm
    return fn
