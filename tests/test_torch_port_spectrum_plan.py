"""The K6 / K7 planner and the FFT arm's host tables, on the CPU.

csrc/dft_spectrum.cu's FFT arm runs only on the card; what it reads is
built here, so these tests hold it: the planner's arm choice and refusals
(ops/mel_kernel.py::spectrum_arm, plan_spectrum), the kernel's radix-8
Stockham passes and real-FFT split step emulated in torch from the twiddle
table and window a builder uploads (against torch.fft.rfft of the windowed
frames, within 1e-5 of the largest bin: two f32 FFTs of up to 2048 points,
~1e-7 apart measured), and the mel band table (its sums in ascending bin
order against the dense product within 1e-6 of the largest mel value, f32
sums of at most ~100 terms in another order). The kernel itself is held to
its plain version on the card (tests/test_torch_port_cuda.py,
chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from dl_speech_enhancement_tpu_torch.dsp.mel import mel_filterbank
from dl_speech_enhancement_tpu_torch.ops import mel_kernel

FFT_ATOL = 1e-5   # of the largest bin
BAND_ATOL = 1e-6  # of the largest mel value
CONFIG_N_FFT = (512, 1024, 2048)  # the spectral losses' FFT sizes in configs/
# (sr, n_fft, n_mels, fmax) of the course's, the vocoder's and the 24 kHz mel losses
FILTERBANKS = {"course": (48000, 2048, 80, 24000), "vocoder": (48000, 2048, 80, 24000),
               "24k": (24000, 2048, 80, 12000)}


@pytest.mark.parametrize("n_fft,arm", [(64, "fft"), (128, "fft"), (256, "fft"), (512, "fft"),
                                       (1024, "fft"), (2048, "fft"), (4096, "fft"),
                                       (32, "gemm"), (8192, "gemm"), (600, "gemm"),
                                       (1000, "gemm"), (2047, "gemm"), (3072, "gemm")])
def test_planner_picks_the_arm_by_n_fft(n_fft, arm):
    assert mel_kernel.spectrum_arm(n_fft) == arm
    frames = torch.zeros(2, n_fft * 3).unfold(-1, n_fft, n_fft // 4)
    bases = tuple(torch.tensor(a) for a in mel_kernel._dft_bases(n_fft, n_fft))
    assert mel_kernel.plan_spectrum("stft_magnitude", frames, bases) == arm
    fn = mel_kernel.make_fused_stft_magnitude(n_fft, n_fft // 4, n_fft, device="cpu")
    assert fn.arm == arm and (fn.fft_tables is None) == (arm == "gemm")


def test_planner_refuses_what_no_arm_takes():
    n_fft = 512
    bases = tuple(torch.tensor(a) for a in mel_kernel._dft_bases(n_fft, 240))
    mel = torch.zeros(bases[0].shape[1], 129)
    frames = torch.zeros(2, 4 * n_fft).unfold(-1, n_fft, 120)
    with pytest.raises(ValueError, match="129 mels"):
        mel_kernel.plan_spectrum("log_mel", frames, (*bases, mel), 129)
    mel = torch.zeros(bases[0].shape[1], 128)
    assert mel_kernel.plan_spectrum("log_mel", frames, (*bases, mel), 128) == "fft"
    bad_views = {"not 3-D": frames.reshape(-1, n_fft),
                 "strided samples": torch.zeros(2, 8 * n_fft).unfold(-1, 2 * n_fft, 120)[..., ::2],
                 "float64": frames.double()}
    for what, view in bad_views.items():
        with pytest.raises(ValueError, match="frames must be|float32"):
            mel_kernel.plan_spectrum("stft_magnitude", view, bases)
    with pytest.raises(ValueError, match="do not fit n_fft"):
        mel_kernel.plan_spectrum("stft_magnitude", torch.zeros(2, 4096).unfold(-1, 1024, 120),
                                 bases)


def _radices(n_fft: int) -> tuple:
    """The kernel's passes for n_fft / 2 = 2^L points: radix 2^(L % 3)
    first (8 if L % 3 == 0), then radix 8 (dse::fft::transform)."""
    log_n = (n_fft // 2).bit_length() - 1
    first = 1 << (log_n % 3 or 3)
    return (first,) + (8,) * ((log_n - first.bit_length() + 1) // 3)


def _dft(v: list) -> list:
    """The kernel's radix-2/4/8 butterflies (dse::fft::dft2/4/8), each input a
    complex64 tensor."""
    def dft4(a0, a1, a2, a3):
        t0, t1, t2, t3 = a0 + a2, a0 - a2, a1 + a3, (a1 - a3) * -1j
        return [t0 + t2, t1 + t3, t0 - t2, t1 - t3]

    if len(v) == 2:
        return [v[0] + v[1], v[0] - v[1]]
    if len(v) == 4:
        return dft4(*v)
    e, o = dft4(*v[0::2]), dft4(*v[1::2])
    s = np.float32(np.sqrt(0.5))
    o = [o[0], (o[1] * (1 - 1j)) * s, o[2] * -1j, (o[3] * (-1 - 1j)) * s]
    return [e[k] + o[k] for k in range(4)] + [e[k] - o[k] for k in range(4)]


def _emulate_fft_arm(frames: torch.Tensor, tables) -> torch.Tensor:
    """X (rows, n_fft / 2 + 1) as the FFT arm computes it: z[n] = x[2n] w[2n]
    + i x[2n+1] w[2n+1]; Stockham passes (butterfly j of a radix-R pass after
    Ns points reads z[j + r N / R], multiplies by table[2 k r N / (Ns R)], k =
    j % Ns, and writes z[(j / Ns) Ns R + k + r Ns]); then the split step
    X[k] = E + table[k] O, X[N - k] = conj(E - table[k] O)."""
    n_fft = frames.shape[-1]
    n = n_fft // 2
    tw = torch.complex(tables.twiddles[:, 0], tables.twiddles[:, 1])
    xw = frames * tables.window
    z = torch.complex(xw[:, 0::2], xw[:, 1::2])
    ns = 1
    for radix in _radices(n_fft):
        stride = n // radix
        j = torch.arange(stride)
        k = j % ns
        v = [z[:, j + r * stride] * (tw[2 * k * r * (n // (ns * radix))] if r else 1)
             for r in range(radix)]
        out = torch.empty_like(z)
        dest = (j // ns) * ns * radix + k
        for r, y in enumerate(_dft(v)):
            out[:, dest + r * ns] = y
        z, ns = out, ns * radix
    k = torch.arange(n // 2 + 1)
    a, b = z[:, k], z[:, (n - k) % n].conj()
    e, o = (a + b) * 0.5, (a - b) * 0.5 * -1j
    wo = tw[k] * o
    x = torch.empty(frames.shape[0], n + 1, dtype=torch.complex64)
    x[:, n - k] = (e - wo).conj()
    x[:, k] = e + wo
    return x


@pytest.mark.parametrize("n_fft,win", [*((f, f) for f in CONFIG_N_FFT),
                                       (1024, 600), (2048, 1200), (512, 240),
                                       (64, 64), (4096, 4096)])
def test_fft_arm_tables_give_the_rfft(n_fft, win):
    fn = mel_kernel.make_fused_stft_magnitude(n_fft, n_fft // 4, win, device="cpu")
    tables = fn.fft_tables
    rng = np.random.default_rng(n_fft + win)
    x = torch.from_numpy(rng.standard_normal((2, 3 * n_fft)).astype(np.float32) * 0.3)
    frames = fn.frames_of(x).reshape(-1, n_fft)
    # the window's nonzero range is what the kernel reads
    lo, hi = tables.lo, tables.hi
    assert hi - lo == win and not tables.window[:lo].any() and not tables.window[hi:].any()
    np.testing.assert_array_equal(tables.window.numpy(), fn.bases[0][:, 0].numpy())
    got = _emulate_fft_arm(frames, tables)
    ref = torch.fft.rfft(frames.double() * tables.window.double(), dim=-1)
    scale = float(ref.abs().max())
    assert float((got.to(torch.complex128) - ref).abs().max()) <= FFT_ATOL * scale
    # the magnitudes as the kernel rounds them, against the plain version's
    mag = torch.sqrt(torch.clamp(got.real * got.real + got.imag * got.imag, min=1e-7))
    plain = mel_kernel.stft_magnitude_plain(frames[None], *fn.bases, n_fft // 2 + 1, 1e-7)
    assert float((mag - plain).abs().max()) <= FFT_ATOL * scale


def test_twiddles_are_f64_rounded():
    for n_fft in CONFIG_N_FFT:
        tw = mel_kernel.fft_twiddles(n_fft)
        ang = 2.0 * np.pi * np.arange(n_fft) / n_fft
        np.testing.assert_array_equal(tw[:, 0], np.cos(ang).astype(np.float32))
        np.testing.assert_array_equal(tw[:, 1], (-np.sin(ang)).astype(np.float32))


@pytest.mark.parametrize("name", FILTERBANKS)
def test_mel_band_table_sums_the_filterbank(name):
    sr, n_fft, n_mels, fmax = FILTERBANKS[name]
    mel = mel_filterbank(sr, n_fft, n_mels, fmin=0, fmax=fmax)
    bands, weights = mel_kernel.mel_bands(mel)
    assert bands.dtype == np.int32 and weights.dtype == np.float32
    # every nonzero of the filterbank falls in its band, and the band holds it
    dense = np.zeros_like(mel)
    for m, (first, count, offset) in enumerate(bands):
        dense[first: first + count, m] = weights[offset: offset + count]
    np.testing.assert_array_equal(dense, mel)
    assert bands[-1, 2] + bands[-1, 1] == weights.size == np.count_nonzero(mel)
    # the kernel's sum: each band's bins in ascending order, f32
    rng = np.random.default_rng(len(name))
    amp = rng.uniform(0.0, 3.0, (7, mel.shape[0])).astype(np.float32)
    got = np.zeros((7, n_mels), np.float32)
    for m, (first, count, offset) in enumerate(bands):
        for i in range(count):
            got[:, m] += amp[:, first + i] * weights[offset + i]
    ref = amp.astype(np.float64) @ mel.astype(np.float64)
    assert np.abs(got - ref).max() <= BAND_ATOL * np.abs(ref).max()


def test_mel_band_table_refuses_a_split_band():
    mel = mel_filterbank(16000, 256, 10, fmin=0, fmax=8000)
    mel[:, 4] = 0.0
    bands, _ = mel_kernel.mel_bands(mel)
    assert tuple(bands[4, :2]) == (0, 0)  # an empty band sums to nothing
    mel[[10, 12], 4] = 1.0
    with pytest.raises(ValueError, match="not contiguous"):
        mel_kernel.mel_bands(mel)


def test_log_mel_builder_uploads_its_band_table():
    fn = mel_kernel.make_fused_log_mel(48000, 2048, 300, None, 80, fmax=24000, device="cpu")
    assert fn.arm == "fft"
    bands, weights = mel_kernel.mel_bands(
        mel_filterbank(48000, 2048, 80, fmin=0, fmax=24000))
    np.testing.assert_array_equal(fn.fft_tables.bands.numpy(), bands)
    np.testing.assert_array_equal(fn.fft_tables.band_weights.numpy(), weights)
    gemm = mel_kernel.make_fused_log_mel(24000, 600, 150, None, 40, fmax=12000, device="cpu")
    assert gemm.arm == "gemm" and gemm.fft_tables is None


def test_fft_tables_go_only_with_their_operands():
    """The wrappers take a builder's FFT tables only beside the very bases
    (and mel matrix) they were derived with, so the forward's window and
    band table cannot disagree with what its backward reads."""
    stft = mel_kernel.make_fused_stft_magnitude(512, 120, 240, device="cpu")
    mel = mel_kernel.make_fused_log_mel(24000, 512, 120, 240, 40, fmax=12000, device="cpu")
    frames = stft.frames_of(torch.zeros(2, 2000))
    mel_kernel._check_tables("stft_magnitude", stft.fft_tables, frames, stft.bases)
    mel_kernel._check_tables("log_mel", mel.fft_tables, frames, (*mel.bases, mel.mel_m))
    other = mel_kernel.make_fused_stft_magnitude(512, 120, 512, device="cpu")
    refused = {"none": (None, stft.bases), "other window": (other.fft_tables, stft.bases),
               "K7 tables for K6": (stft.fft_tables, (*mel.bases, mel.mel_m)),
               "equal copies": (stft.fft_tables, tuple(b.clone() for b in stft.bases))}
    for what, (tables, operands) in refused.items():
        with pytest.raises(ValueError, match="fn.fft_tables|derived with other operands"):
            mel_kernel._check_tables(what, tables, frames, operands)
