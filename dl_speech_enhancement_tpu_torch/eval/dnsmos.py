"""DNSMOS P.835 / P.808 scoring in PyTorch (no onnxruntime).

Counterpart of dl_speech_enhancement_tpu/eval/dnsmos.py (reference
DNSMOS/dnsmos_local.py:22-100): the two ONNX graphs are parsed
(eval/onnx_graph.py) and run by the torch interpreter (eval/onnx_torch.py)
on the device; the P.808 mel front end reproduces
``librosa.feature.melspectrogram(n_fft=321, hop=160, n_mels=120)`` +
``power_to_db(ref=max)`` with the port's ``dsp/stft.py::stft`` (centred,
reflect-padded) and Slaney ``mel_filterbank``. The segments of a clip are
scored in one batched call per graph, in place of the reference's per-file
thread pool; their count is not padded (the JAX package pads it to a power
of two only to spare recompiles; the rows are independent, so the scores
are the same).

The graphs (``sig_bak_ovr.onnx``, ``model_v8.onnx``) are not in the
repository: pass their paths, or a directory laid out as the reference's
``DNSMOS/`` (``default_model_paths``).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from dl_speech_enhancement_tpu_torch.data.audio_io import load_audio, resample
from dl_speech_enhancement_tpu_torch.dsp.mel import mel_filterbank
from dl_speech_enhancement_tpu_torch.dsp.stft import hann_window, stft
from dl_speech_enhancement_tpu_torch.eval.onnx_torch import OnnxModel
from dl_speech_enhancement_tpu_torch.utils.device import resolve_device

SAMPLING_RATE = 16000
INPUT_LENGTH = 9.01

# the reference checkout's DNSMOS/ directory, relative to the working directory
DEFAULT_MODEL_DIR = "DNSMOS"

# P.835 polynomial calibration (dnsmos_local.py:33-47)
_POLY = {
    False: {"ovr": [-0.06766283, 1.11546468, 0.04602535],
            "sig": [-0.08397278, 1.22083953, 0.0052439],
            "bak": [-0.13166888, 1.60915514, -0.39604546]},
    True: {"ovr": [-0.00533021, 0.005101, 1.18058466, -0.11236046],
           "sig": [-0.01019296, 0.02751166, 1.19576786, -0.24348726],
           "bak": [-0.04976499, 0.44276479, -0.1644611, 0.96883132]},
}


def _polyval(coeffs, x):
    y = 0.0
    for c in coeffs:
        y = y * x + c
    return y


def default_model_paths(personalized: bool = False, model_dir: str = DEFAULT_MODEL_DIR):
    """(primary, P.808) graph paths under ``model_dir``, the reference's
    layout: ``DNSMOS/sig_bak_ovr.onnx`` (``pDNSMOS/`` when personalized) and
    ``DNSMOS/model_v8.onnx``."""
    sub = "pDNSMOS" if personalized else "DNSMOS"
    return (os.path.join(model_dir, sub, "sig_bak_ovr.onnx"),
            os.path.join(model_dir, "DNSMOS", "model_v8.onnx"))


class ComputeScore:
    """DNSMOS scorer (drop-in for dnsmos_local.ComputeScore) on ``device``
    (the card by default)."""

    def __init__(self, primary_model_path: str | None = None,
                 p808_model_path: str | None = None, personalized: bool = False,
                 device="cuda"):
        if primary_model_path is None or p808_model_path is None:
            primary_model_path, p808_model_path = default_model_paths(personalized)
        self.device = resolve_device(device)
        self.personalized = personalized
        self.primary = OnnxModel(primary_model_path, device=self.device)
        self.p808 = OnnxModel(p808_model_path, device=self.device)
        # librosa.feature.melspectrogram(n_fft=321, hop=160, n_mels=120):
        # power-2 magnitude, Slaney mel, fmax = sr / 2
        self._n_fft, self._hop = 321, 160
        self._window = hann_window(self._n_fft, device=self.device)
        self._melmat = torch.from_numpy(
            mel_filterbank(SAMPLING_RATE, self._n_fft, 120, fmin=0.0)).to(self.device)

    @torch.no_grad()
    def _audio_melspec(self, audio: torch.Tensor) -> torch.Tensor:
        """(B, T) -> (B, frames, 120): (power_to_db(ref=max) + 40) / 40 with
        the 80 dB floor."""
        z = stft(audio, self._window, n_fft=self._n_fft, hop=self._hop, center=True,
                 pad_mode="reflect")
        mel = (z.real * z.real + z.imag * z.imag) @ self._melmat
        db = 10.0 * torch.log10(torch.clamp(mel, min=1e-10))
        db = db - torch.amax(db, dim=(1, 2), keepdim=True)
        db = torch.maximum(db, torch.amax(db, dim=(1, 2), keepdim=True) - 80.0)
        return (db + 40.0) / 40.0

    def score_segments(self, segments) -> dict:
        """segments: (N, 144160) float32 at 16 kHz -> per-segment raw MOS."""
        segs = torch.as_tensor(np.asarray(segments, np.float32), device=self.device)
        p808 = self.p808(self._audio_melspec(segs[:, :-160]))[0].cpu().numpy()[:, 0]
        sig_bak_ovr = self.primary(segs)[0].cpu().numpy()
        return {"p808": p808, "sig_raw": sig_bak_ovr[:, 0], "bak_raw": sig_bak_ovr[:, 1],
                "ovr_raw": sig_bak_ovr[:, 2]}

    def __call__(self, fpath_or_audio, sampling_rate: int = SAMPLING_RATE,
                 is_personalized_MOS: bool | None = None) -> dict:
        """Score one clip (a path or a waveform array); returns the
        reference's clip dict (dnsmos_local.py:91-100)."""
        if is_personalized_MOS is None:
            is_personalized_MOS = self.personalized
        if isinstance(fpath_or_audio, str):
            audio = load_audio(fpath_or_audio, SAMPLING_RATE)[:, 0]
            fname = fpath_or_audio
        else:
            audio = np.asarray(fpath_or_audio, np.float32).reshape(-1)
            if sampling_rate != SAMPLING_RATE:
                audio = resample(audio[:, None], sampling_rate, SAMPLING_RATE)[:, 0]
            fname = "<array>"
        fs = SAMPLING_RATE
        actual_len = len(audio)
        len_samples = int(INPUT_LENGTH * fs)
        while len(audio) < len_samples:
            audio = np.append(audio, audio)
        num_hops = int(np.floor(len(audio) / fs) - INPUT_LENGTH) + 1
        segs = []
        for idx in range(num_hops):
            seg = audio[int(idx * fs): int((idx + INPUT_LENGTH) * fs)]
            if len(seg) >= len_samples:
                segs.append(seg[:len_samples])
        raw = self.score_segments(np.stack(segs))
        poly = _POLY[bool(is_personalized_MOS)]
        sig = _polyval(poly["sig"], raw["sig_raw"])
        bak = _polyval(poly["bak"], raw["bak_raw"])
        ovr = _polyval(poly["ovr"], raw["ovr_raw"])
        return {
            "filename": fname,
            "len_in_sec": actual_len / fs,
            "sr": fs,
            "num_hops": num_hops,
            "OVRL_raw": float(np.mean(raw["ovr_raw"])),
            "SIG_raw": float(np.mean(raw["sig_raw"])),
            "BAK_raw": float(np.mean(raw["bak_raw"])),
            "OVRL": float(np.mean(ovr)),
            "SIG": float(np.mean(sig)),
            "BAK": float(np.mean(bak)),
            "P808_MOS": float(np.mean(raw["p808"])),
        }
