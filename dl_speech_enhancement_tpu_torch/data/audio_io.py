"""Host-side audio file I/O and resampling (no libsndfile available).

The port's own copy of dl_speech_enhancement_tpu/data/audio_io.py: wav
read and write through the native library (data/native.py) where it is
built, else a pure-Python RIFF parser and stdlib ``wave`` (the plain
versions, the same bits); scipy polyphase resampling. Covers
PCM16/PCM24/PCM32/float32 WAV; output is float32 in [-1, 1], shaped (T, C).
"""

from __future__ import annotations

import math
import os
import wave

import numpy as np
from scipy.signal import resample_poly

from dl_speech_enhancement_tpu_torch.data import native


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Returns (audio (T, C) float32, sample_rate).

    The native decoder where it is built, else :func:`read_wav_plain`."""
    result = native.read_wav(path)
    return read_wav_plain(path) if result is None else result


def read_wav_plain(path: str) -> tuple[np.ndarray, int]:
    """A self-contained Python RIFF parser: PCM (format 1), IEEE float
    (format 3), and WAVE_FORMAT_EXTENSIBLE (0xFFFE); stdlib ``wave`` rejects
    float wavs, which the DNS noise corpus uses."""
    with open(path, "rb") as f:
        header = f.read(12)
        if header[:4] != b"RIFF" or header[8:12] != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")
        fmt_tag = None
        sr = ch = sw = None
        raw = None
        while True:
            chunk_hdr = f.read(8)
            if len(chunk_hdr) < 8:
                break
            cid = chunk_hdr[:4]
            size = int.from_bytes(chunk_hdr[4:8], "little")
            if cid == b"fmt ":
                fmt = f.read(size)
                fmt_tag = int.from_bytes(fmt[0:2], "little")
                ch = int.from_bytes(fmt[2:4], "little")
                sr = int.from_bytes(fmt[4:8], "little")
                sw = int.from_bytes(fmt[14:16], "little") // 8
                if fmt_tag == 0xFFFE and size >= 40:  # extensible: subformat GUID
                    fmt_tag = int.from_bytes(fmt[24:26], "little")
            elif cid == b"data":
                raw = f.read(size)
            else:
                f.seek(size + (size & 1), 1)
                continue
            # RIFF pads every odd-sized chunk to even — skip the pad after
            # ANY inline-read chunk (fmt included), or the next chunk
            # header parses one byte off
            if size & 1:
                f.seek(1, 1)
        if raw is None or fmt_tag is None:
            raise ValueError(f"{path}: missing fmt/data chunk")
    if fmt_tag == 3:  # IEEE float
        dt = "<f4" if sw == 4 else "<f8"
        x = np.frombuffer(raw, dtype=dt).astype(np.float32)
        return x.reshape(-1, ch), sr
    if fmt_tag != 1:
        raise ValueError(f"{path}: unsupported WAVE format tag {fmt_tag}")
    if sw == 2:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif sw == 4:
        x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif sw == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        x = (
            (b[:, 0].astype(np.int32))
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        x = (x - ((x & 0x800000) << 1)).astype(np.float32) / 8388608.0
    elif sw == 1:
        x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width: {sw}")
    return x.reshape(-1, ch), sr


def write_wav(path: str, audio: np.ndarray, sample_rate: int, subtype: str = "PCM_16"):
    """Write float32 (T,) or (T, C) audio as PCM WAV (default PCM_16, matching
    the reference's sf.write(..., subtype='PCM_16'), bin/test.py:103): the
    native encoder where it is built, else :func:`write_wav_plain`."""
    if subtype != "PCM_16":
        raise NotImplementedError(subtype)
    if not native.write_wav(path, audio, sample_rate):
        write_wav_plain(path, audio, sample_rate)


def write_wav_plain(path: str, audio: np.ndarray, sample_rate: int):
    """PCM16 through stdlib ``wave``, rounding half to even as the native
    encoder does."""
    a = np.asarray(audio, np.float32)
    if a.ndim == 1:
        a = a[:, None]
    pcm = np.clip(np.round(a * 32768.0), -32768, 32767).astype("<i2")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with wave.open(path, "wb") as f:
        f.setnchannels(a.shape[1])
        f.setsampwidth(2)
        f.setframerate(sample_rate)
        f.writeframes(pcm.tobytes())


def resample(audio: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling along axis 0; identity when rates match."""
    if orig_sr == target_sr:
        return audio
    g = math.gcd(orig_sr, target_sr)
    return resample_poly(audio, target_sr // g, orig_sr // g, axis=0).astype(
        np.float32
    )


def load_audio(path: str, target_sr: int | None = None) -> np.ndarray:
    """Read + optional resample -> (T, C) float32."""
    x, sr = read_wav(path)
    if target_sr is not None and sr != target_sr:
        x = resample(x, sr, target_sr)
    return x
