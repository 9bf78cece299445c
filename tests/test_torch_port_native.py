"""The port's native host library binding (data/native.py) on the CPU: its
wav reader, wav writer and batched crop bit for bit against the port's plain
versions (the Python RIFF parser, stdlib ``wave``, numpy slicing) and
against the JAX package's binding of the same source; the port's collater
batches bit for bit against the JAX collaters'; the fallback when the
library is not available."""

import struct

import numpy as np
import pytest

from dl_speech_enhancement_tpu.data import collate as jcollate
from dl_speech_enhancement_tpu.data import native as jnative
from dl_speech_enhancement_tpu_torch.data import audio_io, collate, native


def _riff(fmt_tag: int, bits: int, sr: int, ch: int, payload: bytes, extensible=False,
          junk=b"") -> bytes:
    block = ch * bits // 8
    fmt = struct.pack("<HHIIHH", 0xFFFE if extensible else fmt_tag, ch, sr, sr * block,
                      block, bits)
    if extensible:  # cbSize, valid bits, channel mask, subformat GUID
        fmt += struct.pack("<HHI", 22, bits, 0) + struct.pack("<H", fmt_tag) + b"\x00" * 14
    body = b"fmt " + struct.pack("<I", len(fmt)) + fmt
    if junk:
        body += b"LIST" + struct.pack("<I", len(junk)) + junk + b"\x00" * (len(junk) & 1)
    body += b"data" + struct.pack("<I", len(payload)) + payload
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WAVE" + body


def _payloads(rng):
    x = np.clip(rng.standard_normal((301, 2)) * 0.4, -1.0, 0.999).astype(np.float32)
    i24 = np.clip(np.round(x * 8388608.0), -8388608, 8388607).astype(np.int32).reshape(-1)
    return {
        "pcm16": (1, 16, 2, np.round(x * 32767).astype("<i2").tobytes()),
        "pcm16-mono": (1, 16, 1, np.round(x[:, 0] * 32767).astype("<i2").tobytes()),
        "pcm24": (1, 24, 2, b"".join(int(v).to_bytes(3, "little", signed=True)
                                      for v in i24)),
        "pcm32": (1, 32, 2, np.round(x.astype(np.float64) * 2 ** 31 * 0.99)
                  .astype("<i4").tobytes()),
        "pcm8": (1, 8, 1, np.round(x[:, 0] * 127 + 128).astype(np.uint8).tobytes()),
        "float32": (3, 32, 2, x.astype("<f4").tobytes()),
        "float64": (3, 64, 1, x[:, 0].astype("<f8").tobytes()),
    }


def test_available():
    assert native.available()
    assert native.library_path().exists()


@pytest.mark.parametrize("fmt", ["pcm16", "pcm16-mono", "pcm24", "pcm32", "pcm8", "float32",
                                 "float64"])
@pytest.mark.parametrize("layout", ["plain", "extensible", "junk-chunk"])
def test_read_wav_bit_equal(tmp_path, rng, fmt, layout):
    tag, bits, ch, payload = _payloads(rng)[fmt]
    path = str(tmp_path / "x.wav")
    with open(path, "wb") as f:
        f.write(_riff(tag, bits, 16000, ch, payload, extensible=layout == "extensible",
                      junk=b"odd" if layout == "junk-chunk" else b""))
    got, sr = native.read_wav(path)
    plain, plain_sr = audio_io.read_wav_plain(path)
    want, want_sr = jnative.read_wav(path)
    assert sr == plain_sr == want_sr == 16000
    assert got.dtype == np.float32 and got.shape == plain.shape == want.shape
    assert np.array_equal(got, plain) and np.array_equal(got, want)
    assert np.array_equal(audio_io.read_wav(path)[0], got)


def test_unsupported_format_raises_in_both(tmp_path):
    path = str(tmp_path / "adpcm.wav")
    with open(path, "wb") as f:
        f.write(_riff(2, 4, 16000, 1, b"\x00" * 64))
    for read in (native.read_wav, audio_io.read_wav_plain, jnative.read_wav):
        with pytest.raises(ValueError):
            read(path)


@pytest.mark.parametrize("channels", [1, 2])
def test_write_wav_bit_equal(tmp_path, rng, channels):
    """Clipping and round-half-to-even at the PCM16 steps included."""
    x = (rng.standard_normal((999, channels)) * 0.6).astype(np.float32)
    x[:4, 0] = [1.5, -1.5, 0.5 / 32768, 1.5 / 32768]
    a, b, c = (str(tmp_path / f"{n}.wav") for n in "abc")
    assert native.write_wav(a, x if channels > 1 else x[:, 0], 24000)
    audio_io.write_wav_plain(b, x if channels > 1 else x[:, 0], 24000)
    assert jnative.write_wav(c, x, 24000)
    assert open(a, "rb").read() == open(b, "rb").read() == open(c, "rb").read()
    audio_io.write_wav(str(tmp_path / "d.wav"), x, 24000)
    assert open(str(tmp_path / "d.wav"), "rb").read() == open(c, "rb").read()


def test_crop_batch_bit_equal(rng):
    clips = [rng.standard_normal((int(n), 2)).astype(np.float32) for n in (900, 1300, 1000)]
    starts = np.asarray([5, 700, 0], np.int64)
    got = native.crop_batch(clips, starts, 300)
    want = np.stack([c[s:s + 300] for c, s in zip(clips, starts)])
    assert np.array_equal(got, want)
    assert np.array_equal(got, jnative.crop_batch(clips, starts, 300))
    # not 2-D float32 of one channel count: the caller crops with numpy
    assert native.crop_batch([c.astype(np.float64) for c in clips], starts, 300) is None
    assert native.crop_batch([clips[0], clips[1][:, :1]], starts[:2], 300) is None
    with pytest.raises(ValueError):
        native.crop_batch(clips, np.asarray([5, 1100, 0]), 300)


@pytest.mark.parametrize("pair", [False, True], ids=["single", "pair"])
def test_collater_batches_match_jax(rng, pair):
    clips = [rng.standard_normal((int(n), 1)).astype(np.float32)
             for n in rng.integers(200, 900, 9)]
    port_cls = collate.CollaterAudioPair if pair else collate.CollaterAudio
    jax_cls = jcollate.CollaterAudioPair if pair else jcollate.CollaterAudio
    port = port_cls(300, rng=np.random.default_rng(7))
    jax_c = jax_cls(300, rng=np.random.default_rng(7))
    batch = [(c, c * 0.5) for c in clips] if pair else clips
    for _ in range(3):
        got, want = port(batch), jax_c(batch)
        for g, w in zip(got if pair else [got], want if pair else [want]):
            assert g.dtype == w.dtype == np.float32 and np.array_equal(g, w)


def test_fallback_without_the_library(tmp_path, rng, monkeypatch):
    """Where the library is not available the plain versions run, with the
    same bits."""
    x = (rng.standard_normal((500, 1)) * 0.3).astype(np.float32)
    with_lib = str(tmp_path / "a.wav")
    audio_io.write_wav(with_lib, x, 16000)
    clips = [x, x[::-1].copy()]
    crop_lib = collate.CollaterAudio(100, rng=np.random.default_rng(1))(clips)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", True)
    assert not native.available()
    assert native.read_wav(with_lib) is None and native.crop_batch(clips, [0, 0], 10) is None
    without = str(tmp_path / "b.wav")
    audio_io.write_wav(without, x, 16000)
    assert open(with_lib, "rb").read() == open(without, "rb").read()
    assert np.array_equal(audio_io.read_wav(without)[0], audio_io.read_wav_plain(with_lib)[0])
    crop = collate.CollaterAudio(100, rng=np.random.default_rng(1))(clips)
    assert np.array_equal(crop, crop_lib)


def test_a_failed_build_leaves_the_plain_versions(tmp_path, monkeypatch):
    """A source that does not compile: ``available()`` is false, nothing is
    left in the build directory."""
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)
    assert not native.available()
    assert list((tmp_path / "build").iterdir()) == []
