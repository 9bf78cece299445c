"""ctypes binding of the native host library: wav decode and encode, and the
batched random crop.

The port's own binding of the repository's ``native/dlse_native.cpp``
(counterpart of dl_speech_enhancement_tpu/data/native.py). At first use
``g++`` compiles that source into the package's ``_build/`` directory (listed
in ``.gitignore``), named by a hash of the source and the flags, so an edited
source is rebuilt and an unchanged one loaded as it is. The build is
serialised by a lock within a process (two loader threads must not both
compile, nor one see the library half built) and lands by an atomic rename
across processes.

Where the library cannot be built or loaded, :func:`available` is false and
the wrappers return None: ``data/audio_io.py``'s Python reader and writer
and ``data/collate.py``'s numpy crop are the plain versions, and give the
same bits.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import tempfile
import threading

import numpy as np

PACKAGE = pathlib.Path(__file__).resolve().parent.parent
SOURCE = PACKAGE.parent / "native" / "dlse_native.cpp"
BUILD_DIR = PACKAGE / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")

_LIB = None
_TRIED = False
_LOCK = threading.Lock()
_FLOAT_P = ctypes.POINTER(ctypes.c_float)


def library_path() -> pathlib.Path:
    """Where the library of the present source and flags is built."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libdlse_native-{digest[:16]}.so"


def _build(out: pathlib.Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, str(SOURCE)],
                       capture_output=True, timeout=120, check=True)
        os.replace(tmp, out)  # another process may have built it too: same bits
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _bind(path: pathlib.Path):
    lib = ctypes.CDLL(str(path))
    lib.dlse_read_wav.restype = ctypes.c_int
    lib.dlse_read_wav.argtypes = [ctypes.c_char_p, ctypes.POINTER(_FLOAT_P),
                                  ctypes.POINTER(ctypes.c_int64),
                                  ctypes.POINTER(ctypes.c_int32),
                                  ctypes.POINTER(ctypes.c_int32)]
    lib.dlse_free.argtypes = [_FLOAT_P]
    lib.dlse_write_wav.restype = ctypes.c_int
    lib.dlse_write_wav.argtypes = [ctypes.c_char_p, _FLOAT_P, ctypes.c_int64,
                                   ctypes.c_int32, ctypes.c_int32]
    lib.dlse_crop_batch.argtypes = [ctypes.POINTER(_FLOAT_P), ctypes.POINTER(ctypes.c_int64),
                                    ctypes.c_int32, ctypes.c_int64, ctypes.c_int32, _FLOAT_P]
    return lib


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    with _LOCK:
        if not _TRIED:
            try:
                path = library_path()
                if not path.exists():
                    _build(path)
                _LIB = _bind(path)
            except (OSError, subprocess.SubprocessError):
                _LIB = None
            _TRIED = True
    return _LIB


def available() -> bool:
    """Whether the library is built and loaded (building it at first call)."""
    return _load() is not None


def read_wav(path: str):
    """Native decode of a PCM 8/16/24/32-bit or float32/64 wav (extensible
    headers too) -> ``((T, C) float32, sample_rate)``; None where the library
    is not available. Raises ValueError where the file cannot be decoded."""
    lib = _load()
    if lib is None:
        return None
    data = _FLOAT_P()
    frames, channels, sr = ctypes.c_int64(), ctypes.c_int32(), ctypes.c_int32()
    rc = lib.dlse_read_wav(os.fsencode(path), ctypes.byref(data), ctypes.byref(frames),
                           ctypes.byref(channels), ctypes.byref(sr))
    if rc != 0:
        raise ValueError(f"native wav decode failed ({rc}): {path}")
    n = frames.value * channels.value
    try:
        out = np.ctypeslib.as_array(data, shape=(n,)).copy() if n else np.zeros(0, np.float32)
    finally:
        lib.dlse_free(data)
    return out.reshape(frames.value, channels.value), sr.value


def write_wav(path: str, audio: np.ndarray, sample_rate: int) -> bool:
    """Native PCM16 encode of float32 ``(T,)`` or ``(T, C)`` audio (round half
    to even); False where the library is not available or the write failed."""
    lib = _load()
    if lib is None:
        return False
    a = np.ascontiguousarray(audio, np.float32)
    if a.ndim == 1:
        a = a[:, None]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    rc = lib.dlse_write_wav(os.fsencode(path), a.ctypes.data_as(_FLOAT_P), a.shape[0],
                            a.shape[1], sample_rate)
    return rc == 0


def crop_batch(clips: list, starts, crop_len: int):
    """``(B, crop_len, C)`` float32 from the ``(T_i, C)`` float32 ``clips`` at
    ``starts``; None where the library is not available or a clip is not
    2-D float32 of the first's channel count (the caller crops with numpy)."""
    lib = _load()
    if lib is None or not clips:
        return None
    ch = clips[0].shape[1:] if clips[0].ndim == 2 else None
    if ch is None or any(c.ndim != 2 or c.dtype != np.float32 or c.shape[1:] != ch
                         for c in clips):
        return None
    starts = np.ascontiguousarray(starts, np.int64)
    if any(s < 0 or s + crop_len > len(c) for c, s in zip(clips, starts)):
        raise ValueError("a crop runs past the end of its clip")
    clips = [np.ascontiguousarray(c) for c in clips]
    ptrs = (_FLOAT_P * len(clips))(*[c.ctypes.data_as(_FLOAT_P) for c in clips])
    out = np.empty((len(clips), crop_len, ch[0]), np.float32)
    lib.dlse_crop_batch(ptrs, starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                        len(clips), crop_len, ch[0], out.ctypes.data_as(_FLOAT_P))
    return out
