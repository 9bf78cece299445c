"""Build the port's CUDA kernels with ``nvcc`` and bind them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles, at first use, into its own shared library
with a plain C interface (``nvcc -gencode arch=compute_90a,code=sm_90a -O3
-shared -Xcompiler -fPIC``). Libraries land in ``_build/`` inside the package
(listed in ``.gitignore``), named by a hash of the sources and flags, so an
edited kernel is rebuilt and an unchanged one is loaded as it is.
:func:`build` compiles several sources at once, one ``nvcc`` process each.

Nothing here runs at import time: the CPU tests import every module of the
port on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

PACKAGE = pathlib.Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "_build"
SOURCES = ("residual_chain", "causal_conv", "causal_conv_transpose", "rvq_assign",
           "codebook_lookup", "hifigan_unit", "dft_spectrum", "fold_copy")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L, _Z, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_size_t,
                      ctypes.c_float)
# C entry points: name -> (argtypes, restype). The layer kernels take (cache,
# cache stream stride, x, ...) and the stream count B; residual_chain a
# device scratch after its output, and its (tile, cluster) plan; each takes a
# `types` word where the others took the weight type (bit 0 bf16 weights, then a
# bit for bf16 activations: x and out, for causal_conv x then out;
# ops/stream_kernel.py::act_types); the boundary convs an
# activation code and slope (and causal_conv a tanh flag) before the weight type,
# causal_conv its (arm, tile, steps per block) plan after it, causal_conv_transpose
# its (tile, steps per block);
# rvq_assign the books in both layouts and its (cluster, tile, clusters, stages)
# plan, then a `types` word for z; codebook_lookup its bad-code word, the call's
# number and a `types` word for its output (bit 0 clear: the books are f32);
# hifigan_unit an optional running sum and an output scale after its biases,
# and its (tile, cluster) plan;
# the DFT kernels the padded signal and its frames' geometry (signal stride, hop,
# frames per signal, rows, n_fft) before the bases (GEMM arm) or the window, its
# nonzero range and the twiddles (FFT arm; K6's then the mel band table).
_ENTRIES = {
    "residual_chain": {
        "dse_residual_chain": ([_P, _L, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                _P], _I),
        "dse_residual_chain_smem": ([_I, _I, _I, _I, _I, _I, _I], _Z),
        "dse_residual_chain_scratch": ([_I, _I, _I, _I, _I, _I, _I], _Z),
    },
    "causal_conv": {
        "dse_causal_conv": ([_P, _L, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I,
                             _I, _I, _I, _I, _P], _I),
        "dse_causal_conv_smem": ([_I, _I, _I, _I, _I, _I, _I, _I, _I, _I], _Z),
    },
    "causal_conv_transpose": {
        "dse_causal_conv_transpose": ([_P, _L, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F,
                                       _I, _I, _I, _P], _I),
        "dse_causal_conv_transpose_smem": ([_I, _I, _I, _I, _I, _I], _Z),
    },
    "rvq_assign": {
        "dse_rvq_assign": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P], _I),
        "dse_rvq_assign_smem": ([_I, _I, _I, _I, _I], _Z),
        "dse_rvq_assign_max_clusters": ([_I, _I, _I, _I, _I, _I, _I, _P], _I),
        "dse_rvq_assign_threads": ([_I, _I, _I], _I),
    },
    "codebook_lookup": {
        "dse_codebook_lookup": ([_P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _P], _I),
        "dse_mapped_word_alloc": ([_P, _P], _I),
        "dse_mapped_word_free": ([_P], _I),
    },
    "hifigan_unit": {
        "dse_hifigan_unit": ([_P, _L, _P, _L, _P, _P, _P, _P, _P, _P, _F, _P, _P, _I, _I, _I,
                              _I, _I, _I, _I, _I, _I, _F, _I, _P], _I),
        "dse_hifigan_unit_smem": ([_I, _I, _I, _I, _I, _I], _Z),
    },
    "dft_spectrum": {
        "dse_log_mel": ([_P, _L, _I, _I, _I, _I, _P, _P, _I, _P, _I, _F, _I, _P, _P], _I),
        "dse_stft_magnitude": ([_P, _L, _I, _I, _I, _I, _P, _P, _I, _I, _F, _P, _P], _I),
        "dse_log_mel_fft": ([_P, _L, _I, _I, _I, _I, _P, _I, _I, _P, _P, _P, _I, _F, _I, _P,
                             _P], _I),
        "dse_stft_magnitude_fft": ([_P, _L, _I, _I, _I, _I, _P, _I, _I, _P, _I, _F, _P, _P], _I),
    },
    "fold_copy": {
        "dse_fold_copy": ([_P, _P, _I, _I, _I, _I, _P], _I),
    },
}

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates += ["/usr/local/cuda/bin/nvcc", shutil.which("nvcc")]
    for path in candidates:
        if path and os.path.isfile(path):
            return path
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built with the "
                       "CUDA toolkit on the machine that has the card")


def _lib_path(name: str) -> pathlib.Path:
    digest = hashlib.sha256()
    digest.update(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        digest.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict:
    """Compile the named sources that have no library yet, all at once.

    Returns ``{name: {"seconds": s, "log": ptxas output}}`` for the sources it
    compiled. Raises RuntimeError with the compiler's output if one fails."""
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        tmp = BUILD_DIR / f"{name}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, time.perf_counter(),
                       subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True))
    report, failed = {}, []
    for name, (tmp, start, proc) in procs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - start
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, _lib_path(name))
        report[name] = {"seconds": seconds, "log": log}
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The bound library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        for fn, (argtypes, restype) in _ENTRIES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        lib.dse_error_string.argtypes = [_I]
        lib.dse_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = lib.dse_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def launch(lib: ctypes.CDLL, entry: str, what: str, tensor, *args) -> None:
    """Call ``lib``'s C entry point ``entry`` with ``args`` and PyTorch's
    current stream on ``tensor``'s card, with that card the current device
    for the call (made so for the call where another is): a launch goes to
    the calling thread's current device, and the kernels' attributes are
    set there. Raises as :func:`check`."""
    import torch

    fn, stream = getattr(lib, entry), torch.cuda.current_stream(tensor.device).cuda_stream
    if tensor.get_device() == torch.cuda.current_device():
        err = fn(*args, stream)
    else:
        with torch.cuda.device(tensor.device):
            err = fn(*args, stream)
    check(lib, err, what)
