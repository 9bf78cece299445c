"""The port's streaming entry point against the JAX package's.

``make_scan_stream(device="cpu")`` against JAX ``make_scan_stream(backend=
'xla')`` on the same params and frames (atol 2e-5, the JAX package's small-
topology tolerance), the routing table of ``resolve_scan_backend``, and what
the port refuses.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from conftest import SMALL_TOPOLOGY
from dl_speech_enhancement_tpu.models import AudioDecGenerator as JaxGenerator
from dl_speech_enhancement_tpu.stream.runtime import make_scan_stream as jax_scan
from dl_speech_enhancement_tpu.stream.runtime import (
    resolve_scan_backend as jax_resolve,
)
from dl_speech_enhancement_tpu_torch.models import AudioDecGenerator, HiFiGANGenerator
from dl_speech_enhancement_tpu_torch.parallel import make_sharded_stream
from dl_speech_enhancement_tpu_torch.stream.runtime import (
    make_scan_stream,
    resolve_scan_backend,
)
from dl_speech_enhancement_tpu_torch.utils.jax_params import from_jax_params
from torch_port_threads import one_thread  # noqa: F401

ATOL = 2e-5


@pytest.fixture(scope="module")
def pair():
    jgen = JaxGenerator(use_pqc=False, **SMALL_TOPOLOGY)
    params, _ = jgen.init(jax.random.PRNGKey(5))
    params = jax.tree_util.tree_map(np.asarray, params)
    tgen = from_jax_params(AudioDecGenerator(use_pqc=False, device="cpu", **SMALL_TOPOLOGY),
                           params)
    return jgen, params, tgen


def _frames(rng, n, chunk):
    return rng.standard_normal((n, 1, chunk, 1)).astype(np.float32) * 0.3


@pytest.mark.parametrize("backend", ["eager", "auto"])
@pytest.mark.parametrize("frame_size", [None, 600])
def test_scan_stream_matches_jax_xla(rng, pair, backend, frame_size):
    jgen, params, tgen = pair
    chunk = 600
    frames = _frames(rng, 4, chunk)
    jrun = jax_scan(jgen, params, backend="xla")
    ref, _ = jrun(jrun.init_cache(), jnp.asarray(frames))
    run = make_scan_stream(tgen, backend=backend, frame_size=frame_size, device="cpu")
    assert run.backend == "eager"
    got, _ = run(run.init_cache(), torch.from_numpy(frames))
    assert got.shape == frames.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_scan_stream_cache_continues_across_dispatches(rng, pair):
    jgen, params, tgen = pair
    frames = _frames(rng, 5, 300)
    jrun = jax_scan(jgen, params, backend="xla")
    ref, _ = jrun(jrun.init_cache(), jnp.asarray(frames))
    run = make_scan_stream(tgen, device="cpu")
    first, cache = run(run.init_cache(), torch.from_numpy(frames[:2]))
    second, _ = run(cache, torch.from_numpy(frames[2:]))
    np.testing.assert_allclose(torch.cat([first, second]).numpy(), np.asarray(ref),
                               atol=ATOL)


@pytest.mark.parametrize("backend,on_cuda,batch,expected", [
    ("auto", True, 1, "cuda"),
    ("auto", False, 1, "eager"),
    ("auto", True, 4, "cuda"),
    ("auto", False, 4, "eager"),
    ("cuda", False, 1, "cuda"),
    ("cuda_chain", True, 1, "cuda_chain"),
    ("eager", True, 1, "eager"),
])
def test_resolve_scan_backend(backend, on_cuda, batch, expected):
    assert resolve_scan_backend(backend, on_cuda=on_cuda, batch=batch,
                                use_pqc=False) == expected


def test_resolve_scan_backend_mirrors_jax_auto():
    """The JAX router's choice, except for B > 1 on the card: the JAX router
    takes XLA there (a TPU v5e measurement), the port its batched kernels."""
    names = {"cuda": "pallas", "eager": "xla"}
    for on_acc in (True, False):
        for batch in (1, 8):
            got = resolve_scan_backend("auto", on_cuda=on_acc, batch=batch, use_pqc=False)
            want = jax_resolve("auto", on_accelerator=on_acc, batch=batch, use_pqc=False)
            if on_acc and batch > 1:
                assert (got, want) == ("cuda", "xla")
            else:
                assert names[got] == want


def test_resolve_scan_backend_rejects_unknown():
    with pytest.raises(ValueError, match="unknown backend"):
        resolve_scan_backend("pallas", on_cuda=True, batch=1, use_pqc=False)


@pytest.mark.parametrize("backend", ["cuda", "cuda_chain"])
def test_cuda_routes_refuse_the_cpu(pair, backend):
    _, _, tgen = pair
    with pytest.raises(ValueError, match="CUDA kernels"):
        make_scan_stream(tgen, backend=backend, frame_size=600, device="cpu")


def test_later_slices_raise_not_implemented(pair):
    _, _, tgen = pair
    # multi-stream and the vocoder receiver are served (tests/
    # test_torch_port_batched.py, test_torch_port_vocoder.py, and K4's
    # MultiReceptiveField arm, test_torch_port_vocoder_mrf.py); a grouped
    # MultiReceptiveField block is not on the kernel route; a fleet over
    # several devices is served (tests/test_torch_port_serve.py) where the
    # streams divide over them
    mrf = HiFiGANGenerator(in_channels=512, channels=32, upsample_scales=(5, 5, 4, 3),
                           upsample_kernel_sizes=(10, 10, 8, 6), groups=2, device="cpu")
    with pytest.raises(ValueError, match="MultiReceptiveField"):
        make_sharded_stream(tgen, batch=2, device="cpu", vocoder=mrf)
    with pytest.raises(ValueError, match="divide over 2 devices"):
        make_sharded_stream(tgen, batch=3, device=["cpu", "cpu"])
    # the PQC codec is served (tests/test_torch_port_pqc.py); the denoiser
    # refuses a VQ state
    with pytest.raises(ValueError, match="VQState"):
        make_scan_stream(tgen, vq_state=object(), device="cpu")


def test_generator_and_stream_devices_must_agree(pair):
    _, _, tgen = pair
    with pytest.raises(ValueError, match="generator is on"):
        make_scan_stream(tgen, device="meta")


def test_frames_layout_is_checked(pair):
    _, _, tgen = pair
    run = make_scan_stream(tgen, device="cpu")
    with pytest.raises(ValueError, match=r"\(N, 1, F, C\)"):
        run(run.init_cache(), torch.zeros(2, 300, 1))


def test_default_device_raises_without_a_card(pair):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, _, tgen = pair
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_scan_stream(tgen)
