"""Long audio in parallel chunks (parallel/long_audio.py) on the CPU, against
the full forward and the JAX package.

After JAX tests/test_parallel.py:180 and :204: the small generator without
and with PQC, audio of ``context + chunks x core`` samples, each chunk's core
region (and chunk 0's context region) held to one long ``gen.forward`` at
atol 1e-5 (the same convolutions over other batch shapes: the plain route's
sums differ by float32 rounding; measured 2.2e-8 without PQC, 7.5e-8 with),
the chunks in one batch or
split over a device list (bit for bit the same). The port's
``parallel_denoise`` against JAX ``parallel_denoise`` (on a mesh of the
virtual CPU devices) at 2e-5, the JAX package's tolerance at small sizes.
"""

import copy

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dl_speech_enhancement_tpu.parallel import make_mesh as jax_mesh
from dl_speech_enhancement_tpu.parallel.long_audio import parallel_denoise as jax_denoise
from dl_speech_enhancement_tpu_torch.parallel import parallel_denoise, parallel_forward
from test_torch_port_serve import DENOISER
from test_torch_port_vocoder import CODEC_SMALL, _codecs
from torch_port_threads import one_thread  # noqa: F401

ATOL_SERIAL = 1e-5
ATOL_JAX = 2e-5


@pytest.fixture(scope="module")
def generators():
    """(JAX generator, params, VQState, the port's generator, its VQState)
    without and with PQC."""
    from dl_speech_enhancement_tpu.models import AudioDecGenerator as JaxGenerator
    from dl_speech_enhancement_tpu_torch.models import AudioDecGenerator
    from dl_speech_enhancement_tpu_torch.utils.jax_params import from_jax_params
    from test_torch_port_hifigan import seeded_init

    jd = JaxGenerator(use_pqc=False, **DENOISER)
    params = seeded_init(jd, 50)[0]
    td = from_jax_params(AudioDecGenerator(use_pqc=False, device="cpu", **DENOISER), params)
    return {False: (jd, params, None, td, None), True: _codecs(CODEC_SMALL, seed=51)}


def _serial(gen, vq, audio):
    with torch.no_grad():
        return gen(torch.from_numpy(audio[None]), vq, train=False)[0][0].numpy()


@pytest.mark.parametrize("use_pqc,frames_a_chunk,n_chunks", [(False, 40, 8), (True, 30, 4)])
def test_core_regions_equal_the_full_forward(rng, generators, use_pqc, frames_a_chunk,
                                             n_chunks):
    _, _, _, gen, vq = generators[use_pqc]
    hop = gen.hop
    audio = rng.standard_normal((hop * 64 + hop * frames_a_chunk * n_chunks, 1)).astype(
        np.float32) * 0.3
    serial = _serial(gen, vq, audio)
    got = parallel_denoise(gen, vq, audio, n_chunks=n_chunks, context=hop * 64, device="cpu")
    assert got.shape == serial.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, serial, atol=ATOL_SERIAL)
    split = parallel_denoise(gen, vq, audio, n_chunks=n_chunks, context=hop * 64,
                             device=["cpu", "cpu"])
    np.testing.assert_array_equal(split, got)


@pytest.mark.parametrize("use_pqc", [False, True])
def test_parallel_denoise_matches_jax(rng, generators, use_pqc):
    jgen, params, jvq, gen, vq = generators[use_pqc]
    hop = gen.hop
    audio = rng.standard_normal((hop * 64 + hop * 20 * 4, 1)).astype(np.float32) * 0.3
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    ref = jax_denoise(jgen, jparams, None if jvq is None else jax.tree_util.tree_map(
        jnp.asarray, jvq), audio, n_chunks=4, context=hop * 64, mesh=jax_mesh(4))
    got = parallel_denoise(gen, vq, audio, n_chunks=4, context=hop * 64, device=["cpu"] * 4)
    assert got.shape == np.asarray(ref).shape
    np.testing.assert_allclose(got, np.asarray(ref), atol=ATOL_JAX)


@pytest.mark.parametrize("use_pqc", [False, True])
def test_default_context_gives_the_full_forward(rng, generators, use_pqc):
    """With no ``context`` given, the chunks' core regions equal the full
    forward: the default is the whole model's receptive field
    (``gen.model_receptive_length``), not the encoder's."""
    _, _, _, gen, vq = generators[use_pqc]
    hop = gen.hop
    assert gen.model_receptive_length > gen.receptive_length
    context = -(-gen.model_receptive_length // hop) * hop
    audio = rng.standard_normal((context + hop * 30 * 4, 1)).astype(np.float32) * 0.3
    got = parallel_denoise(gen, vq, audio, n_chunks=4, device="cpu")
    assert got.shape == audio.shape
    np.testing.assert_allclose(got, _serial(gen, vq, audio), atol=ATOL_SERIAL)


def test_model_receptive_length_bounds_the_reach(generators):
    """Over the phases of an output sample q within the hop, the first input
    sample q depends on (the first nonzero of its gradient: the input
    samples outside its receptive field get an exact 0) is at least q -
    ``model_receptive_length`` + 1, and at one phase exactly there (f64, the
    small denoiser)."""
    _, _, _, gen, _ = generators[False]
    g = copy.deepcopy(gen).double()
    hop, reach = g.hop, g.model_receptive_length
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((1, 3 * reach, 1)) * 0.3)
    x.requires_grad_(True)
    y = g(x, None, train=False)[0][0, :, 0]
    spans = []
    for q in range(2 * reach, 2 * reach + hop):
        (grad,) = torch.autograd.grad(y[q], x, retain_graph=True)
        spans.append(q - int(torch.nonzero(grad[0, :, 0]).min()) + 1)
    assert max(spans) == reach


def test_chunking_contract(rng, generators):
    """The JAX ``assert core > 0`` as a ValueError; context rounded up to the
    hop; chunks that do not divide over the devices raise; the defaults are
    one chunk a device and the whole model's receptive field."""
    _, _, _, gen, _ = generators[False]
    hop = gen.hop
    audio = rng.standard_normal((hop * 10, 1)).astype(np.float32)
    with pytest.raises(ValueError, match="too short"):
        parallel_denoise(gen, None, audio, n_chunks=4, context=hop * 8, device="cpu")
    with pytest.raises(ValueError, match="divide over 2 devices"):
        parallel_denoise(gen, None, audio, n_chunks=3, context=hop, device=["cpu", "cpu"])
    seen = []

    def forward(x):
        seen.append(tuple(x.shape))
        return x * 2

    y = parallel_forward(forward, audio, hop, hop + 1, 2, devices=["cpu", "cpu"])
    # context hop + 1 -> 2 hops; core (10 - 2) // 2 hops = 4 hops a chunk
    assert seen == [(1, 6 * hop, 1), (1, 6 * hop, 1)]
    np.testing.assert_array_equal(y, 2 * audio[:10 * hop])
    long = rng.standard_normal((gen.model_receptive_length + hop * 4, 1)).astype(np.float32)
    context = -(-gen.model_receptive_length // hop) * hop
    core = (long.shape[0] - context) // hop * hop
    assert parallel_denoise(gen, None, long, device="cpu").shape[0] == context + core
