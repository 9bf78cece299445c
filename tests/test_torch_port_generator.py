"""The PyTorch port's without-PQC AudioDec generator against the JAX package.

JAX params from ``gen.init(PRNGKey)`` are carried into the port's modules by
``from_jax_params``; inputs come from numpy. Tolerances: atol 2e-5 at the
small topology and 2e-4 at the flagship, the JAX package's own for its
streaming kernels (tests/test_mega_kernel.py).
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from conftest import SMALL_TOPOLOGY
from dl_speech_enhancement_tpu.models import AudioDecGenerator as JaxGenerator
from dl_speech_enhancement_tpu.utils.config import load_config as jax_load_config
from dl_speech_enhancement_tpu_torch.models import AudioDecGenerator
from dl_speech_enhancement_tpu_torch.utils.config import load_config
from dl_speech_enhancement_tpu_torch.utils.jax_params import from_jax_params
from torch_port_threads import one_thread  # noqa: F401

FLAGSHIP_CONFIG = os.path.join(os.path.dirname(__file__), "..", "configs", "denoise",
                               "symAD_vctk_48000_hop300.yaml")
ATOL_SMALL = 2e-5
ATOL_FLAGSHIP = 2e-4


def _pair(seed=0, **topology):
    jgen = JaxGenerator(use_pqc=False, **topology)
    params, _ = jgen.init(jax.random.PRNGKey(seed))
    params = jax.tree_util.tree_map(np.asarray, params)
    tgen = from_jax_params(AudioDecGenerator(use_pqc=False, device="cpu", **topology),
                           params)
    return jgen, params, tgen


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _stream_both(jgen, params, tgen, frames):
    jc, tc = jgen.init_cache(1), tgen.init_cache(1)
    jys, tys = [], []
    for x in frames:
        x = x[None, :, None]
        z, ec = jgen.encode_step(params, jc, jnp.asarray(x))
        jc.update(ec)
        y, dc = jgen.decode_step(params, jc, z)
        jc.update(dc)
        jys.append(np.asarray(y)[0, :, 0])
        with torch.no_grad():
            tz, tec = tgen.encode_step(tc, torch.from_numpy(x))
            tc.update(tec)
            ty, tdc = tgen.decode_step(tc, tz)
            tc.update(tdc)
        tys.append(ty.numpy()[0, :, 0])
    return np.stack(jys), np.stack(tys), jc, tc


def test_offline_matches_jax(rng):
    jgen, params, tgen = _pair(**SMALL_TOPOLOGY)
    x = rng.standard_normal((2, jgen.hop * 5, 1)).astype(np.float32) * 0.3
    ref = jgen(params, None, jnp.asarray(x))
    with torch.no_grad():
        got = tgen(torch.from_numpy(x))
    for r, g in zip(ref[:5], got[:5]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=ATOL_SMALL)
    assert got[5] is None


def test_streaming_matches_jax_frame_by_frame(rng):
    jgen, params, tgen = _pair(seed=1, **SMALL_TOPOLOGY)
    frames = rng.standard_normal((4, jgen.hop * 3)).astype(np.float32) * 0.3
    jys, tys, jc, tc = _stream_both(jgen, params, tgen, frames)
    np.testing.assert_allclose(tys, jys, atol=ATOL_SMALL)
    # the carried caches agree leaf for leaf (same nested structure)
    for a, b in zip(_leaves(tc), _leaves(jc), strict=True):
        np.testing.assert_allclose(a, b, atol=ATOL_SMALL)


def test_encoder_streaming_matches_offline(rng):
    """The encoder has no replication pad, so chunked streaming from zero
    caches equals the offline pass."""
    _, _, tgen = _pair(seed=2, **SMALL_TOPOLOGY)
    x = rng.standard_normal((1, tgen.hop * 6, 1)).astype(np.float32) * 0.3
    cache, outs = tgen.init_cache(1), []
    with torch.no_grad():
        offline = tgen.encoder(torch.from_numpy(x)).numpy()
        for chunk in np.split(x, 3, axis=1):
            z, ec = tgen.encode_step(cache, torch.from_numpy(chunk))
            cache.update(ec)
            outs.append(z.numpy())
    np.testing.assert_allclose(np.concatenate(outs, axis=1), offline, atol=ATOL_SMALL)


def test_flagship_streaming_matches_jax(rng):
    """Two 25 ms frames through the full-width denoiser."""
    jgen, params, tgen = _pair(seed=2)
    frames = rng.standard_normal((2, 1200)).astype(np.float32) * 0.3
    jys, tys, _, _ = _stream_both(jgen, params, tgen, frames)
    np.testing.assert_allclose(tys, jys, atol=ATOL_FLAGSHIP)


def test_receptive_length():
    flagship = AudioDecGenerator(use_pqc=False, device="cpu")
    assert flagship.receptive_length == 6609
    assert flagship.hop == 300
    small = AudioDecGenerator(use_pqc=False, device="cpu", **SMALL_TOPOLOGY)
    assert small.receptive_length == JaxGenerator(use_pqc=False,
                                                  **SMALL_TOPOLOGY).receptive_length


def test_prime_matches_jax(rng):
    jgen, params, tgen = _pair(seed=3, **SMALL_TOPOLOGY)
    jcache = jgen.prime(params, None)
    with torch.no_grad():
        tcache = tgen.prime()
    for a, b in zip(_leaves(tcache), _leaves(jcache), strict=True):
        np.testing.assert_allclose(a, b, atol=ATOL_SMALL)
    # a primed stream continues like the JAX one
    x = rng.standard_normal((1, jgen.hop * 2, 1)).astype(np.float32) * 0.3
    z, ec = jgen.encode_step(params, jcache, jnp.asarray(x))
    jcache.update(ec)
    jy, _ = jgen.decode_step(params, jcache, z)
    with torch.no_grad():
        tz, tec = tgen.encode_step(tcache, torch.from_numpy(x))
        tcache.update(tec)
        ty, _ = tgen.decode_step(tcache, tz)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL_SMALL)


def test_pqc_is_a_later_slice():
    """The PQC codec is served now (tests/test_torch_port_pqc.py holds it to
    the JAX package): the default generator is the codec, with a projector
    and a quantizer, and the denoiser refuses a VQ state."""
    codec = AudioDecGenerator(device="cpu", **SMALL_TOPOLOGY)
    assert codec.use_pqc and codec.decoder.use_input_conv
    assert codec.projector.conv.out_channels == SMALL_TOPOLOGY["code_dim"]
    assert codec.quantizer.codebook_num == SMALL_TOPOLOGY["codebook_num"]
    gen = AudioDecGenerator(use_pqc=False, device="cpu", **SMALL_TOPOLOGY)
    assert not hasattr(gen, "projector") and not gen.decoder.use_input_conv
    with pytest.raises(ValueError, match="without-PQC"):
        gen.prime(vq_state=codec.quantizer.init(seed=0, device="cpu"))


def test_flagship_from_config_matches_jax_layout():
    cfg = load_config(FLAGSHIP_CONFIG)
    assert cfg == jax_load_config(FLAGSHIP_CONFIG)
    gp = cfg["generator_params"]
    gen = AudioDecGenerator(**gp, use_pqc=False, device="cpu")
    jgen = JaxGenerator(**gp, use_pqc=False)
    params, _ = jgen.init(jax.random.PRNGKey(0))
    n_jax = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(params))
    assert sum(p.numel() for p in gen.parameters()) == n_jax
    assert 7_500_000 < n_jax < 7_700_000
    enc_channels = [b.conv.out_channels for b in gen.encoder.blocks]
    assert enc_channels == [64, 128, 256, 512]
    assert [b.conv.stride for b in gen.encoder.blocks] == [3, 4, 5, 5]


def test_seeded_init_is_reproducible():
    a = AudioDecGenerator(use_pqc=False, device="cpu", seed=7, **SMALL_TOPOLOGY)
    b = AudioDecGenerator(use_pqc=False, device="cpu", seed=7, **SMALL_TOPOLOGY)
    c = AudioDecGenerator(use_pqc=False, device="cpu", seed=8, **SMALL_TOPOLOGY)
    for pa, pb, pc in zip(a.parameters(), b.parameters(), c.parameters()):
        assert torch.equal(pa, pb)
    assert not all(torch.equal(pa, pc) for pa, pc in zip(a.parameters(), c.parameters()))


def test_from_jax_params_rejects_a_mismatch():
    jgen = JaxGenerator(use_pqc=False, **SMALL_TOPOLOGY)
    params, _ = jgen.init(jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.asarray, params)
    wider = dict(SMALL_TOPOLOGY, encode_channels=16)
    with pytest.raises(ValueError, match="does not fit"):
        from_jax_params(AudioDecGenerator(use_pqc=False, device="cpu", **wider), params)


def test_cuda_default_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AudioDecGenerator(use_pqc=False, **SMALL_TOPOLOGY)
