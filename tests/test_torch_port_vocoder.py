"""The port's vocoder receiver path against the JAX package, on the CPU, at
small topologies.

The port's ``make_mega_vocoder`` / ``make_stacked_vocoder`` (the kernels'
plain versions run here) against the JAX package's K4 / K5 in interpret
mode and against ``voc.step``; ``make_vocoder_scan_stream``,
``VocoderReceiver`` and ``make_sharded_stream(vocoder=)`` against the JAX
entry points (the full-width ``vctk_v1`` pairing is
tests/test_torch_port_vocoder_v1.py). Params: drawn with numpy in the JAX
``init``'s tree (tests/test_torch_port_hifigan.py::seeded_init), weight-norm
``g`` rescaled to about unit gain (``rescaled``), carried across. Weights
f32. Tolerances: atol 2e-5 (tests/test_vocoder_kernel.py), 3e-5 for K5
(tests/test_vocoder_stacked.py).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dl_speech_enhancement_tpu.models import AudioDecGenerator as JaxCodec
from dl_speech_enhancement_tpu.models import HiFiGANGenerator as JaxVocoder
from dl_speech_enhancement_tpu.ops.vocoder_kernel import make_mega_vocoder as jax_mega_vocoder
from dl_speech_enhancement_tpu.ops.vocoder_stacked import (
    make_stacked_vocoder as jax_stacked_vocoder,
)
from dl_speech_enhancement_tpu.parallel import make_mesh
from dl_speech_enhancement_tpu.parallel import make_sharded_stream as jax_sharded
from dl_speech_enhancement_tpu.stream import runtime as jrt
from dl_speech_enhancement_tpu_torch.models import AudioDecGenerator, HiFiGANGenerator
from dl_speech_enhancement_tpu_torch.nn.vq import VQState
from dl_speech_enhancement_tpu_torch.ops.mega_kernel import join_halves, mega_encoder
from dl_speech_enhancement_tpu_torch.ops.vocoder_kernel import (
    make_mega_vocoder,
    vocoder_half,
    vocoder_topology_error,
)
from dl_speech_enhancement_tpu_torch.ops.vocoder_stacked import make_stacked_vocoder
from dl_speech_enhancement_tpu_torch.parallel import make_sharded_stream
from dl_speech_enhancement_tpu_torch.stream.runtime import (
    VocoderReceiver,
    make_vocoder_scan_stream,
)
from dl_speech_enhancement_tpu_torch.utils.jax_params import (
    from_jax_params,
    vocoder_from_jax_params,
    vq_state_from_jax,
)
from test_torch_port_hifigan import MGC, MRF, rescaled, seeded_init
from torch_port_threads import one_thread  # noqa: F401

ATOL_SMALL = 2e-5
ATOL_STACKED = 3e-5
CODEC_SMALL = dict(encode_channels=8, decode_channels=8, code_dim=16, codebook_num=3,
                   codebook_size=32, enc_ratios=(2, 4), dec_ratios=(4, 2), enc_strides=(3, 4),
                   dec_strides=(4, 3))
VOC_PAIRED = dict(in_channels=16, channels=16, upsample_scales=(4, 3),
                  upsample_kernel_sizes=(8, 6), resblock_kernel_sizes=(3,),
                  resblock_dilations=((1, 2),), groups=2)


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _vocoders(topology, seed, stats=None):
    """(JAX vocoder, its rescaled params as jnp, the port's vocoder)."""
    jv = JaxVocoder(**topology, stats=stats)
    p = rescaled(seeded_init(jv, seed), seed=seed + 100)
    return jv, _jnp(p), vocoder_from_jax_params(
        HiFiGANGenerator(**topology, stats=stats, device="cpu"), p)


def _codecs(topology, seed):
    """(JAX codec, params, VQState as numpy, the port's codec, its VQState)."""
    jc = JaxCodec(use_pqc=True, **topology)
    params, vq = seeded_init(jc, seed)
    tc = from_jax_params(AudioDecGenerator(use_pqc=True, device="cpu", **topology), params)
    return jc, params, vq, tc, vq_state_from_jax(vq, tc)


def _jax_voc_stream(jv, p, xs):
    """The JAX per-frame ``voc.step`` on one stream: xs (n, rows, C) -> (n, chunk)."""
    cache, outs = jv.init_cache(1), []
    for x in xs:
        y, cache = jv.step(p, cache, jnp.asarray(x[None]))
        outs.append(np.asarray(y)[0, :, 0])
    return np.stack(outs)


def _seeded_stats(rng, dim):
    return np.stack([rng.standard_normal(dim), rng.uniform(0.5, 2.0, dim)]).astype(np.float32)


# ---------------------------------------------------------------- K4 / K5


@pytest.mark.parametrize("wire", ["features", "stats", "codes"])
def test_mega_vocoder_matches_jax_interpret(rng, wire):
    """tests/test_vocoder_kernel.py: 4 frames of 3 code rows, in two
    dispatches with the cache carried, through the port's single-stream
    builder, JAX ``voc.step`` and the JAX K4 (interpret mode).

    With statistics the port is held to ``voc.step`` only: K4 folds them
    into the input conv but starts its cache at raw zeros, which stand for
    ``-mean / scale`` once normalised where ``voc.step``'s cache holds
    zeros, so at stream start K4 departs from ``voc.step`` (by 0.31 here,
    at unit-gain weights; the JAX package's own test passes at the official
    init, whose small gains hide it). The port starts that cache at the
    mean."""
    stats = _seeded_stats(rng, 8) if wire == "stats" else None
    jv, p, tv = _vocoders(MGC, seed=20, stats=stats)
    chunk = 3 * jv.total_upsample
    if wire == "codes":
        embed = rng.standard_normal((2, 8, 12)).astype(np.float32)
        x = (rng.integers(0, 12, (4, 3, 2)) + np.arange(2) * 12).astype(np.int32)
        zq = np.stack([embed[l].T[x[..., l] - l * 12] for l in range(2)]).sum(0)
        tvq = VQState(torch.from_numpy(embed), torch.zeros(2, 12), torch.from_numpy(embed))
    else:
        embed, tvq = None, None
        x = zq = rng.standard_normal((4, 3, 8)).astype(np.float32)
    jinit, jrun = jax_mega_vocoder(jv, p, chunk, weight_dtype=jnp.float32, interpret=True,
                                   vq_embed=None if embed is None else jnp.asarray(embed))
    ref, _ = jrun(jinit(), jnp.asarray(x))
    steps = _jax_voc_stream(jv, p, zq)
    init, run = make_mega_vocoder(tv, chunk, torch.float32, tvq)
    first, cache = run(init(), torch.from_numpy(x[:2]))
    second, _ = run(cache, torch.from_numpy(x[2:]))
    got = torch.cat([first, second]).numpy()
    assert got.shape == (4, chunk)
    np.testing.assert_allclose(got, steps, atol=ATOL_SMALL)
    if stats is None:
        np.testing.assert_allclose(got, np.asarray(ref), atol=ATOL_SMALL)
    else:
        assert np.abs(np.asarray(ref) - steps).max() > 1e-2


def test_stacked_vocoder_matches_jax_interpret(rng):
    """tests/test_vocoder_stacked.py:37-52's topology: three streams, two
    frames in two dispatches with the cache carried, through the JAX K5
    (interpret mode) and the port's multi-stream builder, each stream held
    on its own."""
    topology = dict(in_channels=12, out_channels=1, channels=32, kernel_size=7,
                    upsample_scales=(5, 4, 3), upsample_kernel_sizes=(10, 8, 6),
                    resblock_kernel_sizes=(5,), resblock_dilations=((1, 3),), groups=3)
    jv, p, tv = _vocoders(topology, seed=21)
    batch, chunk = 3, 2 * jv.total_upsample
    zs = rng.standard_normal((2, batch, 2, 12)).astype(np.float32) * 0.5
    jinit, jrun = jax_stacked_vocoder(jv, p, chunk, batch=batch, weight_dtype=jnp.float32,
                                      interpret=True)
    ref = np.asarray(jrun(jinit(), jnp.asarray(zs))[0])
    init, run = make_stacked_vocoder(tv, chunk, batch, torch.float32)
    first, cache = run(init(), torch.from_numpy(zs[:1]))
    rest, _ = run(cache, torch.from_numpy(zs[1:]))
    got = torch.cat([first, rest]).numpy()
    assert got.shape == ref.shape == (2, batch, chunk)
    for b in range(batch):
        np.testing.assert_allclose(got[:, b], ref[:, b], atol=ATOL_STACKED,
                                   err_msg=f"stream {b}")


def test_vocoder_topology_error_names_what_the_route_cannot_run():
    _, _, _, codec, vq = _codecs(CODEC_SMALL, seed=0)
    paired_mrf = dict(MRF, in_channels=16, upsample_scales=(4, 3), upsample_kernel_sizes=(8, 6))
    # an ungrouped MultiReceptiveField receiver (v0/v3) is on the route; a
    # grouped one is not
    mrf = HiFiGANGenerator(**dict(paired_mrf, groups=2), device="cpu")
    assert vocoder_topology_error(HiFiGANGenerator(**paired_mrf, device="cpu"), 12,
                                  hop=codec.hop) is None
    off_hop = HiFiGANGenerator(**dict(VOC_PAIRED, upsample_scales=(2, 3),
                                      upsample_kernel_sizes=(4, 6)), device="cpu")
    good = HiFiGANGenerator(**VOC_PAIRED, device="cpu")
    assert "MultiReceptiveField" in vocoder_topology_error(mrf, 12)
    assert "hop 12" in vocoder_topology_error(off_hop, 12, hop=codec.hop)
    assert "multiple" in vocoder_topology_error(good, 18)
    assert vocoder_topology_error(good, 24, hop=codec.hop) is None
    for voc, reason in ((mrf, "MultiReceptiveField"), (off_hop, "hop 12")):
        with pytest.raises(ValueError, match=reason):
            make_vocoder_scan_stream(codec, vq, voc, 24, backend="cuda", device="cpu")
        with pytest.raises(ValueError, match=reason):
            VocoderReceiver(codec, voc, vq, backend="cuda", device="cpu")
        with pytest.raises(ValueError, match=reason):
            make_sharded_stream(codec, vq, batch=2, device="cpu", vocoder=voc)
    with pytest.raises(ValueError, match="MultiReceptiveField"):
        vocoder_half(mrf)
    # the plain modules run any topology when asked for
    run = make_vocoder_scan_stream(codec, vq, mrf, 24, backend="eager", device="cpu")
    assert run(run.init_cache(), torch.zeros(2, 24))[0].shape == (2, 24)
    with pytest.raises(ValueError, match="CUDA kernels"):
        make_vocoder_scan_stream(codec, vq, good, 24, backend="cuda", device="cpu")
    with pytest.raises(ValueError, match="multiple of the codec's hop"):
        make_vocoder_scan_stream(codec, vq, good, 25, device="cpu")


# ---------------------------------------------------------------- paired, small


@pytest.fixture(scope="module")
def paired():
    jc, cparams, cvq, tc, tvq = _codecs(CODEC_SMALL, seed=30)
    jv, vparams, tv = _vocoders(VOC_PAIRED, seed=31)
    return jc, cparams, cvq, tc, tvq, jv, vparams, tv


def test_vocoder_scan_stream_matches_jax(rng, paired):
    """tests/test_vocoder_kernel.py:157-188: the paired chain (PQC tx ->
    wire codes -> vocoder rx) through JAX 'xla' and the port's 'eager' and
    'auto' (the CPU's eager) routes, and through the joined halves."""
    jc, cparams, cvq, tc, tvq, jv, vparams, tv = paired
    frame = 2 * jc.hop
    frames = rng.standard_normal((5, frame)).astype(np.float32) * 0.3
    jrun = jrt.make_vocoder_scan_stream(jc, _jnp(cparams), _jnp(cvq), jv, vparams, frame,
                                        backend="xla")
    ref, _ = jrun(jrun.init_cache(), jnp.asarray(frames))
    for backend in ("eager", "auto"):
        run = make_vocoder_scan_stream(tc, tvq, tv, frame, backend=backend, device="cpu")
        assert run.backend == "eager"
        first, cache = run(run.init_cache(), torch.from_numpy(frames[:2]))
        rest, _ = run(cache, torch.from_numpy(frames[2:]))
        np.testing.assert_allclose(torch.cat([first, rest]).numpy(), np.asarray(ref),
                                   atol=ATOL_SMALL)
    init, joined = join_halves(mega_encoder(tc, torch.float32, tvq),
                               vocoder_half(tv, torch.float32, tvq), 1, "cpu", frame)
    out, _, codes = joined(init(), torch.from_numpy(frames[:, None]))
    np.testing.assert_allclose(out[:, 0].numpy(), np.asarray(ref), atol=ATOL_SMALL)
    assert codes.dtype == torch.int32 and tuple(codes.shape) == (5, 1, 2, 3)


def test_vocoder_receiver_matches_jax(rng, paired):
    """tests/test_vocoder_kernel.py:191-231: a long priming chunk then
    steady frames of wire codes share one cache."""
    jc, _, cvq, tc, tvq, jv, vparams, tv = paired
    jrx = jrt.VocoderReceiver(jc, jv, vparams, _jnp(cvq), batch=2)
    trx = VocoderReceiver(tc, tv, tvq, batch=2, device="cpu")
    assert trx.backend == "eager"
    for t in (5, 2, 2):
        idx = (rng.integers(0, 32, (3, 2, t)) + np.arange(3)[:, None, None] * 32).astype(np.int32)
        want = np.asarray(jrx.decode(jnp.asarray(idx)))
        got = trx.decode(torch.from_numpy(idx))
        assert tuple(got.shape) == (2, t * 12, 1)
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL_SMALL)
    with pytest.raises(ValueError, match="outside its book"):
        trx.decode(torch.zeros(3, 2, 1, dtype=torch.int32))
    trx.reset_buffer()
    assert all(float(t.abs().max()) == 0 for t in jax.tree_util.tree_leaves(
        trx.cache, is_leaf=lambda x: isinstance(x, torch.Tensor)))


def test_sharded_stream_vocoder_matches_jax_on_one_device(rng, paired):
    """tests/test_parallel.py's paired fleet on a one-device mesh: the codec's
    tx, the codes looked up in the tx books, the vocoder rx."""
    jc, cparams, cvq, tc, tvq, jv, vparams, tv = paired
    batch, frame = 4, 2 * jc.hop
    x = rng.standard_normal((batch, frame * 3, 1)).astype(np.float32) * 0.3
    frames = x.reshape(batch, 3, frame, 1).transpose(1, 0, 2, 3).copy()
    jrun = jax_sharded(jc, cparams, _jnp(cvq), mesh=make_mesh(1), batch=batch, vocoder=jv,
                       vocoder_params=vparams)
    ref, _ = jrun(jrun.init_cache(), jrun.shard_frames(frames))
    run = make_sharded_stream(tc, tvq, batch=batch, device="cpu", vocoder=tv)
    got, cache = run(run.init_cache(), run.shard_frames(frames[:1]))
    rest, _ = run(cache, run.shard_frames(frames[1:]))
    np.testing.assert_allclose(torch.cat([got, rest]).numpy(), np.asarray(ref),
                               atol=ATOL_SMALL)
