"""The port's vctk_v1 pairing against the JAX package at full width, on the
CPU: the symAD codec of configs/autoencoder/symAD_vctk_48000_hop300.yaml
(PQC) as the transmitter and the AudioDec v1 receiver of
configs/vocoder/AudioDec_v1_symAD_vctk_48000_hop300_clean.yaml with seeded
statistics, through ``make_vocoder_scan_stream``, the joined halves (the
kernels' plain versions), ``VocoderReceiver`` and ``make_sharded_stream
(vocoder=)``. Params as in tests/test_torch_port_vocoder.py (numpy-drawn,
weight-norm ``g`` at about unit gain). f32 weights; tolerance 2e-4, the JAX
package's flagship tolerance; wire codes exact.
"""

import os

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from dl_speech_enhancement_tpu.stream import runtime as jrt
from dl_speech_enhancement_tpu_torch.ops.mega_kernel import join_halves, mega_encoder
from dl_speech_enhancement_tpu_torch.ops.vocoder_kernel import vocoder_half
from dl_speech_enhancement_tpu_torch.parallel import make_sharded_stream
from dl_speech_enhancement_tpu_torch.stream.runtime import (
    StreamingTransmitter,
    VocoderReceiver,
    make_vocoder_scan_stream,
)
from dl_speech_enhancement_tpu_torch.utils.config import load_config
from test_torch_port_vocoder import _codecs, _jnp, _seeded_stats, _vocoders
from torch_port_threads import one_thread  # noqa: F401

REPO = os.path.join(os.path.dirname(__file__), "..")
ATOL_FLAGSHIP = 2e-4


@pytest.fixture(scope="module")
def flagship():
    """The vctk_v1 pairing at full width: the symAD codec and the AudioDec v1
    receiver with seeded statistics, rescaled weight-norm gains."""
    cgp = load_config(os.path.join(REPO, "configs", "autoencoder",
                                   "symAD_vctk_48000_hop300.yaml"))["generator_params"]
    vgp = dict(load_config(os.path.join(
        REPO, "configs", "vocoder",
        "AudioDec_v1_symAD_vctk_48000_hop300_clean.yaml"))["generator_params"])
    for key in ("nonlinear_activation", "nonlinear_activation_params", "use_weight_norm",
                "stats"):
        vgp.pop(key)
    stats = _seeded_stats(np.random.default_rng(40), vgp["in_channels"])
    jc, cparams, cvq, tc, tvq = _codecs(cgp, seed=41)
    jv, vparams, tv = _vocoders(vgp, seed=42, stats=stats)
    return jc, cparams, cvq, tc, tvq, jv, vparams, tv


def _jax_codes(jc, cparams, cvq, frames):
    cache, codes = jc.init_cache(1), []
    for f in frames:
        z, ec = jc.encode_step(cparams, cache, jnp.asarray(f[None, :, None]))
        cache.update(ec)
        codes.append(np.asarray(jc.quantize(_jnp(cvq), z))[:, 0].T)
    return np.stack(codes)


def test_flagship_vocoder_scan_stream_matches_jax(rng, flagship):
    """Three 25 ms frames of the vctk_v1 pairing through JAX 'xla', the
    port's 'eager' route and its joined halves (the kernels' plain versions);
    the wire codes equal JAX's."""
    jc, cparams, cvq, tc, tvq, jv, vparams, tv = flagship
    frames = rng.standard_normal((3, 1200)).astype(np.float32) * 0.3
    jrun = jrt.make_vocoder_scan_stream(jc, _jnp(cparams), _jnp(cvq), jv, vparams, 1200,
                                        backend="xla")
    ref, _ = jrun(jrun.init_cache(), jnp.asarray(frames))
    ref = np.asarray(ref)
    assert 0.01 < ref.std() < 0.9  # neither near constant nor saturated
    run = make_vocoder_scan_stream(tc, tvq, tv, 1200, backend="eager", device="cpu")
    got, _ = run(run.init_cache(), torch.from_numpy(frames))
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL_FLAGSHIP)
    init, joined = join_halves(mega_encoder(tc, torch.float32, tvq),
                               vocoder_half(tv, torch.float32, tvq), 1, "cpu", 1200)
    first, cache, c1 = joined(init(), torch.from_numpy(frames[:1, None]))
    rest, _, c2 = joined(cache, torch.from_numpy(frames[1:, None]))
    np.testing.assert_allclose(torch.cat([first, rest])[:, 0].numpy(), ref, atol=ATOL_FLAGSHIP)
    np.testing.assert_array_equal(torch.cat([c1, c2])[:, 0].numpy(),
                                  _jax_codes(jc, cparams, cvq, frames))


def test_flagship_receiver_on_transmitter_codes(rng, flagship):
    """VocoderReceiver fed by StreamingTransmitter equals the scan stream."""
    _, _, _, tc, tvq, _, _, tv = flagship
    frames = rng.standard_normal((2, 1200)).astype(np.float32) * 0.3
    run = make_vocoder_scan_stream(tc, tvq, tv, 1200, backend="eager", device="cpu")
    ref, _ = run(run.init_cache(), torch.from_numpy(frames))
    tx = StreamingTransmitter(tc, tvq, device="cpu")
    rx = VocoderReceiver(tc, tv, tvq, device="cpu")
    got = torch.stack([rx.decode(tx.encode(torch.from_numpy(f)[None, :, None]))[0, :, 0]
                       for f in frames])
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=ATOL_FLAGSHIP)


def test_flagship_fleet_streams_equal_their_own_runs(rng, flagship):
    """make_sharded_stream(vocoder=) at B = 4: each stream equals its own
    single-stream run of the joined halves."""
    _, _, _, tc, tvq, _, _, tv = flagship
    batch = 4
    frames = rng.standard_normal((2, batch, 1200, 1)).astype(np.float32) * 0.3
    fleet = make_sharded_stream(tc, tvq, batch=batch, device="cpu", vocoder=tv)
    got, _ = fleet(fleet.init_cache(), fleet.shard_frames(frames))
    init, single = join_halves(mega_encoder(tc, torch.float32, tvq),
                               vocoder_half(tv, torch.float32, tvq), 1, "cpu", 1200)
    for b in range(batch):
        one, _, _ = single(init(), torch.from_numpy(frames[:, b:b + 1, :, 0]))
        np.testing.assert_allclose(got[:, b, :, 0].numpy(), one[:, 0].numpy(), atol=1e-6,
                                   err_msg=f"stream {b}")
