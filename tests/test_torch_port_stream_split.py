"""The streamer's device split (``tx_device`` / ``rx_device``) and its
``calibrate_split`` timing, on the CPU against the fused streamer and the
JAX package.

``AudioCodecStreamer(tx_device="cpu", rx_device="cpu", fused=False)`` runs
the two-stage pipeline (tx thread, the codes crossing on the host, rx
thread) and is held to the fused streamer and to the JAX streamer with its
endpoints on two of the virtual CPU devices (JAX stream/runtime.py:586-596,
:624-641), on the frames each produced (the streamers' underflow zeros fall
where their threads' timing puts them): atol 2e-5, the JAX package's own at
small sizes. An endpoint on another device than its generator's gets a copy
of the generator there. ``calibrate_split=True`` splits each fused frame's
time by the encoder's share of separate encode and decode calls timed at
warm-up, so the two sides' means sum to the fused frame's.
"""

import numpy as np
import pytest

import jax
import torch

from dl_speech_enhancement_tpu.stream import runtime as jrt
from dl_speech_enhancement_tpu_torch.stream.runtime import AudioCodecStreamer
from dl_speech_enhancement_tpu_torch.utils.device import replica
from test_torch_port_audiodec import FRAME, SR, _produced
from test_torch_port_vocoder import CODEC_SMALL, _codecs, _jnp
from torch_port_threads import one_thread  # noqa: F401

ATOL = 2e-5
KW = dict(frame_size=FRAME, sample_rate=SR, max_latency=1e9)


@pytest.fixture(scope="module")
def codec():
    return _codecs(CODEC_SMALL, seed=60)


@pytest.mark.parametrize("batch", [1, 2])
def test_split_streamer_matches_the_fused_and_the_jax_split(rng, codec, batch):
    jc, cparams, cvq, tc, tvq = codec
    audio = rng.standard_normal((batch, 8 * FRAME, 1)).astype(np.float32) * 0.3
    split = AudioCodecStreamer(tc, tvq, batch=batch, fused=False, tx_device="cpu",
                               rx_device="cpu", device="cpu", **KW)
    fused = AudioCodecStreamer(tc, tvq, batch=batch, device="cpu", **KW)
    assert not split.fused and fused.fused
    assert split.tx_encoder.device == split.rx_encoder.device == torch.device("cpu")
    devices = jax.devices()
    jsplit = jrt.AudioCodecStreamer(jc, _jnp(cparams), _jnp(cvq), batch=batch,
                                    tx_device=devices[0], rx_device=devices[1], **KW)
    assert not jsplit.fused
    outs = []
    for streamer in (split, fused, jsplit):
        streamer.load()
        outs.append(_produced(streamer.run_array(audio), 8))
    np.testing.assert_allclose(outs[0], outs[1], atol=ATOL)
    np.testing.assert_allclose(outs[0], outs[2], atol=ATOL)
    stats = split.stats()
    assert stats["timing_mode"] == "per-side" and stats["frames"] == 8
    assert stats["frame_drops"] == 0


def test_fused_only_when_the_endpoints_share_a_device(codec):
    """The fused path needs tx_device == rx_device and no custom endpoints
    (JAX :634-635); the defaults are ``device``."""
    _, _, _, tc, tvq = codec
    assert AudioCodecStreamer(tc, tvq, device="cpu", tx_device="cpu", **KW).fused
    assert AudioCodecStreamer(tc, tvq, device="cpu", rx_device="cpu", **KW).fused
    streamer = AudioCodecStreamer(tc, tvq, device="cpu", fused=False, **KW)
    assert not streamer.fused and streamer.tx_encoder.gen is tc


def test_an_endpoint_elsewhere_gets_its_own_generator(codec):
    """``replica``: the generator itself where it lies on the device, else a
    copy moved there (here to the meta device, which holds no data)."""
    _, _, _, tc, _ = codec
    assert replica(tc, torch.device("cpu")) is tc
    moved = replica(tc, torch.device("meta"))
    assert moved is not tc and moved.device == torch.device("meta")
    assert tc.device == torch.device("cpu")


def test_calibrated_split_sums_to_the_frame_time(rng, codec):
    _, _, _, tc, tvq = codec
    audio = rng.standard_normal((1, 10 * FRAME, 1)).astype(np.float32) * 0.3
    streamer = AudioCodecStreamer(tc, tvq, device="cpu", calibrate_split=True, **KW)
    streamer.load()
    _produced(streamer.run_array(audio), 10)
    stats = streamer.stats()
    assert stats["timing_mode"] == "fused-calibrated-split"
    assert 0.0 < stats["enc_frac"] < 1.0 and stats["enc_frac"] != 0.5
    assert stats["encoder_ms_mean"] + stats["decoder_ms_mean"] == pytest.approx(
        stats["fused_ms_mean"], rel=1e-9)
    assert stats["encoder_ms_mean"] == pytest.approx(
        stats["enc_frac"] * stats["fused_ms_mean"], rel=1e-9)
    estimated = AudioCodecStreamer(tc, tvq, device="cpu", **KW)
    estimated.load()
    estimated.run_array(audio)
    assert estimated.stats()["timing_mode"] == "fused-estimated-split"
    assert estimated.stats()["enc_frac"] == 0.5
