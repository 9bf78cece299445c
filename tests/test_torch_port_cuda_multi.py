"""The fleet, long-audio chunking and the streamer's device split over
several cards (parallel/serve.py, parallel/long_audio.py, stream/runtime.py).

Marked ``cuda``: they skip where fewer than two cards are visible, and run on
a machine with two or more:

    python -m pytest --noconftest tests/test_torch_port_cuda_multi.py -q

The flagship codec, denoiser and AudioDec v1 receiver at full width (random
weights from a seed), so kernels that take more than 48 KB of shared memory
launch on every card. A fleet's slice on card d runs the kernels the
one-card fleet runs, on the same inputs, so the fleet is held to it bit for
bit; so is the streamer with its receiver on a second card. The chunks of
``parallel_denoise`` run cuDNN at another batch size on each card, so they
are held to the one-card run at the flagship's 2e-4 (TF32 off).
"""

import os

import numpy as np
import pytest
import torch

from dl_speech_enhancement_tpu_torch.cli import serve as serve_cli
from dl_speech_enhancement_tpu_torch.data import load_audio, write_wav
from dl_speech_enhancement_tpu_torch.models import AudioDecGenerator
from dl_speech_enhancement_tpu_torch.models.hifigan import HiFiGANGenerator
from dl_speech_enhancement_tpu_torch.parallel import (
    make_mesh,
    make_sharded_stream,
    parallel_denoise,
)
from dl_speech_enhancement_tpu_torch.stream.runtime import AudioCodecStreamer
from dl_speech_enhancement_tpu_torch.train.checkpoint import save_checkpoint
from dl_speech_enhancement_tpu_torch.utils.config import load_config

pytestmark = pytest.mark.cuda
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CODEC_CONFIG = os.path.join(REPO, "configs", "autoencoder", "symAD_vctk_48000_hop300.yaml")
VOCODER_CONFIG = os.path.join(REPO, "configs", "vocoder",
                              "AudioDec_v1_symAD_vctk_48000_hop300_clean.yaml")
FRAME, SR = 1200, 48000
ATOL_CHUNKS = 2e-4


@pytest.fixture(scope="module")
def cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return make_mesh()


@pytest.fixture(scope="module")
def flagship(cards):
    """(codec, its VQState, denoiser, v1 receiver) on the first card."""
    gp = dict(load_config(CODEC_CONFIG)["generator_params"])
    codec = AudioDecGenerator(**gp, use_pqc=True, seed=0, device=cards[0])
    vq = codec.quantizer.init(seed=1, device=cards[0])
    denoiser = AudioDecGenerator(**gp, use_pqc=False, seed=2, device=cards[0])
    vp = dict(load_config(VOCODER_CONFIG)["generator_params"])
    vp["negative_slope"] = vp.pop("nonlinear_activation_params")["negative_slope"]
    for key in ("nonlinear_activation", "use_weight_norm", "stats"):
        vp.pop(key)
    rng = np.random.default_rng(3)
    stats = np.stack([rng.standard_normal(vp["in_channels"]),
                      rng.uniform(0.5, 2.0, vp["in_channels"])]).astype(np.float32)
    voc = HiFiGANGenerator(**vp, stats=stats, seed=4, device=cards[0])
    return codec, vq, denoiser, voc


def _frames(batch, n, seed):
    x = np.random.default_rng(seed).standard_normal((batch, n * FRAME, 1)) * 0.3
    return x.astype(np.float32).reshape(batch, n, FRAME, 1).transpose(1, 0, 2, 3).copy()


def _stream(run, frames, split=(4, 4)):
    cache, outs, i = run.init_cache(), [], 0
    for n in split:
        y, cache = run(cache, run.shard_frames(frames[i:i + n]))
        outs.append(y.cpu())
        i += n
    return torch.cat(outs)


@pytest.mark.parametrize("kind", ["denoiser", "codec", "vocoder"])
def test_fleet_over_the_cards_is_the_one_card_fleet(cards, flagship, kind):
    codec, vq, denoiser, voc = flagship
    gen, vq_state, rx = {"denoiser": (denoiser, None, {}), "codec": (codec, vq, {}),
                         "vocoder": (codec, vq, {"vocoder": voc})}[kind]
    batch = 2 * len(cards)
    frames = _frames(batch, 8, 5)
    one = make_sharded_stream(gen, vq_state, batch=batch, device=cards[0], **rx)
    fleet = make_sharded_stream(gen, vq_state, batch=batch, device=cards, **rx)
    assert fleet.devices == cards
    got = _stream(fleet, frames)
    assert torch.isfinite(got).all()
    assert torch.equal(got, _stream(one, frames))


def test_parallel_denoise_over_the_cards(cards, flagship):
    _, _, denoiser, _ = flagship
    audio = (np.random.default_rng(6).standard_normal((8 * SR, 1)) * 0.3).astype(np.float32)
    n_chunks = 2 * len(cards)
    one = parallel_denoise(denoiser, None, audio, n_chunks=n_chunks, device=cards[0])
    got = parallel_denoise(denoiser, None, audio, n_chunks=n_chunks, device=cards)
    with torch.no_grad():
        full = denoiser(torch.from_numpy(audio[None]).to(cards[0]), None,
                        train=False)[0][0].cpu().numpy()
    assert got.shape == one.shape
    np.testing.assert_allclose(got, one, atol=ATOL_CHUNKS)
    np.testing.assert_allclose(got, full[:len(got)], atol=ATOL_CHUNKS)


def _produced(out, n_frames):
    frames = [out[:, i * FRAME:(i + 1) * FRAME] for i in range(out.shape[1] // FRAME)]
    got = [f for f in frames if np.abs(f).max() > 0]
    assert len(got) == n_frames, f"{len(got)} frames produced of {n_frames}"
    return np.concatenate(got, axis=1)


def test_streamer_with_its_receiver_on_a_second_card(cards, flagship):
    codec, vq, _, _ = flagship
    audio = (np.random.default_rng(7).standard_normal((1, 8 * FRAME, 1)) * 0.3).astype(
        np.float32)
    kw = dict(frame_size=FRAME, sample_rate=SR, max_latency=1e9, fused=False)
    split = AudioCodecStreamer(codec, vq, tx_device=cards[0], rx_device=cards[1], **kw)
    assert split.rx_encoder.device == cards[1] and split.tx_encoder.device == cards[0]
    one = AudioCodecStreamer(codec, vq, device=cards[0], **kw)
    outs = []
    for streamer in (split, one):
        streamer.load()
        outs.append(_produced(streamer.run_array(audio), 8))
    np.testing.assert_array_equal(outs[0], outs[1])


def test_serve_cli_takes_every_card_by_default(cards, flagship, tmp_path, monkeypatch):
    """``cli.serve`` on a seeded checkpoint with no ``--devices``: one fleet
    slice a visible card, every stream's output (all play one input) the
    one-card fleet's."""
    codec, vq, _, _ = flagship
    monkeypatch.chdir(tmp_path)
    ckpt = "exp/autoencoder/symAD_vctk_48000_hop300/checkpoint-200000steps"
    config = {"sampling_rate": SR, "model_type": "symAudioDec", "train_mode": "autoencoder",
              "generator_params": load_config(CODEC_CONFIG)["generator_params"]}
    save_checkpoint(ckpt, {"params_generator": codec.state_dict(), "vq_state": vq}, config)
    streams = 2 * len(cards)
    write_wav("in.wav", np.random.default_rng(8).standard_normal(6 * FRAME) * 0.3, SR)
    clip = load_audio("in.wav", SR)[:, 0]
    stats = serve_cli.main(["--checkpoint", ckpt, "--streams", str(streams), "-i", "in.wav",
                            "-o", "out.wav", "--frame-size", str(FRAME), "--block-frames",
                            "2", "--max-outputs", str(streams)])
    assert stats["devices"] == len(cards) and stats["streams"] == streams
    assert stats["frames"] == 6 and stats["fleet_frame_ms"] > 0
    one = make_sharded_stream(codec, vq, batch=1, device=cards[0])
    want = _stream(one, clip.reshape(6, 1, FRAME, 1), (2, 2, 2))[:, 0, :, 0].reshape(-1)
    want = np.clip(want.numpy(), -1.0, 32767 / 32768)  # PCM16's range
    for b in range(streams):
        got = load_audio(f"out-{b}.wav", SR)[:, 0]
        np.testing.assert_allclose(got, want, atol=1.0 / 32768)
