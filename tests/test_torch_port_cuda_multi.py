"""The fleet, long-audio chunking and the streamer's device split over
several cards (parallel/serve.py, parallel/long_audio.py, stream/runtime.py),
and training over them (parallel/mesh.py, parallel/time_shard.py).

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

Training: the course step over every card (NCCL ranks, one card each)
against one card, ``cli.train --dp -1`` taking every card, and the
time-sharded step of the full PQC codec on (data 2, time 2) against the
blocked objective on one card; the ranks' cases are tests/torch_port_ranks.py's.
Losses rtol 2e-4 (time shards 1e-4), the codebooks atol 1e-5, the parameters
atol 5e-5 (time shards 3e-5) where their gradient is above 1e-4 of its
tensor's largest and within 2 lr elsewhere (Adam's first step at a gradient
near its rounding floor; the CLI run holds all but one in a thousand
elements a tensor so, having no gradients to read).
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


# ---------------------------------------------------------------- training

COURSE_CONFIG = os.path.join(REPO, "configs", "denoise", "symAD_48MelWaveL1.yaml")
LR = 1e-3  # tests/torch_port_ranks.py's Adam



def _harmonics(rng, b, n, sr=SR):
    t = np.arange(n) / sr
    f0 = rng.uniform(100.0, 250.0, (b, 1))
    clean = sum(0.3 / h * np.sin(2 * np.pi * h * f0 * t) for h in (1, 2, 3, 4))
    return (clean + 3e-4 * rng.standard_normal(clean.shape))[..., None].astype(np.float32)


def test_course_step_over_every_card(cards, tmp_path, monkeypatch):
    """The course's ``train_disc`` step at its config's widths and batch (16
    x 48000) over every card (NCCL), against the step on one card."""
    from torch_port_ranks import held_by_gradient, run_here, run_ranks

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    cfg = load_config(COURSE_CONFIG)
    rng = np.random.default_rng(0)
    clean = _harmonics(rng, 16, 48000)
    mixed = (clean + 0.05 * rng.standard_normal(clean.shape)).astype(np.float32)
    kw = {"gen_kw": cfg["generator_params"], "gen_params": None,
          "disc_kw": cfg["discriminator_params"], "disc_params": None, "config": cfg,
          "mixed": mixed, "clean": clean, "arm": "train_disc"}
    ranks = run_ranks(len(cards), {"step": ("course_step", kw)}, tmp_path,
                      devices=[str(c) for c in cards])
    one = run_here("course_step", device=cards[0], **kw)
    for got in (r["step"] for r in ranks):
        assert got["launches"]["log_mel"] > 0
        np.testing.assert_allclose(got["g"], one["g"], rtol=2e-4)
        np.testing.assert_allclose(got["d"], one["d"], rtol=2e-4)
        held_by_gradient(got["gen"], one["gen"], one["grads"], 5e-5)
    for k in ranks[0]["step"]["disc"]:  # every rank took the same discriminator step
        assert all(np.array_equal(r["step"]["disc"][k], ranks[0]["step"]["disc"][k])
                   for r in ranks), k


TINY = {"input_channels": 1, "output_channels": 1, "encode_channels": 8, "decode_channels": 8,
        "code_dim": 16, "codebook_num": 2, "codebook_size": 32, "bias": True,
        "enc_ratios": [2, 4], "dec_ratios": [4, 2], "enc_strides": [3, 4],
        "dec_strides": [4, 3], "mode": "causal", "codec": "audiodec", "projector": "conv1d",
        "quantier": "residual_vq"}

TINY_DISC = {"scales": 2, "scale_downsample_pooling": "AvgPool1d",
             "scale_downsample_pooling_params": {"kernel_size": 4, "stride": 2, "padding": 2},
             "scale_discriminator_params": {"kernel_sizes": [15, 41, 5, 3], "channels": 8,
                                            "max_downsample_channels": 32, "max_groups": 4,
                                            "downsample_scales": [2, 2, 1]},
             "follow_official_norm": True, "periods": [2, 3],
             "period_discriminator_params": {"kernel_sizes": [5, 3], "channels": 4,
                                             "downsample_scales": [3, 3, 1],
                                             "max_downsample_channels": 16}}


def test_train_cli_dp_takes_every_card(cards, tmp_path, monkeypatch):
    """``cli.train --dp -1`` on a tiny codec and a seeded 4.8 kHz corpus: one
    rank a card, and the checkpoint rank 0 writes is the ``--dp 1`` run's
    (the codebooks atol 1e-5)."""
    import yaml

    from dl_speech_enhancement_tpu_torch.cli import train as train_cli
    from dl_speech_enhancement_tpu_torch.train.checkpoint import load_checkpoint

    monkeypatch.chdir(tmp_path)
    # the ranks are fresh processes, where cuDNN's convolutions would run in
    # TF32: the CUDA libraries' own switch turns it off for them too
    monkeypatch.setenv("NVIDIA_TF32_OVERRIDE", "0")
    rng = np.random.default_rng(11)
    for sub in ("clean_train", "clean_valid"):
        os.makedirs(f"corpus/{sub}")
        for i in range(2 * len(cards) + 2):
            x = 0.4 * np.sin(2 * np.pi * (200 + 50 * i) * np.arange(5760) / 4800)
            write_wav(f"corpus/{sub}/utt{i}.wav", x.astype(np.float32), 4800)
    mel = {"fs": 4800, "fft_sizes": [256], "hop_sizes": [60], "win_lengths": [None],
           "window": "hann_window", "num_mels": 20, "fmin": 0, "fmax": 2400, "log_base": None}
    cfg = {"sampling_rate": 4800, "data": {"path": "corpus", "subset": {
        "clean_train": "clean_train", "clean_valid": "clean_valid"}},
        "model_type": "symAudioDec", "train_mode": "autoencoder", "generator_params": TINY,
        "discriminator_params": TINY_DISC, "use_mel_loss": True,
        "mel_loss_params": mel, "use_feat_match_loss": True, "lambda_adv": 1.0,
        "lambda_feat_match": 2.0, "lambda_vq_loss": 1.0, "lambda_mel_loss": 45.0,
        "generator_adv_loss_params": {"average_by_discriminators": False},
        "discriminator_adv_loss_params": {"average_by_discriminators": False},
        "batch_size": 2 * len(cards), "batch_length": 2400,
        "generator_optimizer_params": {"lr": LR, "betas": [0.5, 0.9]},
        "discriminator_optimizer_params": {"lr": LR, "betas": [0.5, 0.9]},
        "start_steps": {"generator": 0, "discriminator": 1}, "train_max_steps": 2,
        "save_interval_steps": 10 ** 9, "eval_interval_steps": 10 ** 9,
        "log_interval_steps": 10 ** 9, "seed": 5}
    with open("ae.yaml", "w") as f:
        yaml.safe_dump(cfg, f)
    # both runs resume a codec whose codebooks are scaled to its projector's
    # output: at the init's N(0, 1) books every frame takes one codeword and
    # the encoder's gradient sits at f32's rounding floor
    # (tests/test_torch_port_cli_train.py::_spread_codec)
    gen = AudioDecGenerator(**TINY, use_pqc=True, seed=cfg["seed"], device="cpu")
    vq = gen.quantizer.init(seed=cfg["seed"], device="cpu")
    clip = load_audio("corpus/clean_train/utt0.wav").reshape(1, -1, 1).astype(np.float32)
    with torch.no_grad():
        scale = gen.projector(gen.encoder(torch.from_numpy(clip))).std()
    save_checkpoint("spread/checkpoint-0steps", {
        "params_generator": gen.state_dict(), "steps": 0, "epochs": 0,
        "vq_state": type(vq)(vq.embed * scale, vq.cluster_size, vq.embed_avg * scale)})
    argv = ["-c", "ae.yaml", "--resume", "spread/checkpoint-0steps"]
    one = train_cli.main([*argv, "--tag", "one", "--dp", "1"])
    ranks = train_cli.main([*argv, "--tag", "all", "--dp", "-1"])
    assert len(ranks) == len(cards) and all(r["steps"] == 2 for r in ranks)
    assert one.steps == 2
    got = load_checkpoint("exp/autoencoder/all/checkpoint-2steps")
    ref = load_checkpoint("exp/autoencoder/one/checkpoint-2steps")
    assert sorted(got) == sorted(ref)
    for key in ("params_generator", "params_discriminator"):
        for k in ref[key]:
            diff = (got[key][k] - ref[key][k]).abs()
            share = float((diff > 5e-5).float().mean())
            assert diff.max() <= 2 * LR * 2 * (1 + 1e-3), f"{key}.{k}: {float(diff.max())}"
            assert share <= 1e-3, f"{key}.{k}: {share} of the elements beyond 5e-5"
    for k in ref["vq_state"]:
        np.testing.assert_allclose(got["vq_state"][k].numpy(), ref["vq_state"][k].numpy(),
                                   atol=1e-5, err_msg=k)


def test_time_sharded_step_on_data2_time2(cards, tmp_path, monkeypatch):
    """The full PQC codec (8 books of 1024) on (data 2, time 2), B = 4, 640
    hops a shard: the blocked objective's step on one card."""
    from dl_speech_enhancement_tpu_torch.nn.vq import VQState
    from dl_speech_enhancement_tpu_torch.parallel.time_shard import blocked_reference_step
    from dl_speech_enhancement_tpu_torch.train.optim import build_optimizer
    from torch_port_ranks import held_by_gradient, run_ranks

    if len(cards) < 4:
        pytest.skip("needs four cards")
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    gp = load_config(CODEC_CONFIG)["generator_params"]
    config = {"mel_loss_params": load_config(CODEC_CONFIG)["mel_loss_params"],
              "lambda_mel_loss": 45.0, "lambda_snr_loss": 1.0, "lambda_vq_loss": 1.0}
    rng = np.random.default_rng(3)
    gen = AudioDecGenerator(**gp, use_pqc=True, seed=0, device=cards[0])
    x = _harmonics(rng, 4, 2 * 640 * gen.hop)
    target = x + (0.01 * rng.standard_normal(x.shape)).astype(np.float32)
    with torch.no_grad():
        scale = float(gen.projector(gen.encoder(torch.from_numpy(x[:1]).to(cards[0]))).std())
    books = scale * rng.standard_normal((8, gp["code_dim"], 1024)).astype(np.float32)
    vq = (books, np.zeros((8, 1024), np.float32), books.copy())
    kw = {"gen_kw": gp, "gen_params": None, "vq": vq, "use_pqc": True, "shape": (2, 2),
          "config": config, "clips": [(x, target)], "opt": {"kind": "adam"}}
    got = run_ranks(4, {"shard": ("time_train", kw)}, tmp_path,
                    devices=[str(c) for c in cards[:4]])[0]["shard"]
    opt = build_optimizer(gen.parameters(), "Adam", {"lr": LR, "betas": [0.5, 0.9]})
    state = VQState(*(torch.from_numpy(a).to(cards[0]) for a in vq))
    new, loss = blocked_reference_step(gen, config, opt, 2)(
        state, torch.from_numpy(x).to(cards[0]), torch.from_numpy(target).to(cards[0]))
    assert got["launches"]["log_mel"] > 0
    np.testing.assert_allclose(got["losses"][0], float(loss), rtol=1e-4)
    held_by_gradient(got["params"][0], {k: v.detach().cpu().numpy()
                                         for k, v in gen.state_dict().items()},
                      {n: p.grad.cpu().numpy() for n, p in gen.named_parameters()}, 3e-5)
    for f in ("embed", "cluster_size"):
        np.testing.assert_allclose(got["vq"][0][f], getattr(new, f).cpu().numpy(), atol=1e-5)
