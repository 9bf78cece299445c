"""AudioDec facade and the named model zoo.

Counterpart of dl_speech_enhancement_tpu/utils/audiodec.py (reference
utils/audiodec.py:17-164): ``assign_model``'s preset table mapping model
names to experiment checkpoints and sample rates, loaders that build the
transmitter and receiver of a preset from checkpoints with their
``config.yml`` beside them (train/checkpoint.py's format), and the
``AudioDec`` facade. The port's generators hold their weights, so where the
JAX loaders return ``(gen, params, vq_state, ...)`` these return ``(gen,
vq_state, ...)``. Everything is built on ``device`` (the card by default).
"""

from __future__ import annotations

import os

from dl_speech_enhancement_tpu_torch.models import AudioDecGenerator
from dl_speech_enhancement_tpu_torch.stream.runtime import (
    AudioCodec,
    AudioCodecStreamer,
    StreamingReceiver,
    StreamingTransmitter,
    VocoderReceiver,
)
from dl_speech_enhancement_tpu_torch.train.checkpoint import load_checkpoint
from dl_speech_enhancement_tpu_torch.utils.config import load_config_beside
from dl_speech_enhancement_tpu_torch.utils.model_factory import build_generator


def assign_model(model: str, exp_root: str = "exp"):
    """Named presets -> (sample_rate, tx checkpoint, rx checkpoint), the
    reference's table (utils/audiodec.py:106-164). The vocoder presets pair
    an autoencoder analyzer (tx) with a vocoder generator (rx)."""
    def ae(tag, steps=200000):
        return os.path.join(exp_root, "autoencoder", tag, f"checkpoint-{steps}steps")

    def voc(tag, steps=500000):
        return os.path.join(exp_root, "vocoder", tag, f"checkpoint-{steps}steps")

    def dn(tag, steps=200000):
        return os.path.join(exp_root, "denoise", tag, f"checkpoint-{steps}steps")

    presets = {
        "libritts_v1": (24000, ae("symAD_libritts_24000_hop300", 500000),
                        voc("AudioDec_v1_symAD_libritts_24000_hop300_clean")),
        "libritts_sym": (24000, ae("symAD_libritts_24000_hop300", 500000),
                         ae("symAD_libritts_24000_hop300", 500000)),
        "vctk_v0": (48000, ae("symAD_vctk_48000_hop300"),
                    voc("AudioDec_v0_symAD_vctk_48000_hop300_clean")),
        "vctk_v1": (48000, ae("symAD_vctk_48000_hop300"),
                    voc("AudioDec_v1_symAD_vctk_48000_hop300_clean")),
        "vctk_v2": (48000, ae("symAD_vctk_48000_hop300"),
                    voc("AudioDec_v2_symAD_vctk_48000_hop300_clean")),
        "vctk_sym": (48000, ae("symAD_vctk_48000_hop300", 500000),
                     ae("symAD_vctk_48000_hop300", 500000)),
        "vctk_univ": (48000, ae("symADuniv_vctk_48000_hop300", 500000),
                      voc("AudioDec_v3_symADuniv_vctk_48000_hop300_clean")),
        "vctk_univ_sym": (48000, ae("symADuniv_vctk_48000_hop300", 500000),
                          ae("symADuniv_vctk_48000_hop300", 500000)),
        # the reference pairs the fine-tuned denoise tx with the AudioDec_v1
        # vocoder rx (utils/audiodec.py:144-149), decoding the tx's indices
        # in the tx's books
        "vctk_denoise": (48000, dn("symAD_vctk_48000_hop300"),
                         voc("AudioDec_v1_symAD_vctk_48000_hop300_clean")),
    }
    presets["vctk_v3"] = presets["vctk_univ"]  # the earlier rounds' name of vctk_univ
    if model not in presets:
        raise NotImplementedError(f"Model {model} is not supported!")
    return presets[model]


def load_generator_from_checkpoint(checkpoint: str, use_pqc: bool = True, device="cuda"):
    """An ``AudioDecGenerator`` with its ``VQState`` (None without PQC)
    restored from ``checkpoint``, and the ``config.yml`` beside it: ``(gen,
    vq_state, config)``."""
    config = load_config_beside(checkpoint)
    gen = AudioDecGenerator(**config["generator_params"], use_pqc=use_pqc, device=device)
    like = {"params_generator": gen.state_dict()}
    if use_pqc:
        like["vq_state"] = gen.quantizer.init(device=gen.device)  # shapes and dtypes only
    restored = load_checkpoint(checkpoint, like=like)
    gen.load_state_dict(restored["params_generator"])
    return gen, restored.get("vq_state"), config


def load_pair_models(model: str, exp_root: str = "exp", device="cuda") -> dict:
    """The models behind a named preset pair: ``sample_rate``, the tx codec
    (``gen``, ``vq_state``) and, for an asymmetric preset, the receiver:
    ``vocoder`` (v0-v3 and the denoise preset) or ``rx_gen`` /
    ``rx_vq_state`` (an rx checkpoint that names a codec). The receiver keys
    are ``parallel.serve.make_sharded_stream``'s keyword arguments."""
    sample_rate, tx_ckpt, rx_ckpt = assign_model(model, exp_root)
    gen, vq_state, _ = load_generator_from_checkpoint(tx_ckpt, device=device)
    out = {"sample_rate": sample_rate, "gen": gen, "vq_state": vq_state}
    if rx_ckpt == tx_ckpt:
        return out
    rx_config = load_config_beside(rx_ckpt)
    if rx_config.get("train_mode") == "vocoder":
        voc = build_generator(rx_config["model_type"], rx_config["generator_params"],
                              device=device)
        restored = load_checkpoint(rx_ckpt, like={"params_generator": voc.state_dict()})
        voc.load_state_dict(restored["params_generator"])
        out["vocoder"] = voc
        return out
    rx_gen, rx_vq, _ = load_generator_from_checkpoint(rx_ckpt, device=device)
    out.update(rx_gen=rx_gen, rx_vq_state=rx_vq)
    return out


def load_pair(model: str, exp_root: str = "exp", batch: int = 1, rx_backend: str = "auto",
              device="cuda"):
    """The tx/rx endpoints of a named preset: a symmetric preset pairs the
    codec with itself; the v0-v3 presets pair the symAD analyzer (tx) with a
    HiFiGAN vocoder (rx), utils/audiodec.py:32-57. ``rx_backend`` is the
    receiver's route (``'auto'``: its kernels on the card, raising where
    they cannot run; ``'cuda'``; ``'eager'``: the plain modules); the
    transmitter takes ``'auto'``. Returns ``(transmitter, receiver,
    sample_rate)``."""
    pair = load_pair_models(model, exp_root, device)
    gen, vq_state = pair["gen"], pair["vq_state"]
    tx = StreamingTransmitter(gen, vq_state, batch=batch, device=device)
    if "vocoder" in pair:
        rx = VocoderReceiver(gen, pair["vocoder"], vq_state, batch=batch, backend=rx_backend,
                             device=device)
    elif "rx_gen" in pair:
        rx = StreamingReceiver(pair["rx_gen"], pair["rx_vq_state"], batch=batch,
                               backend=rx_backend, device=device)
    else:
        rx = StreamingReceiver(gen, vq_state, batch=batch, backend=rx_backend, device=device)
    return tx, rx, pair["sample_rate"]


class AudioDec:
    """High-level codec facade (utils/audiodec.py:17-103): a checkpoint's
    generator as a primed :class:`AudioCodec`, and streamers of it."""

    def __init__(self, checkpoint: str, use_pqc: bool = True, batch: int = 1, device="cuda"):
        self.gen, self.vq_state, self.config = load_generator_from_checkpoint(
            checkpoint, use_pqc=use_pqc, device=device)
        self.device = device
        self.sample_rate = self.config.get("sampling_rate", 48000)
        self.codec = AudioCodec(self.gen, self.vq_state, batch=batch, device=device)
        self.codec.load()

    def streamer(self, frame_size: int = 1200, **kw) -> AudioCodecStreamer:
        s = AudioCodecStreamer(self.gen, self.vq_state, frame_size=frame_size,
                               sample_rate=self.sample_rate,
                               receptive_length=self.codec.receptive_length,
                               device=self.device, **kw)
        s.load()
        return s
