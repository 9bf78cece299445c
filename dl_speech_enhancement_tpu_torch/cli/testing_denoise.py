"""Batch inference for scoring (the course's testing_denoise.py).

Counterpart of dl_speech_enhancement_tpu/cli/testing_denoise.py: a zoo of
without-PQC denoisers restored from port checkpoints ("flagships",
testing_denoise.py:106-113) and optionally the composite ``AD`` model (the
PQC analyzer's encode, project and quantize, then a HiFiGAN vocoder,
testing_denoise.py:72-103) run the seeded test split with on-the-fly noise
mixing, and each model's outputs are written to ``<out-dir>/<model>/
test-N.wav`` beside ``noisy/`` and ``clean/``, for cli/dnsmos.py:

    python -m dl_speech_enhancement_tpu_torch.cli.testing_denoise \\
        -e LAPTOP --clean-path ... --noise-path ... \\
        --flagship name=job_out/<task>checkpoint-<steps> \\
        [--vocoder exp/vocoder/<tag>/checkpoint-...:exp/autoencoder/...] [--device cpu]

Every model runs its offline forward (the JAX package's ``gen(params, None,
x, train=False)``) on the device. A model is ``(infer, hop)``, ``infer``
taking numpy ``(B, T, 1)`` batches (cast to float32, as the JAX package's
``jnp.asarray`` casts the float64 mix) and returning float32 ones.
"""

from __future__ import annotations

import logging
import os
from argparse import ArgumentParser

import numpy as np
import torch

from dl_speech_enhancement_tpu_torch.data import (
    AudioDataset,
    add_noise,
    get_dataloaders,
    write_wav,
)
from dl_speech_enhancement_tpu_torch.models import AudioDecGenerator
from dl_speech_enhancement_tpu_torch.train.checkpoint import load_checkpoint
from dl_speech_enhancement_tpu_torch.utils.audiodec import load_generator_from_checkpoint
from dl_speech_enhancement_tpu_torch.utils.config import load_config, load_config_beside
from dl_speech_enhancement_tpu_torch.utils.device import resolve_device
from dl_speech_enhancement_tpu_torch.utils.model_factory import build_generator

logger = logging.getLogger(__name__)


def _numpy_infer(fn, device):
    @torch.no_grad()
    def infer(x: np.ndarray) -> np.ndarray:
        return fn(torch.as_tensor(np.asarray(x, np.float32), device=device)).cpu().numpy()
    return infer


def load_flagship(checkpoint: str, generator_params: dict, device="cuda"):
    """A without-PQC generator restored from a course checkpoint
    (testing_denoise.py:106-113), as ``(infer, hop)``."""
    gen = AudioDecGenerator(**generator_params, use_pqc=False, device=device)
    restored = load_checkpoint(checkpoint, like={"params_generator": gen.state_dict()})
    gen.load_state_dict(restored["params_generator"])
    return _numpy_infer(lambda x: gen(x, None, train=False)[0], gen.device), gen.hop


def ad_model(analyzer: AudioDecGenerator, vq_state, vocoder):
    """``(infer, hop)`` of the composite: the PQC analyzer's encoder,
    projector and quantizer, then ``vocoder`` on the quantized codes."""
    def fn(x):
        z = analyzer.projector(analyzer.encoder(x))
        zq, _ = analyzer.quantizer.inference(vq_state, z)
        return vocoder(zq)
    return _numpy_infer(fn, analyzer.device), analyzer.hop


def define_AD_model(analyzer_ckpt: str, vocoder_ckpt: str, device="cuda"):
    """The composite AudioDec from port checkpoints (testing_denoise.py:
    72-103); the vocoder config's ``stats:`` path is read relative to the
    working directory."""
    analyzer, vq_state, _ = load_generator_from_checkpoint(analyzer_ckpt, device=device)
    v_config = load_config_beside(vocoder_ckpt)
    voc = build_generator(v_config["model_type"], v_config["generator_params"], device=device)
    restored = load_checkpoint(vocoder_ckpt, like={"params_generator": voc.state_dict()})
    voc.load_state_dict(restored["params_generator"])
    return ad_model(analyzer, vq_state, voc)


def infer_split(models: dict, clean_loader, noise_loader, out_dir: str, sample_rate: int,
                mix_rng, laptop: bool = False) -> dict:
    """Run the test split through every model, writing the wavs
    (testing_denoise.py:171-209); returns the count written per model."""
    counters = {name: 0 for name in models}
    for i_batch, (clean_batch, noise_batch) in enumerate(zip(clean_loader, noise_loader)):
        if laptop and i_batch == 3:
            break
        mixed = add_noise(clean_batch, noise_batch, mix_rng.integers(10, 20))
        for name, (infer, hop) in models.items():
            t = (mixed.shape[1] // hop) * hop
            y = infer(mixed[:, :t])
            for b in range(y.shape[0]):
                write_wav(os.path.join(out_dir, name, f"test-{counters[name]}.wav"),
                          y[b, :, 0], sample_rate)
                counters[name] += 1
        # the references, once
        for b in range(mixed.shape[0]):
            n = i_batch * mixed.shape[0] + b
            write_wav(os.path.join(out_dir, "noisy", f"test-{n}.wav"), mixed[b, :, 0],
                      sample_rate)
            write_wav(os.path.join(out_dir, "clean", f"test-{n}.wav"), clean_batch[b, :, 0],
                      sample_rate)
    return counters


def main(argv=None) -> dict:
    parser = ArgumentParser()
    parser.add_argument("-e", "--environment", default="LAPTOP")
    parser.add_argument("-c", "--config", default="symAD_custom.yaml")
    parser.add_argument("--config-dir", default=os.path.join("configs", "denoise"))
    parser.add_argument("--clean-path", required=True)
    parser.add_argument("--noise-path", required=True)
    parser.add_argument("--flagship", action="append", default=[],
                        help="name=checkpoint_dir (repeatable)")
    parser.add_argument("--vocoder", default=None,
                        help="vocoder_ckpt:analyzer_ckpt composite model")
    parser.add_argument("--out-dir", default="test_out")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (the card, the default) or 'cpu' (the plain modules)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    config = load_config(os.path.join(args.config_dir, args.config))
    sr, seed = config["sample_rate"], config["seed"]
    clean_ds = AudioDataset(args.clean_path, os.path.basename(args.clean_path.rstrip("/")), sr)
    noise_ds = AudioDataset(args.noise_path, os.path.basename(args.noise_path.rstrip("/")), sr)
    batch_size = 4 if args.environment == "LAPTOP" else int(config["batch_size"])
    # the seeded split keeps train and test apart across the scripts
    _, _, test_clean = get_dataloaders(clean_ds, [0.7, 0.15, 0.15], batch_size, sr, seed)
    _, _, test_noise = get_dataloaders(noise_ds, [0.7, 0.15, 0.15], batch_size, sr, seed)

    models = {}
    for spec in args.flagship:
        name, ckpt = spec.split("=", 1)
        models[name] = load_flagship(ckpt, config["generator_params"], device)
    if args.vocoder:
        voc_ckpt, ana_ckpt = args.vocoder.split(":", 1)
        models["AD"] = define_AD_model(ana_ckpt, voc_ckpt, device)
    if not models:
        raise SystemExit("no models given (--flagship / --vocoder)")

    counters = infer_split(models, test_clean, test_noise, args.out_dir, sr,
                           np.random.default_rng(seed), laptop=args.environment == "LAPTOP")
    logger.info("wrote: %s", counters)
    return counters


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s (%(module)s) %(message)s")
    main()
