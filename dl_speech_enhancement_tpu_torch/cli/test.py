"""Offline codec test (the reference's bin/test.py TestGEN).

Counterpart of dl_speech_enhancement_tpu/cli/test.py: the codec checkpoint
(with its ``config.yml`` beside it) encodes, projects, quantizes and decodes
each wav of a dataset, the real-time factor is reported per clip and as the
mean, and the outputs are written as PCM_16 wavs (bin/test.py:89-115):

    python -m dl_speech_enhancement_tpu_torch.cli.test \\
        --encoder exp/autoencoder/<tag>/checkpoint-200000steps \\
        --input corpus/48000/clean_testset_wav --output test_out/codec [--device cpu]

Each clip runs at its exact length cut to whole hops (the JAX package pads
to a power-of-two frame count only to spare recompiles; the model is
causal, so the kept samples are the same). On the card one untimed call per
clip comes first (cuDNN picks its plans there) and the clock stops after
``torch.cuda.synchronize()``.
"""

from __future__ import annotations

import logging
import os
import time
from argparse import ArgumentParser

import numpy as np
import torch

from dl_speech_enhancement_tpu_torch.data import SingleDataset, write_wav
from dl_speech_enhancement_tpu_torch.utils.audiodec import load_generator_from_checkpoint
from dl_speech_enhancement_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


@torch.no_grad()
def codec_forward(gen, vq_state, x: torch.Tensor):
    """Encode, project, quantize and decode ``x`` (B, T, 1): returns ``(y,
    z, codes)``, the audio, the projector's output and the (L, B, T_code)
    codes."""
    z = gen.projector(gen.encoder(x))
    zq, codes = gen.quantizer.inference(vq_state, z)
    return gen.decoder(zq), z, codes


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_codec_test(encoder_ckpt: str, input_path: str, output_dir: str,
                   subset_num: int = -1, device="cuda") -> dict:
    """Returns ``{"rtf": {utt_id: rtf}, "mean_rtf": float}`` and writes
    ``<output_dir>/<utt_id>_output.wav`` per clip. The codec is symmetric:
    the one checkpoint holds both the encoder and the decoder."""
    device = resolve_device(device)
    gen, vq_state, config = load_generator_from_checkpoint(encoder_ckpt, device=device)
    sr = config["sampling_rate"]
    dataset = SingleDataset(input_path, return_utt_id=True, subset_num=subset_num,
                            sample_rate=sr)
    os.makedirs(output_dir, exist_ok=True)
    rtfs = {}
    for utt_id, audio in dataset:
        t = (audio.shape[0] // gen.hop) * gen.hop
        if t == 0:
            continue
        x = torch.as_tensor(np.ascontiguousarray(audio[None, :t, :1]), device=device)
        codec_forward(gen, vq_state, x)  # untimed: cuDNN's plans
        _sync(device)
        t0 = time.perf_counter()
        y = codec_forward(gen, vq_state, x)[0]
        _sync(device)
        rtfs[utt_id] = (time.perf_counter() - t0) / (t / sr)
        logger.info("%s: RTF = %.4f", utt_id, rtfs[utt_id])
        write_wav(os.path.join(output_dir, f"{utt_id}_output.wav"), y[0, :, 0].cpu().numpy(),
                  sr)
    mean_rtf = float(np.mean(list(rtfs.values()))) if rtfs else float("nan")
    logger.info("Mean RTF = %.4f (N=%d)", mean_rtf, len(rtfs))
    return {"rtf": rtfs, "mean_rtf": mean_rtf}


def main(argv=None) -> dict:
    parser = ArgumentParser()
    parser.add_argument("--encoder", required=True, help="analyzer checkpoint directory")
    parser.add_argument("--input", required=True, help="wav dir / list / file")
    parser.add_argument("--output", default="test_out")
    parser.add_argument("--subset-num", type=int, default=-1)
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (the card, the default) or 'cpu' (the plain modules)")
    args = parser.parse_args(argv)
    return run_codec_test(args.encoder, args.input, args.output, args.subset_num,
                          args.device)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s (%(module)s) %(message)s")
    main()
