"""Streaming CLI of the port (bin/stream.py; ``--without-pqc`` covers
bin/stream_without_PQC.py). Counterpart of dl_speech_enhancement_tpu/cli/
stream.py, with the same flags; ``--rx-backend`` takes the port's routes and
``--device`` picks the card (the default) or the CPU.

File-driven mode (the default; audio hardware is optional), from a directory
holding ``exp/`` (the preset table's checkpoints, utils/audiodec.py):

    python -m dl_speech_enhancement_tpu_torch.cli.stream --model vctk_v0 \\
        -i in.wav -o out.wav
    python -m dl_speech_enhancement_tpu_torch.cli.stream \\
        --checkpoint exp/denoise/<tag>/checkpoint-200000steps --without-pqc \\
        -i noisy.wav -o enhanced.wav

Repeat ``-i`` to stream several files at once (one numbered output each).
Live mode (needs the optional sounddevice package): add ``--live``. Logs the
reference's end-of-run stats (encoder/decoder ms mean and std, latency,
frame drops; bin/stream.py:284-310); ``main`` returns them.
"""

from __future__ import annotations

import logging
import os
from argparse import ArgumentParser

import numpy as np

from dl_speech_enhancement_tpu_torch.data import load_audio, write_wav
from dl_speech_enhancement_tpu_torch.stream.runtime import AudioCodecStreamer
from dl_speech_enhancement_tpu_torch.utils.audiodec import (
    load_generator_from_checkpoint,
    load_pair,
)

logger = logging.getLogger(__name__)


def main(argv=None) -> dict:
    parser = ArgumentParser()
    parser.add_argument("--model", default=None,
                        help="named preset (utils.audiodec.assign_model)")
    parser.add_argument("--checkpoint", default=None, help="explicit checkpoint directory")
    parser.add_argument("--without-pqc", action="store_true",
                        help="denoiser variant: raw features cross tx->rx")
    parser.add_argument("-i", "--input", action="append", default=None,
                        help="input wav (repeat to stream several files at once)")
    parser.add_argument("-o", "--output", default="output.wav",
                        help="output wav (several streams: one numbered file per input)")
    parser.add_argument("--frame-size", type=int, default=1200)
    parser.add_argument("--rx-backend", default="auto", choices=["auto", "cuda", "eager"],
                        help="a preset receiver's route: 'auto' runs its kernels on the "
                             "card (ops/vocoder_kernel.py, ops/mega_kernel.py) and raises "
                             "where they cannot run, 'eager' the plain modules; the "
                             "transmitter runs its kernels on the card")
    parser.add_argument("--max-latency", type=float, default=0.1)
    parser.add_argument("--live", action="store_true")
    parser.add_argument("--realtime", action="store_true",
                        help="pace file-driven streaming at wall-clock rate")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (the card, the default) or 'cpu' (the plain modules)")
    args = parser.parse_args(argv)

    inputs = args.input or []
    batch = max(len(inputs), 1)
    if args.checkpoint:
        gen, vq_state, config = load_generator_from_checkpoint(
            args.checkpoint, use_pqc=not args.without_pqc, device=args.device)
        sample_rate = config.get("sampling_rate", config.get("sample_rate", 48000))
        streamer = AudioCodecStreamer(gen, vq_state, frame_size=args.frame_size,
                                      sample_rate=sample_rate, max_latency=args.max_latency,
                                      batch=batch, device=args.device)
    elif args.model:
        # a named preset may pair an analyzer tx with a vocoder rx
        tx, rx, sample_rate = load_pair(args.model, batch=batch, rx_backend=args.rx_backend,
                                        device=args.device)
        streamer = AudioCodecStreamer(tx.gen, tx.vq_state, frame_size=args.frame_size,
                                      sample_rate=sample_rate, max_latency=args.max_latency,
                                      batch=batch, tx=tx, rx=rx, device=args.device)
    else:
        raise SystemExit("need --model or --checkpoint")
    streamer.load()
    logger.info("primed buffers (receptive %d samples, %d stream%s)",
                streamer.receptive_length, batch, "s" if batch > 1 else "")

    if args.live:
        streamer.run(latency=args.max_latency)
    else:
        if not inputs:
            raise SystemExit("file mode needs -i input.wav")
        clips = [load_audio(p, sample_rate)[:, :1] for p in inputs]
        t = min(c.shape[0] for c in clips) // args.frame_size * args.frame_size
        audio = np.stack([c[:t] for c in clips])  # (B, T, 1)
        out = streamer.run_array(audio, realtime=args.realtime)
        if batch == 1:
            write_wav(args.output, out[0, :, 0], sample_rate)
            logger.info("wrote %s (%d samples)", args.output, out.shape[1])
        else:
            root, ext = os.path.splitext(args.output)
            for b in range(batch):
                write_wav(f"{root}-{b}{ext}", out[b, :, 0], sample_rate)
            logger.info("wrote %d streams to %s-*%s (%d samples each)", batch, root, ext,
                        out.shape[1])

    stats = streamer.stats()
    logger.info("encoder: %.2f ± %.2f ms", stats["encoder_ms_mean"], stats["encoder_ms_std"])
    logger.info("decoder: %.2f ± %.2f ms", stats["decoder_ms_mean"], stats["decoder_ms_std"])
    logger.info("latency: %.2f ± %.2f ms", stats["latency_ms_mean"], stats["latency_ms_std"])
    logger.info("frame drops: %d/%d (%.2f%%)", stats["frame_drops"], stats["frames"],
                stats["drop_pct"])
    return stats


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s (%(module)s) %(message)s")
    main()
