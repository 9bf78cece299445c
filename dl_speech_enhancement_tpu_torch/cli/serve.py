"""Fleet serving CLI of the port: N concurrent streams, on one device or split
over several. Counterpart of dl_speech_enhancement_tpu/cli/serve.py, with
the same flags and ``--device``, as in cli/stream.py: the card (the
default) or the CPU (the plain modules).

    python -m dl_speech_enhancement_tpu_torch.cli.serve \\
        --checkpoint exp/denoise/<tag>/checkpoint-200000steps --without-pqc \\
        --streams 64 -i noisy.wav -o enhanced.wav

Inputs are tiled round-robin across the streams; each stream's output is the
one-device batched stream's (parallel/serve.py::make_sharded_stream, held
bit for bit by tests/test_torch_port_serve.py). Paired presets (``--model
vctk_v1`` and the other vocoder or codec receivers) serve their receiver in
the same dispatch. Logs and returns the fleet's stats: the fleet's frame
time, the time per stream-frame, the real-time stream equivalents and the
devices used.
"""

from __future__ import annotations

import logging
import os
import time
from argparse import ArgumentParser

import numpy as np
import torch

from dl_speech_enhancement_tpu_torch.data import load_audio, write_wav
from dl_speech_enhancement_tpu_torch.parallel.mesh import make_mesh
from dl_speech_enhancement_tpu_torch.parallel.serve import make_sharded_stream
from dl_speech_enhancement_tpu_torch.utils.audiodec import (
    load_generator_from_checkpoint,
    load_pair_models,
)

logger = logging.getLogger(__name__)


def main(argv=None) -> dict:
    parser = ArgumentParser()
    parser.add_argument("--checkpoint", default=None,
                        help="checkpoint directory (config.yml beside it)")
    parser.add_argument("--model", default=None,
                        help="named preset (utils/audiodec.py) instead of --checkpoint; paired "
                             "presets serve their receiver in the same fleet dispatch")
    parser.add_argument("--exp-root", default="exp",
                        help="experiment root for --model preset paths")
    parser.add_argument("--without-pqc", action="store_true",
                        help="denoiser variant (no quantizer in the chain)")
    parser.add_argument("--streams", type=int, default=None,
                        help="total stream count (must divide by the device count; default: "
                             "one stream a device)")
    parser.add_argument("--devices", type=int, default=None,
                        help="devices to split the streams over (default: every visible card; "
                             "one with --device cpu)")
    parser.add_argument("-i", "--input", action="append", required=True,
                        help="input wav; repeat to give streams distinct sources (tiled "
                             "round-robin across the fleet)")
    parser.add_argument("-o", "--output", default=None,
                        help="output wav; streams write <root>-<n>.wav. Omit to time the "
                             "fleet without copying its audio to the host")
    parser.add_argument("--frame-size", type=int, default=1200)
    parser.add_argument("--block-frames", type=int, default=16,
                        help="frames queued a dispatch (amortizes the host's work; latency "
                             "= block x frame)")
    parser.add_argument("--max-outputs", type=int, default=8,
                        help="cap on per-stream output files written")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (the card, the default) or 'cpu' (the plain modules)")
    args = parser.parse_args(argv)

    if (args.checkpoint is None) == (args.model is None):
        raise SystemExit("give exactly one of --checkpoint or --model")
    if args.model is not None and args.without_pqc:
        # presets carry their own architecture: loading the tx with use_pqc
        # set would ignore the flag
        raise SystemExit("--without-pqc applies to --checkpoint loads only; presets define "
                         "their own architecture")

    devices = make_mesh(args.devices, torch.device(args.device).type)
    n_dev = len(devices)
    streams = n_dev if args.streams is None else args.streams
    if args.model is not None:
        pair = load_pair_models(args.model, args.exp_root, device=devices[0])
        sample_rate = pair.pop("sample_rate")
        run = make_sharded_stream(pair.pop("gen"), pair.pop("vq_state"), batch=streams,
                                  device=devices, **pair)
    else:
        gen, vq_state, config = load_generator_from_checkpoint(
            args.checkpoint, use_pqc=not args.without_pqc, device=devices[0])
        sample_rate = config.get("sampling_rate", config.get("sample_rate", 48000))
        run = make_sharded_stream(gen, vq_state, batch=streams, device=devices)
    logger.info("fleet: %d streams over %d device%s (%d a device)", streams, n_dev,
                "s" if n_dev > 1 else "", streams // n_dev)

    clips = [load_audio(p, sample_rate)[:, :1] for p in args.input]
    t = min(c.shape[0] for c in clips)
    n_frames = t // args.frame_size
    if n_frames == 0:
        raise SystemExit(f"inputs shorter than one frame ({args.frame_size} samples)")
    t = n_frames * args.frame_size
    # (n_frames, B, F, 1): stream b plays input file b % len(inputs)
    audio = np.stack([clips[b % len(clips)][:t] for b in range(streams)])
    frames_host = (audio.reshape(streams, n_frames, args.frame_size, 1)
                   .transpose(1, 0, 2, 3).astype(np.float32))

    def fence():
        for dev in set(run.devices):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    cache = run.init_cache()
    block = max(1, args.block_frames)
    outs, walls = [], []
    for start in range(0, n_frames, block):
        fb = run.shard_frames(frames_host[start:start + block])
        fence()  # the upload is not the fleet's time
        t0 = time.perf_counter()
        ys, cache = run(cache, fb)
        fence()
        walls.append(time.perf_counter() - t0)
        if args.output:
            outs.append(ys.cpu().numpy())

    frame_s = args.frame_size / sample_rate
    # steady state: the first block (the kernels' build and warm-up) is left out
    steady = walls[1:] if len(walls) > 1 else walls
    blocks_frames = [min(block, n_frames - s) for s in range(0, n_frames, block)][1:] or [n_frames]
    per_frame = float(np.sum(steady)) / max(int(np.sum(blocks_frames)), 1)

    if args.output:
        y = np.concatenate(outs, axis=0)  # (n_frames, B, F, 1)
        y = y.transpose(1, 0, 2, 3).reshape(streams, -1)
        root, ext = os.path.splitext(args.output)
        n_out = min(streams, args.max_outputs)
        for b in range(n_out):
            write_wav(f"{root}-{b}{ext}" if streams > 1 else args.output, y[b], sample_rate)
        logger.info("wrote %d/%d stream outputs (%d samples each)", n_out, streams, y.shape[1])

    stats = {
        "streams": streams,
        "devices": n_dev,
        "frames": n_frames,
        "fleet_frame_ms": round(per_frame * 1e3, 3),
        "us_per_stream_frame": round(per_frame / streams * 1e6, 2),
        "realtime_stream_equivalents": round(frame_s / per_frame * streams, 1),
    }
    logger.info("fleet frame time: %.3f ms (%d streams -> %.2f us/stream)",
                stats["fleet_frame_ms"], streams, stats["us_per_stream_frame"])
    logger.info("realtime stream-equivalents: %.1f", stats["realtime_stream_equivalents"])
    return stats


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s (%(module)s) %(message)s")
    main()
