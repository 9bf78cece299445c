"""Long audio in parallel chunks: overlap-discard chunking, the counterpart of
dl_speech_enhancement_tpu/parallel/long_audio.py.

The generator is causal with a finite receptive field R, so output sample
``t`` depends only on inputs ``[t - R + 1, t]``. A long signal cut into N
chunks that each carry ``context`` samples of left context (at least R)
gives every chunk's core region exactly as the full-signal forward does.
The chunks run as the batch axis of the offline ``gen.forward``
(models/autoencoder.py::AudioDecGenerator.forward, cuDNN on the card, no
streaming cache), which keeps the card busier than one long sequence; over
a list of devices the chunks split as parallel/serve.py splits streams,
each device with its own copy of the generator.
"""

from __future__ import annotations

import numpy as np
import torch

from dl_speech_enhancement_tpu_torch.nn.vq import VQState
from dl_speech_enhancement_tpu_torch.parallel.serve import split_streams
from dl_speech_enhancement_tpu_torch.utils.device import replica, resolve_device

__all__ = ["parallel_denoise", "parallel_forward"]


def parallel_forward(forward, audio: np.ndarray, hop: int, context: int, n_chunks: int,
                     devices=("cpu",)) -> np.ndarray:
    """Run ``forward((n, T, C) tensor) -> (n, T, C)`` over ``audio (T, C)``
    cut into ``n_chunks`` equal chunks with ``context`` samples of left
    overlap, the chunks split in order over ``devices`` (``n_chunks`` must
    divide by their count; a device may repeat). ``forward`` is called once
    a device with that device's chunks on it; every call is made before
    any result is read.

    ``context`` must cover the model's receptive field and is rounded up to
    a multiple of ``hop``; chunk boundaries fall on the hop. Returns (T', C)
    f32 with T' = context + n_chunks * core, the usable length: chunk 0
    keeps its context region (from zero caches, as the full forward does),
    every chunk gives its core. Raises ValueError where the audio holds no
    core for this many chunks."""
    devices = [resolve_device(d) for d in devices]
    per = split_streams(n_chunks, devices)
    context = -(-context // hop) * hop
    core = (audio.shape[0] - context) // (n_chunks * hop) * hop
    if core <= 0:
        raise ValueError(f"audio of {audio.shape[0]} samples is too short for {n_chunks} "
                         f"chunks of context {context}")
    chunks = np.stack([audio[i * core:i * core + context + core] for i in range(n_chunks)])
    outs = [forward(torch.as_tensor(chunks[d * per:(d + 1) * per], dtype=torch.float32,
                                    device=dev))
            for d, dev in enumerate(devices)]
    y = torch.cat([o.cpu() for o in outs]).numpy()
    return np.concatenate([y[0, :context], y[:, context:].reshape(-1, y.shape[-1])])


def parallel_denoise(gen, vq_state, audio: np.ndarray, n_chunks: int | None = None,
                     context: int | None = None, device="cuda") -> np.ndarray:
    """Chunk-parallel offline inference of an ``AudioDecGenerator`` (with
    ``vq_state`` for the PQC codec, None without), as JAX
    ``parallel_denoise``: ``n_chunks`` defaults to one a device, ``context``
    to ``gen.model_receptive_length``, the whole model's receptive field
    (13217 samples for the flagship denoiser). JAX defaults it to
    ``gen.receptive_length``, which covers the encoder only (6609), so near
    each chunk's start its decoder lacks context and the chunks differ from
    the full forward. ``device`` is one device or a list; the
    generator and the codebooks are copied to each device they do not lie
    on. Returns (T', C) f32 as :func:`parallel_forward`."""
    devices = list(device) if isinstance(device, (list, tuple)) else [device]
    devices = [resolve_device(d) for d in devices]
    n_chunks = len(devices) if n_chunks is None else n_chunks
    context = gen.model_receptive_length if context is None else context
    models = {}
    for dev in devices:
        if dev not in models:
            vq = None if vq_state is None else VQState(*(t.to(dev) for t in vq_state))
            models[dev] = (replica(gen, dev), vq)

    @torch.no_grad()
    def forward(x):
        model, vq = models[x.device]
        return model(x, vq, train=False)[0]

    return parallel_forward(forward, audio, gen.hop, context, n_chunks, devices)
