"""A fleet of concurrent streams served on one card.

Counterpart of dl_speech_enhancement_tpu/parallel/serve.py::
make_sharded_stream on one device. The JAX function shards B streams over a
mesh and advances the whole fleet with one dispatch per call; streams are
independent, so no collective is needed. On one card the fleet is the
batched whole-model stream of ops/mega_kernel.py: each layer is one kernel
launch over all B streams, 18 launches per dispatch (22 with PQC; 34 with
the vocoder receiver).

Receivers (the JAX package's paired presets):

- default: the codec decodes its own codes (symmetric fleet);
- ``rx_gen`` / ``rx_vq_state``: the asymmetric codec receiver. The encoder
  half runs with ``gen``'s weights and books, the decoder half with
  ``rx_gen``'s; the hand-off is the int32 wire codes (encoder features
  without PQC), as on the wire;
- ``vocoder``: the HiFiGAN receiver of the vocoder-paired presets
  (``vctk_v1``): the codec's encoder half, then the vocoder half
  (ops/vocoder_kernel.py::vocoder_half), which looks the wire codes up in
  the transmitter's books, as the JAX fleet's ``step_paired`` does.

Several cards (a mesh) are ROADMAP.md §1 "Parallel" and raise
NotImplementedError. The fleet computes with f32 weights, the JAX fleet's
arithmetic, so its wire codes equal an f32 peer's.
"""

from __future__ import annotations

import torch

from dl_speech_enhancement_tpu_torch.nn.vq import VQState
from dl_speech_enhancement_tpu_torch.ops.mega_kernel import (
    join_halves,
    mega_decoder,
    mega_encoder,
    mega_topology_error,
)
from dl_speech_enhancement_tpu_torch.ops.vocoder_kernel import (
    vocoder_half,
    vocoder_topology_error,
)
from dl_speech_enhancement_tpu_torch.utils.device import resolve_device

__all__ = ["make_sharded_stream"]


def make_sharded_stream(gen, vq_state=None, *, batch: int, device="cuda", rx_gen=None,
                        rx_vq_state=None, vocoder=None):
    """A ``batch``-stream fleet on one card: ``run(cache, frames (N, B, F, C))
    -> (audio (N, B, F', C), cache)`` with ``run.init_cache()``,
    ``run.shard_frames(x)`` (a host ``(N, B, F, C)`` array as an f32 tensor
    on the fleet's device) and ``run.batch``. ``F`` is any positive multiple
    of the hop, chosen by each call; the caches do not depend on it.

    ``gen`` and ``rx_gen`` are the port's ``AudioDecGenerator``s and
    ``vocoder`` its ``HiFiGANGenerator`` on ``device``; ``device`` is one
    device (a list of several raises NotImplementedError). Runs the CUDA
    kernels on the card and their plain versions on the CPU."""
    if vocoder is not None and rx_gen is not None:
        raise ValueError("give either a vocoder rx or a codec rx, not both")
    if rx_gen is None and rx_vq_state is not None:
        # a caller typo would otherwise degrade silently to a symmetric fleet
        raise ValueError("rx_vq_state requires rx_gen")
    if rx_gen is not None and gen.use_pqc and rx_vq_state is None:
        raise ValueError("a PQC tx sends code indices: the codec rx needs rx_vq_state to "
                         "look them up")
    if isinstance(device, (list, tuple)):
        if len(device) != 1:
            raise NotImplementedError(
                f"a fleet over {len(device)} devices is not ported yet: see ROADMAP.md §1, "
                "'Parallel'")
        device = device[0]
    device = resolve_device(device)
    batch = int(batch)
    if batch < 1:
        raise ValueError(f"batch must be at least 1, got {batch}")
    if rx_gen is None:
        rx_gen, rx_vq_state = gen, vq_state
    if rx_gen.use_pqc != gen.use_pqc:
        raise ValueError("the tx and rx codecs must both use PQC or both not")
    for g, vq in ((gen, vq_state), (rx_gen, rx_vq_state)):
        g.check_vq_state(vq)
        if g.device != device:
            raise ValueError(f"generator is on {g.device}, fleet asked for {device}")
        reason = mega_topology_error(g, g.hop)
        if reason:
            raise ValueError(f"the fleet cannot serve this generator: {reason}")
    if vocoder is not None:
        reason = vocoder_topology_error(vocoder, gen.hop, hop=gen.hop)
        if reason:
            raise ValueError(f"the fleet cannot serve this vocoder: {reason}")
        if vocoder.device != device:
            raise ValueError(f"vocoder is on {vocoder.device}, fleet asked for {device}")

    def on_device(vq):
        return None if vq is None else VQState(*(t.to(device) for t in vq))

    if vocoder is not None:
        receiver = vocoder_half(vocoder, torch.float32, on_device(vq_state))
    else:
        receiver = mega_decoder(rx_gen, torch.float32, on_device(rx_vq_state))
    init_cache, fleet = join_halves(mega_encoder(gen, torch.float32, on_device(vq_state)),
                                    receiver, batch, device)

    @torch.no_grad()
    def run(cache, frames):
        if frames.device != device or frames.dim() != 4 or frames.shape[1] != batch:
            raise ValueError(f"frames must be (N, {batch}, F, C) on {device}, got "
                             f"{tuple(frames.shape)} on {frames.device}")
        out, new_cache = fleet(cache, frames[..., 0])[:2]
        return out[..., None], new_cache

    def shard_frames(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    run.init_cache = init_cache
    run.shard_frames = shard_frames
    run.batch = batch
    return run
