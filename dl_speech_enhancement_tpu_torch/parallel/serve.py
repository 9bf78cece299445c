"""A fleet of concurrent streams, on one device or split over several.

Counterpart of dl_speech_enhancement_tpu/parallel/serve.py::
make_sharded_stream. The JAX function shards B streams over the ``data``
axis of a mesh and advances the whole fleet with one dispatch per call;
streams are independent, so no collective is needed. Here:

- On one device the fleet is the batched whole-model stream of
  ops/mega_kernel.py: each layer is one kernel launch over all B streams,
  18 launches per dispatch (22 with PQC; 34 with the vocoder receiver).
- Over a list of D devices (the mesh's ``data`` axis, parallel/mesh.py::
  make_mesh) each device gets its own copy of every generator, vocoder and
  set of codebooks, as the JAX fleet replicates them, and runs that
  one-device fleet over its B / D streams. A call enqueues every device's
  launches before it waits on any of them, then gathers the audio in stream
  order. A device may appear more than once in the list: two slices on the
  one card of a machine hold the split against the one-device fleet there.

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

The fleet computes with f32 weights, the JAX fleet's arithmetic, so its
wire codes equal an f32 peer's.
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
from dl_speech_enhancement_tpu_torch.utils.device import replica, resolve_device

__all__ = ["make_sharded_stream", "split_streams"]


def split_streams(batch: int, devices) -> int:
    """Streams each of ``devices`` serves: ``batch`` must divide over them,
    as the JAX fleet asks (parallel/serve.py:87-90)."""
    if not devices:
        raise ValueError("the fleet needs at least one device")
    if batch % len(devices):
        raise ValueError(f"total stream count {batch} must divide over {len(devices)} "
                         "devices")
    return batch // len(devices)


def make_sharded_stream(gen, vq_state=None, *, batch: int, device="cuda", rx_gen=None,
                        rx_vq_state=None, vocoder=None):
    """A ``batch``-stream fleet: ``run(cache, frames (N, B, F, C)) -> (audio
    (N, B, F', C), cache)`` with ``run.init_cache()``, ``run.shard_frames(x)``
    and ``run.batch``. ``F`` is any positive multiple of the hop, chosen by
    each call; the caches do not depend on it.

    ``device`` is one device, or a list of D devices over which the B
    streams split in order (B must divide by D; a list of one is one
    device). On one device ``gen``, ``rx_gen`` and ``vocoder`` (the port's
    ``AudioDecGenerator``s and ``HiFiGANGenerator``) must lie there, and
    ``shard_frames`` turns a host ``(N, B, F, C)`` array into an f32 tensor
    there. Over several, each device gets a copy of each model (none where
    the model already lies there); ``shard_frames`` splits the array into D
    per-device ``(N, B / D, F, C)`` tensors, ``run`` takes that list (or
    splits a whole ``(N, B, F, C)`` tensor itself) and returns the audio on
    ``devices[0]`` in stream order, the cache a list of D caches. Runs the
    CUDA kernels on the card and their plain versions on the CPU."""
    if vocoder is not None and rx_gen is not None:
        raise ValueError("give either a vocoder rx or a codec rx, not both")
    if rx_gen is None and rx_vq_state is not None:
        # a caller typo would otherwise degrade silently to a symmetric fleet
        raise ValueError("rx_vq_state requires rx_gen")
    if rx_gen is not None and gen.use_pqc and rx_vq_state is None:
        raise ValueError("a PQC tx sends code indices: the codec rx needs rx_vq_state to "
                         "look them up")
    batch = int(batch)
    if batch < 1:
        raise ValueError(f"batch must be at least 1, got {batch}")
    if isinstance(device, (list, tuple)):
        devices = [resolve_device(d) for d in device]
        per = split_streams(batch, devices)
        if len(devices) > 1:
            return _split_fleet(gen, vq_state, per, devices, rx_gen, rx_vq_state, vocoder)
        device = devices[0]
    return _one_device_fleet(gen, vq_state, batch, resolve_device(device), rx_gen, rx_vq_state,
                             vocoder)


def _one_device_fleet(gen, vq_state, batch, device, rx_gen, rx_vq_state, vocoder):
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
    run.devices = [device]
    return run


def _split_fleet(gen, vq_state, per, devices, rx_gen, rx_vq_state, vocoder):
    """One one-device fleet of ``per`` streams on each of ``devices``."""
    slices = [make_sharded_stream(replica(gen, dev), vq_state, batch=per, device=dev,
                                  rx_gen=replica(rx_gen, dev), rx_vq_state=rx_vq_state,
                                  vocoder=replica(vocoder, dev))
              for dev in devices]
    batch = per * len(devices)

    def shard_frames(x):
        if x.shape[1] != batch:
            raise ValueError(f"frames must be (N, {batch}, F, C), got {tuple(x.shape)}")
        return [torch.as_tensor(x[:, d * per:(d + 1) * per], dtype=torch.float32, device=dev)
                for d, dev in enumerate(devices)]

    @torch.no_grad()
    def run(cache, frames):
        shards = shard_frames(frames) if torch.is_tensor(frames) else frames
        if len(shards) != len(slices) or len(cache) != len(slices):
            raise ValueError(f"a fleet over {len(slices)} devices takes {len(slices)} frame "
                             f"slices and caches, got {len(shards)} and {len(cache)}")
        # every device's launches are enqueued before the gather waits on any
        outs, new_cache = zip(*(fleet(c, x) for fleet, c, x in zip(slices, cache, shards)))
        return torch.cat([o.to(devices[0]) for o in outs], dim=1), list(new_cache)

    run.init_cache = lambda: [fleet.init_cache() for fleet in slices]
    run.shard_frames = shard_frames
    run.batch = batch
    run.devices = devices
    return run
