"""Streaming of one or many streams: the port's main entry point, and the
codec's transmitter and receiver.

Counterpart of dl_speech_enhancement_tpu/stream/runtime.py::
resolve_scan_backend, ::make_scan_stream, and ::StreamingTransmitter /
::StreamingReceiver. ``make_scan_stream`` returns ``run(cache, frames (N, B,
F, C)) -> (audio (N, B, F', C), cache)`` with ``run.init_cache()``, the same
frames layout and per-frame semantics as the JAX package: each frame of each
of the B streams runs ``encode_step`` (with PQC then ``quantize`` and
``lookup``) then ``decode_step``, with the caches carried across frames and
dispatches. With PQC, ``run.run_with_codes(cache, frames) -> (audio, cache,
codes)`` also returns the wire codes of the same dispatch, int32 ``(N, F /
hop, L)`` for one stream and ``(N, B, F / hop, L)`` for B > 1, as in the JAX
package.

Backends:

- ``'cuda'``: the whole-model kernel route for B streams at once
  (ops/mega_kernel.py::make_mega_stream_batched, 18 launches per dispatch,
  22 with PQC, for any B); needs ``frame_size``. Only the single-stream
  denoiser gives way, where the topology check fails or no ``frame_size`` is
  given, to the ``'cuda_chain'`` route, as the JAX package falls back from
  its mega kernel to the fused chunk step. Otherwise (the codec, or B > 1)
  the route does not give way to the plain modules on the card:
  ``make_scan_stream`` raises, naming the reason.
- ``'cuda_chain'``: per-frame steps with every residual chain on the
  residual_chain kernel and the boundary convs on the plain modules
  (ops/stream_kernel.py::make_fused_chunk_step); one stream of the
  denoiser only.
- ``'eager'``: per-frame steps of the plain modules at batch B.
- ``'auto'``: see :func:`resolve_scan_backend`.

The vocoder-paired presets (``vctk_v1``: the symAD codec's transmitter, the
int32 wire codes, the AudioDec v1 HiFiGAN receiver; counterpart of JAX
``make_vocoder_scan_stream`` and ``VocoderReceiver``):

- :func:`make_vocoder_scan_stream` streams one stream's frames ``(N, F)``
  through the transmitter and the receiver. Its ``'cuda'`` route (``'auto'``
  on the card) joins the codec's encoder half to the vocoder half
  (ops/mega_kernel.py::mega_encoder, ops/vocoder_kernel.py::vocoder_half),
  11 + 23 launches per dispatch with PQC, and raises where that cannot run;
  ``'eager'`` is the per-frame loop of the plain modules.
- :class:`VocoderReceiver` decodes wire codes ``(L, B, T)`` (features
  ``(B, T, D)`` without PQC) of B streams into audio, on the vocoder half
  for any B on the card, on the plain modules with ``'eager'``.

:class:`AudioCodecStreamer` is the real-time host loop around a pair of
endpoints (JAX ``AudioCodecStreamer``, bin/stream.py:107-365): audio in ->
tx thread -> wire codes -> rx thread -> audio out, with latency tracking,
queue-flush frame drops and zeros on underflow; with one generator and no
custom endpoints it runs one worker on ``make_scan_stream``'s route
instead (the fused mode). cli/stream.py drives it.
"""

from __future__ import annotations

import logging
import queue
import threading
import time

import numpy as np
import torch

from dl_speech_enhancement_tpu_torch.nn.vq import VQState
from dl_speech_enhancement_tpu_torch.ops.mega_kernel import (
    init_half_cache,
    join_halves,
    make_mega_stream_batched,
    mega_decoder,
    mega_encoder,
    mega_topology_error,
)
from dl_speech_enhancement_tpu_torch.ops.stream_kernel import make_fused_chunk_step
from dl_speech_enhancement_tpu_torch.ops.vocoder_kernel import (
    vocoder_half,
    vocoder_topology_error,
)
from dl_speech_enhancement_tpu_torch.utils.device import replica, resolve_device

BACKENDS = ("auto", "cuda", "cuda_chain", "eager")
logger = logging.getLogger(__name__)


def resolve_scan_backend(backend: str, *, on_cuda: bool, batch: int,
                         use_pqc: bool) -> str:
    """Resolve ``make_scan_stream``'s ``backend='auto'`` to a concrete route:
    ``'cuda'`` on a CUDA device, for both codecs and every ``batch``;
    ``'eager'`` on the CPU. The JAX router takes XLA for ``batch > 1``
    because XLA beat its batched kernels on a TPU v5e; that measurement does
    not carry over to the card, where the batched kernel route runs.
    ``batch`` and ``use_pqc`` stay parameters, as in the JAX router.
    Explicit routes are returned unchanged."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
    if backend != "auto":
        return backend
    return "cuda" if on_cuda else "eager"


def _check_frames(frames, device, batch):
    if frames.device != device or frames.dim() != 4 or frames.shape[1] != batch:
        raise ValueError(f"frames must be (N, {batch}, F, C) on {device}, got "
                         f"{tuple(frames.shape)} on {frames.device}")


def _vq_on(vq_state, device) -> VQState:
    return VQState(*(t.to(device) for t in vq_state))


def make_scan_stream(gen, vq_state=None, batch: int = 1, backend: str = "auto",
                     frame_size: int | None = None, weight_dtype=None, device="cuda"):
    """Streaming of ``batch`` independent streams: ``run(cache, frames (N, B,
    F, C)) -> (audio (N, B, F', C), cache)``, ``run.init_cache() -> cache``;
    with PQC also ``run.run_with_codes``.

    ``gen`` is the port's ``AudioDecGenerator``, already on ``device``;
    ``vq_state`` its ``VQState`` when ``gen.use_pqc``. ``weight_dtype`` goes
    to the whole-model kernel route (default bf16 there; activations, sums
    and codebooks stay f32; pass float32 where the wire codes must equal an
    f32 peer's). ``run.backend`` names the route taken. The ``'cuda'`` route
    (``'auto'`` on the card) raises ValueError for the codec or for ``batch
    > 1`` unless ``frame_size`` is one the kernel route takes."""
    device = resolve_device(device)
    gen.check_vq_state(vq_state)
    if batch < 1:
        raise ValueError(f"batch must be at least 1, got {batch}")
    if gen.device != device:
        raise ValueError(f"generator is on {gen.device}, stream asked for {device}")
    backend = resolve_scan_backend(backend, on_cuda=device.type == "cuda", batch=batch,
                                   use_pqc=gen.use_pqc)
    if backend == "cuda_chain" and gen.use_pqc:
        raise ValueError("the 'cuda_chain' route covers the without-PQC denoiser")
    if backend == "cuda_chain" and batch > 1:
        raise ValueError("the 'cuda_chain' route runs one stream; batch > 1 takes the "
                         "'cuda' route with a frame_size")
    if backend == "cuda" and (gen.use_pqc or batch > 1):
        reason = ("no frame_size given" if frame_size is None
                  else mega_topology_error(gen, frame_size))
        if reason:
            who = "the codec's" if gen.use_pqc else f"the {batch}-stream"
            raise ValueError(f"{who} 'cuda' route cannot run: {reason}; pass a "
                             "frame_size it takes, or backend='eager' for the plain modules")
    if backend in ("cuda", "cuda_chain") and device.type != "cuda":
        raise ValueError(f"backend {backend!r} runs CUDA kernels; device is {device}")
    if gen.use_pqc:
        vq_state = _vq_on(vq_state, device)
    if (backend == "cuda" and frame_size is not None
            and mega_topology_error(gen, frame_size) is None):
        init_mega, mega_run = make_mega_stream_batched(
            gen, frame_size, batch, vq_state=vq_state,
            **({} if weight_dtype is None else {"weight_dtype": weight_dtype}))

        @torch.no_grad()
        def run_with_codes(cache, frames):
            _check_frames(frames, device, batch)
            out, new_cache, *codes = mega_run(cache, frames[..., 0])
            if batch == 1:
                codes = [c[:, 0] for c in codes]
            return (out[..., None], new_cache, *codes)

        def run(cache, frames):
            return run_with_codes(cache, frames)[:2]

        if gen.use_pqc:
            run.run_with_codes = run_with_codes
        run.init_cache = init_mega
        run.backend = "cuda"
        return run
    if backend in ("cuda", "cuda_chain"):
        init_fused, fstep = make_fused_chunk_step(gen)

        def run(cache, frames):
            _check_frames(frames, device, batch)
            ys = []
            for frame in frames:
                y, cache = fstep(cache, frame[0])
                ys.append(y[None])
            return torch.stack(ys), cache

        run.init_cache = init_fused
        run.backend = "cuda_chain"
        return run

    flat_cb = gen.flat_codebook(vq_state) if gen.use_pqc else None

    @torch.no_grad()
    def run_with_codes(cache, frames):
        _check_frames(frames, device, batch)
        ys, codes = [], []
        for frame in frames:
            z, enc_cache = gen.encode_step(cache, frame)
            cache = {**cache, **enc_cache}
            if gen.use_pqc:
                idx = gen.quantize(vq_state, z)  # (L, B, T_code)
                codes.append(idx.permute(1, 2, 0))
                z = gen.lookup(flat_cb, idx)
            y, dec_cache = gen.decode_step(cache, z)
            cache = {**cache, **dec_cache}
            ys.append(y)
        if not gen.use_pqc:
            return torch.stack(ys), cache
        codes = torch.stack(codes)
        return torch.stack(ys), cache, codes[:, 0] if batch == 1 else codes

    def run(cache, frames):
        return run_with_codes(cache, frames)[:2]

    def init_cache():
        return gen.init_cache(batch)

    if gen.use_pqc:
        run.run_with_codes = run_with_codes
    run.init_cache = init_cache
    run.backend = "eager"
    return run


def _check_wire_codes(gen, idx) -> None:
    """Raise unless ``idx`` is (L, B, T) flattened wire codes of ``gen``'s
    quantizer, each in its book's range [l*K, (l+1)*K)."""
    q = gen.quantizer
    base = (torch.arange(q.codebook_num, device=idx.device) * q.codebook_size).reshape(
        -1, *[1] * (idx.dim() - 1))
    if idx.shape[0] != q.codebook_num or bool(
            ((idx < base) | (idx >= base + q.codebook_size)).any()):
        raise ValueError(f"wire codes {tuple(idx.shape)} hold a code outside its "
                         f"book's range [l*K, (l+1)*K), K={q.codebook_size}")


def _check_endpoint(gen, device):
    device = resolve_device(device)
    if gen.device != device:
        raise ValueError(f"generator is on {gen.device}, endpoint asked for {device}")
    return device


def _endpoint_route(backend, device, gen, what, voc=None, rx_chunk=None):
    """The route an endpoint (or the vocoder stream) of ``gen``, the codec,
    takes: ``'cuda'`` (``'auto'`` on the card) or ``'eager'``; raises where
    the ``'cuda'`` route cannot run, naming the reason. With ``voc`` the
    vocoder half must also take ``rx_chunk`` rows."""
    backend = resolve_scan_backend(backend, on_cuda=device.type == "cuda", batch=1,
                                   use_pqc=gen.use_pqc)
    if backend == "cuda_chain":
        raise ValueError(f"{what} takes 'cuda', 'eager' or 'auto'; 'cuda_chain' runs the "
                         "denoiser's stream alone")
    if backend == "cuda":
        reason = mega_topology_error(gen, gen.hop) or (
            voc is not None and vocoder_topology_error(voc, rx_chunk, hop=gen.hop))
        if reason:
            raise ValueError(f"{what}'s 'cuda' route cannot run: {reason}; pass "
                             "backend='eager' for the plain modules")
        if device.type != "cuda":
            raise ValueError(f"backend 'cuda' runs CUDA kernels; device is {device}")
    return backend


class StreamingTransmitter:
    """Tx side of the codec: audio chunk (B, T, 1) -> flattened wire codes
    (L, B, T / hop) int32 (with PQC) or encoder features (B, T / hop, C)
    (without). The ``'cuda'`` route (``'auto'`` on the card) runs the
    encoder half of the whole-model stream (ops/mega_kernel.py::
    mega_encoder, 11 launches a call with PQC, 9 without) and raises where
    it cannot run; ``'eager'`` the plain modules, as the JAX transmitter
    runs an XLA step. The kernel route keeps f32 weights: its codes leave
    the endpoint and must equal an f32 peer's up to near ties. Caches carry
    across ``encode`` calls."""

    def __init__(self, gen, vq_state: VQState | None, batch: int = 1, backend: str = "auto",
                 device="cuda"):
        self.gen = gen
        self.device = _check_endpoint(gen, device)
        self.use_pqc = gen.use_pqc
        gen.check_vq_state(vq_state)
        self.vq_state = _vq_on(vq_state, self.device) if self.use_pqc else None
        self.batch = batch
        self.backend = _endpoint_route(backend, self.device, gen, "StreamingTransmitter")
        if self.backend == "cuda":
            self._half = mega_encoder(gen, torch.float32, self.vq_state)
        self.reset_buffer()

    def reset_buffer(self):
        if self.backend == "cuda":
            self.cache = init_half_cache((self._half,), self.batch, self.device)
            return
        self.cache = {k: v for k, v in self.gen.init_cache(self.batch).items()
                      if k in ("encoder", "projector")}

    def initial_encoder(self, receptive_length: int):
        """Prime the caches with a zero receptive field (rounded up to whole
        code frames); returns the priming output, as the reference does."""
        rl = -(-receptive_length // self.gen.hop) * self.gen.hop
        return self.encode(torch.zeros((self.batch, rl, self.gen.input_channels),
                                       device=self.device))

    @torch.no_grad()
    def encode(self, chunk: torch.Tensor) -> torch.Tensor:
        chunk = chunk.to(self.device)
        if self.backend == "cuda":
            wire, new_cache = self._half.run(self.cache, chunk.contiguous())
            self.cache.update(new_cache)
            return wire.permute(2, 0, 1) if self.use_pqc else wire
        z, new_cache = self.gen.encode_step(self.cache, chunk)
        self.cache.update(new_cache)
        return self.gen.quantize(self.vq_state, z) if self.use_pqc else z


class StreamingReceiver:
    """Rx side of the codec: wire codes (L, B, T_code) int32 (or encoder
    features (B, T_code, C) without PQC) -> audio (B, T, 1). The ``'cuda'``
    route (``'auto'`` on the card) runs the decoder half of the whole-model
    stream (ops/mega_kernel.py::mega_decoder, 11 launches a call with PQC,
    9 without; bf16 weights unless given ``weight_dtype``) and raises where
    it cannot run; ``'eager'`` the plain modules. Codes from a transmitter
    on another device are moved here first. A code outside its book's range
    raises ValueError: at once where the codes come from the host (checked
    there before the upload) or on the eager route; where they are already
    on the card, at the next ``decode`` after this one has finished there
    (after a synchronising read, such as ``.cpu()`` of the audio). Caches
    carry across ``decode`` calls."""

    def __init__(self, gen, vq_state: VQState | None, batch: int = 1, backend: str = "auto",
                 weight_dtype=torch.bfloat16, device="cuda"):
        self.gen = gen
        self.device = _check_endpoint(gen, device)
        self.use_pqc = gen.use_pqc
        gen.check_vq_state(vq_state)
        vq = _vq_on(vq_state, self.device) if self.use_pqc else None
        self.batch = batch
        self.backend = _endpoint_route(backend, self.device, gen, "StreamingReceiver")
        if self.backend == "cuda":
            self._half = mega_decoder(gen, weight_dtype, vq)
        else:
            self.flat_cb = gen.flat_codebook(vq) if self.use_pqc else None
        self.reset_buffer()

    def reset_buffer(self):
        if self.backend == "cuda":
            self.cache = init_half_cache((self._half,), self.batch, self.device)
            return
        self.cache = {"decoder": self.gen.init_cache(self.batch)["decoder"]}

    def initial_decoder(self, idx):
        return self.decode(idx)

    @torch.no_grad()
    def decode(self, idx: torch.Tensor) -> torch.Tensor:
        if self.use_pqc and (idx.device.type == "cpu" or self.backend != "cuda"):
            _check_wire_codes(self.gen, idx)  # host codes: before the upload, no card wait
        idx = idx.to(self.device)
        if self.backend == "cuda":
            # codes already on the card: codebook_lookup records a bad one,
            # which raises at the next decode after this one has finished
            wire = idx.permute(1, 2, 0) if self.use_pqc else idx
            y, new_cache = self._half.run(self.cache, wire.contiguous())
            self.cache.update(new_cache)
            return y
        zq = self.gen.lookup(self.flat_cb, idx) if self.use_pqc else idx
        y, new_cache = self.gen.decode_step(self.cache, zq)
        self.cache.update(new_cache)
        return y


def make_vocoder_scan_stream(codec_gen, vq_state, voc, frame_size: int, backend: str = "auto",
                             weight_dtype=None, device="cuda"):
    """One stream of a vocoder-paired preset, the codec's transmitter then
    the wire codes (encoder features without PQC) then the HiFiGAN receiver:
    ``run(cache, frames (N, frame_size)) -> (audio (N, frame_size *
    total_upsample / hop), cache)``, ``run.init_cache()``, ``run.backend``.

    ``codec_gen`` (the port's ``AudioDecGenerator``, with its ``VQState``
    ``vq_state`` when it uses PQC; the codes are looked up in these books)
    and ``voc`` (the port's ``HiFiGANGenerator``) are on ``device``.
    ``weight_dtype`` goes to the kernel route (bf16 by default; pass float32
    for wire codes equal to an f32 peer's). The ``'cuda'`` route (``'auto'``
    on the card) raises ValueError where it cannot run (a vocoder whose
    total upsample is not the codec's hop, a unit that does not fit the
    kernel's shared memory)."""
    device = resolve_device(device)
    codec_gen.check_vq_state(vq_state)
    for g in (codec_gen, voc):
        if g.device != device:
            raise ValueError(f"generator is on {g.device}, stream asked for {device}")
    if frame_size <= 0 or frame_size % codec_gen.hop:
        raise ValueError(f"frame_size {frame_size} must be a positive multiple of the "
                         f"codec's hop {codec_gen.hop}")
    rx_chunk = frame_size // codec_gen.hop * voc.total_upsample
    backend = _endpoint_route(backend, device, codec_gen, "the vocoder stream", voc, rx_chunk)
    vq = _vq_on(vq_state, device) if codec_gen.use_pqc else None

    def check(frames):
        if frames.device != device or frames.dim() != 2 or frames.shape[1] != frame_size:
            raise ValueError(f"frames must be (N, {frame_size}) on {device}, got "
                             f"{tuple(frames.shape)} on {frames.device}")

    if backend == "cuda":
        wd = torch.bfloat16 if weight_dtype is None else weight_dtype
        init_cache, joined = join_halves(mega_encoder(codec_gen, wd, vq),
                                         vocoder_half(voc, wd, vq), 1, device, frame_size)

        @torch.no_grad()
        def run(cache, frames):
            check(frames)
            out, new_cache = joined(cache, frames[:, None])[:2]
            return out[:, 0], new_cache

        run.init_cache = init_cache
        run.backend = "cuda"
        return run

    flat_cb = codec_gen.flat_codebook(vq) if vq is not None else None

    @torch.no_grad()
    def run(cache, frames):
        check(frames)
        ys = []
        for frame in frames:
            z, enc_cache = codec_gen.encode_step(cache["codec"], frame[None, :, None])
            if vq is not None:
                z = codec_gen.lookup(flat_cb, codec_gen.quantize(vq, z))
            y, voc_cache = voc.step(cache["voc"], z)
            cache = {"codec": {**cache["codec"], **enc_cache}, "voc": voc_cache}
            ys.append(y[0, :, 0])
        return torch.stack(ys), cache

    run.init_cache = lambda: {"codec": codec_gen.init_cache(1), "voc": voc.init_cache(1)}
    run.backend = "eager"
    return run


class VocoderReceiver:
    """Rx side of a vocoder-paired preset: wire codes (L, B, T) int32 (or
    encoder features (B, T, D) without PQC) -> codebook lookup in the
    transmitter's books -> HiFiGAN streaming decode -> audio (B, T *
    total_upsample, 1). The ``'cuda'`` route (``'auto'`` on the card, any
    ``batch``) runs the vocoder half (ops/vocoder_kernel.py), 23 launches a
    call (43 for a MultiReceptiveField receiver), and raises where it cannot
    run; ``'eager'`` the plain modules.
    The cache does not depend on T, so a long priming call and the frames
    after it share it. A code outside its book's range raises ValueError, as
    :class:`StreamingReceiver`'s does (codes on the card: at the next
    ``decode`` after this one has finished there)."""

    def __init__(self, codec_gen, vocoder, vq_state, batch: int = 1, backend: str = "auto",
                 weight_dtype=None, device="cuda"):
        self.device = _check_endpoint(vocoder, device)
        codec_gen.check_vq_state(vq_state)
        if batch < 1:
            raise ValueError(f"batch must be at least 1, got {batch}")
        self.codec_gen, self.vocoder, self.batch = codec_gen, vocoder, batch
        self.use_pqc = codec_gen.use_pqc
        vq = _vq_on(vq_state, self.device) if self.use_pqc else None
        self.backend = _endpoint_route(backend, self.device, codec_gen, "VocoderReceiver",
                                       vocoder, vocoder.total_upsample)
        if self.backend == "cuda":
            wd = torch.bfloat16 if weight_dtype is None else weight_dtype
            self._half = vocoder_half(vocoder, wd, vq)
        else:
            self.flat_cb = codec_gen.flat_codebook(vq) if self.use_pqc else None
        self.reset_buffer()

    def reset_buffer(self):
        if self.backend == "cuda":
            self.cache = init_half_cache((self._half,), self.batch, self.device)
        else:
            self.cache = self.vocoder.init_cache(self.batch)

    def initial_decoder(self, idx):
        return self.decode(idx)

    @torch.no_grad()
    def decode(self, idx: torch.Tensor) -> torch.Tensor:
        if self.use_pqc and (idx.device.type == "cpu" or self.backend != "cuda"):
            _check_wire_codes(self.codec_gen, idx)  # host codes: before the upload, no card wait
        idx = idx.to(self.device)
        if self.backend == "cuda":
            # codes already on the card: codebook_lookup records a bad one,
            # which raises at the next decode after this one has finished
            wire = idx.permute(1, 2, 0) if self.use_pqc else idx
            y, new_cache = self._half.run(self.cache, wire.contiguous())
            self.cache.update(new_cache)
            return y
        if self.use_pqc:
            idx = self.codec_gen.lookup(self.flat_cb, idx)
        y, self.cache = self.vocoder.step(self.cache, idx)
        return y


class AudioCodec:
    """A transmitter and a receiver around one generator (JAX
    ``AudioCodec``, bin/stream.py AudioCodec / utils/audiodec.py AudioDec).
    Pass prebuilt ``tx`` / ``rx`` to pair other endpoints (a transmitter
    with a :class:`VocoderReceiver`, the v0-v3 presets); the int32 wire
    codes are what crosses between them. ``tx_device`` / ``rx_device``
    (``device`` by default) place the endpoints on distinct devices
    (reference bin/stream.py:26-35): each gets the generator there (a copy
    where it lies elsewhere), and the codes (encoder features without PQC)
    cross between them on the host."""

    def __init__(self, gen, vq_state, batch: int = 1, receptive_length: int | None = None,
                 tx=None, rx=None, device="cuda", tx_device=None, rx_device=None):
        self.gen = gen
        tx_device = resolve_device(device if tx_device is None else tx_device)
        rx_device = resolve_device(device if rx_device is None else rx_device)
        self.tx_encoder = tx or StreamingTransmitter(replica(gen, tx_device), vq_state, batch,
                                                     device=tx_device)
        self.rx_encoder = rx or StreamingReceiver(replica(gen, rx_device), vq_state, batch,
                                                  device=rx_device)
        self.receptive_length = receptive_length or gen.receptive_length

    def load(self):
        """Prime both sides' caches with a zero receptive field
        (bin/stream.py:56-77)."""
        codes = self.tx_encoder.initial_encoder(self.receptive_length)
        self.rx_encoder.initial_decoder(codes)

    def reset(self):
        self.tx_encoder.reset_buffer()
        self.rx_encoder.reset_buffer()

    def _encode(self, x):
        return self.tx_encoder.encode(x)

    def _decode(self, idx):
        return self.rx_encoder.decode(idx)


class AudioCodecStreamer(AudioCodec):
    """Full-duplex streamer (JAX ``AudioCodecStreamer``, bin/stream.py:
    107-365): audio frames (B, F, C) in -> tx thread -> wire codes -> rx
    thread -> audio out, with latency tracking, frame drops when a frame's
    latency exceeds ``max_latency``, and zeros on underflow.

    ``fused=True`` (the default, with one generator, no custom endpoints
    and ``tx_device`` the same as ``rx_device``) runs one worker on
    ``make_scan_stream(gen, vq_state, batch, frame_size=frame_size)``: on
    the card the kernel route, the function of the JAX package's jitted
    ``_fused`` step (encode, quantize, lookup, decode) in one dispatch a
    frame. Its per-side times are the frame time split by a ratio, labelled
    so in ``stats()``: 50/50, or with ``calibrate_split=True`` the share the
    encoder took of separate encode and decode calls timed at
    :meth:`warmup`. Otherwise (the endpoints on distinct devices, custom
    endpoints or ``fused=False``) the tx and rx endpoints run in two threads
    and the wire codes cross on the host. The worker fences each frame by
    copying its result to the host, as the JAX streamer fetches it."""

    CALIBRATION_CALLS = 16  # timed encode / decode calls a side for calibrate_split

    def __init__(self, gen, vq_state, *, frame_size: int = 1200, sample_rate: int = 48000,
                 max_latency: float = 0.1, batch: int = 1,
                 receptive_length: int | None = None, input_dump=None, output_dump=None,
                 fused: bool = True, calibrate_split: bool = False, tx=None, rx=None,
                 device="cuda", tx_device=None, rx_device=None):
        super().__init__(gen, vq_state, batch, receptive_length, tx=tx, rx=rx, device=device,
                         tx_device=tx_device, rx_device=rx_device)
        if frame_size <= 0 or frame_size % gen.hop:
            raise ValueError(f"frame_size {frame_size} must be a positive multiple of the "
                             f"hop {gen.hop}")
        self.fused = (fused and tx is None and rx is None
                      and self.tx_encoder.device == self.rx_encoder.device)
        self.batch = batch
        if self.fused:
            self._fused_run = make_scan_stream(self.tx_encoder.gen, vq_state, batch,
                                               frame_size=frame_size,
                                               device=self.tx_encoder.device)
            self._fused_cache = self._fused_run.init_cache()
        self.frame_size = frame_size
        self.sample_rate = sample_rate
        self.max_latency = max_latency
        self.encoder_queue: queue.Queue = queue.Queue()
        self.decoder_queue: queue.Queue = queue.Queue()
        self.output_queue: queue.Queue = queue.Queue()
        self.enc_times: list[float] = []
        self.dec_times: list[float] = []
        self.fused_times: list[float] = []
        # the fused frame time's share given to the tx side: 50/50, or
        # measured at warmup() from separate encode and decode calls
        self._enc_frac = 0.5
        self._calibrate_split = calibrate_split
        self.latencies: list[float] = []
        self.frame_drops = 0
        self.n_frames = 0
        self.input_dump = [] if input_dump else None
        self.output_dump = [] if output_dump else None
        self._stop = threading.Event()
        # frames inside the pipeline (enqueued, not yet emitted or dropped),
        # including one a worker is processing
        self._inflight = 0
        self._inflight_lock = threading.Lock()

    def _zeros(self, length: int) -> torch.Tensor:
        return torch.zeros((self.batch, length, self.gen.input_channels),
                           device=self.tx_encoder.device)

    def load(self):
        """Prime the caches with a zero receptive field (rounded up to whole
        code frames). The fused mode runs whole frames of zeros, at least
        the receptive length, in one dispatch: the model is causal with a
        finite receptive field, so past it the caches no longer depend on
        how many zeros came, and they equal the JAX streamer's, which
        primes with one chunk of the receptive length."""
        if not self.fused:
            return super().load()
        n = -(-self.receptive_length // self.frame_size)
        zeros = torch.zeros((n, self.batch, self.frame_size, self.gen.input_channels),
                            device=self.tx_encoder.device)
        _, self._fused_cache = self._fused_run(self._fused_run.init_cache(), zeros)

    def reset(self):
        super().reset()
        if self.fused:
            self._fused_cache = self._fused_run.init_cache()

    def warmup(self):
        """Run one frame of zeros through the frame-shaped steps (the
        kernels are built at their first launch), then restore the caches.
        In the fused mode with ``calibrate_split``, also time
        ``CALIBRATION_CALLS`` separate encode and decode calls on the
        endpoints (each fenced by a copy to the host; a first pair, which
        builds, not counted) and take the encoder's share of the two sides'
        median times as the split of the fused frame time. JAX ``warmup``
        (stream/runtime.py:695-712) sums 3 calls a side; on a host-bound
        path the share of so few calls moves from run to run, so the port
        takes medians of more."""
        zeros = self._zeros(self.frame_size)
        tx_cache, rx_cache = dict(self.tx_encoder.cache), dict(self.rx_encoder.cache)
        if self.fused:
            self._fused_run(self._fused_cache, zeros[None])[0].cpu()
            if self._calibrate_split:
                self._decode(self._encode(zeros).cpu()).cpu()
                enc_t, dec_t = [], []
                for _ in range(self.CALIBRATION_CALLS):
                    t0 = time.perf_counter()
                    idx = self._encode(zeros).cpu()
                    t1 = time.perf_counter()
                    self._decode(idx).cpu()
                    enc_t.append(t1 - t0)
                    dec_t.append(time.perf_counter() - t1)
                enc, dec = float(np.median(enc_t)), float(np.median(dec_t))
                if enc + dec > 0:
                    self._enc_frac = enc / (enc + dec)
        else:
            self._decode(self._encode(zeros)).cpu()
        self.tx_encoder.cache, self.rx_encoder.cache = tx_cache, rx_cache

    # ---------------- worker threads (bin/stream.py:184-239) ----------------

    def _run_fused(self, frame: torch.Tensor) -> torch.Tensor:
        frame = frame.to(self.tx_encoder.device)
        y, self._fused_cache = self._fused_run(self._fused_cache, frame[None])
        return y[0]

    def _encoder_worker(self):
        while not self._stop.is_set():
            try:
                frame, t_in = self.encoder_queue.get(timeout=0.1)
            except queue.Empty:
                continue
            t0 = time.perf_counter()
            if self.fused:
                y = self._run_fused(frame).cpu().numpy()  # the copy fences the frame
                dt = time.perf_counter() - t0
                self.fused_times.append(dt)
                self.enc_times.append(dt * self._enc_frac)
                self.dec_times.append(dt * (1.0 - self._enc_frac))
                self.output_queue.put((y, t_in))
                continue
            # the wire codes cross to the rx thread on the host, as the
            # reference sends indices between threads (audiodec.py:96-103)
            idx = self._encode(frame).cpu()
            self.enc_times.append(time.perf_counter() - t0)
            self.decoder_queue.put((idx, t_in))

    def _decoder_worker(self):
        while not self._stop.is_set():
            try:
                idx, t_in = self.decoder_queue.get(timeout=0.1)
            except queue.Empty:
                continue
            t0 = time.perf_counter()
            y = self._decode(idx).cpu().numpy()
            self.dec_times.append(time.perf_counter() - t0)
            self.output_queue.put((y, t_in))

    # ---------------- frame processing (bin/stream.py:242-282) --------------

    def _process(self, indata: np.ndarray) -> np.ndarray:
        """One audio-callback step: enqueue the input frame, dequeue an
        output frame (zeros on underflow), and flush the queues when its
        latency exceeds the bound (frame dropping, bin/stream.py:253-267)."""
        self.n_frames += 1
        if self.input_dump is not None:
            self.input_dump.append(indata.copy())
        with self._inflight_lock:
            self._inflight += 1
        self.encoder_queue.put((torch.from_numpy(np.array(indata, np.float32)),
                                time.perf_counter()))
        try:
            out, t_in = self.output_queue.get_nowait()
            with self._inflight_lock:
                self._inflight -= 1
            latency = time.perf_counter() - t_in
            self.latencies.append(latency)
            if latency > self.max_latency:
                dropped = self._flush_queues()
                self.frame_drops += dropped
                with self._inflight_lock:
                    self._inflight -= dropped
        except queue.Empty:
            out = np.zeros_like(indata)
        if self.output_dump is not None:
            self.output_dump.append(out.copy())
        return out

    def _flush_queues(self) -> int:
        dropped = 0
        for q in (self.encoder_queue, self.decoder_queue, self.output_queue):
            while True:
                try:
                    q.get_nowait()
                    dropped += 1
                except queue.Empty:
                    break
        return dropped

    # ---------------- run modes ----------------

    def _start_workers(self):
        threads = [threading.Thread(target=self._encoder_worker, daemon=True),
                   threading.Thread(target=self._decoder_worker, daemon=True)]
        for t in threads:
            t.start()
        return threads

    def run_array(self, audio: np.ndarray, realtime: bool = False,
                  drain_timeout: float = 10.0) -> np.ndarray:
        """Drive the streamer from an in-memory array (B, T, C), the
        file-driven analogue of the live loop: returns (B, T', C) with T' the
        frames emitted (zeros where the pipeline underflowed)."""
        self.warmup()
        threads = self._start_workers()
        outs = []
        n = audio.shape[1] // self.frame_size
        frame_time = self.frame_size / self.sample_rate
        try:
            for i in range(n):
                t0 = time.perf_counter()
                outs.append(self._process(audio[:, i * self.frame_size:
                                                (i + 1) * self.frame_size]))
                if realtime:
                    dt = time.perf_counter() - t0
                    if dt < frame_time:
                        time.sleep(frame_time - dt)
            # drain every frame still in flight (in a queue or in a worker)
            deadline = time.perf_counter() + drain_timeout
            while self._inflight > 0 and time.perf_counter() < deadline:
                try:
                    out, t_in = self.output_queue.get(timeout=0.1)
                except queue.Empty:
                    continue
                self.latencies.append(time.perf_counter() - t_in)
                outs.append(out)
                with self._inflight_lock:
                    self._inflight -= 1
        finally:
            self._stop.set()
            for t in threads:
                t.join(timeout=1.0)
        return np.concatenate(outs, axis=1) if outs else np.zeros_like(audio[:, :0])

    def run(self, latency: float = 0.1, duration: float | None = None):
        """Live loop on the sound card (bin/stream.py:335-365); needs the
        optional ``sounddevice`` package and audio hardware."""
        try:
            import sounddevice as sd
        except ImportError as e:
            raise RuntimeError("sounddevice is not available in this environment; use "
                               "run_array() for file-driven streaming") from e
        self.warmup()
        self._start_workers()

        def callback(indata, outdata, frames, time_info, status):
            if status:
                logger.warning("%s", status)
            outdata[:] = self._process(indata[None, :, :1].astype(np.float32))[0]

        with sd.Stream(channels=1, samplerate=self.sample_rate, blocksize=self.frame_size,
                       latency=latency, callback=callback):
            if duration is None:
                input("Streaming... press Enter to stop.\n")
            else:
                time.sleep(duration)
        self._stop.set()

    # ---------------- stats (bin/stream.py:284-310) ----------------

    def stats(self) -> dict:
        def ms(xs):
            return (float(np.mean(xs) * 1e3), float(np.std(xs) * 1e3)) if xs else (0.0, 0.0)

        enc_mean, enc_std = ms(self.enc_times)
        dec_mean, dec_std = ms(self.dec_times)
        lat_mean, lat_std = ms(self.latencies)
        out = {
            "encoder_ms_mean": enc_mean, "encoder_ms_std": enc_std,
            "decoder_ms_mean": dec_mean, "decoder_ms_std": dec_std,
            "latency_ms_mean": lat_mean, "latency_ms_std": lat_std,
            "frame_drops": self.frame_drops,
            "frames": self.n_frames,
            "drop_pct": 100.0 * self.frame_drops / max(self.n_frames, 1),
        }
        if self.fused_times:
            fused_mean, fused_std = ms(self.fused_times)
            # the per-side numbers above are the fused frame time split by a
            # ratio (calibrated at warmup, or the 50/50 estimate)
            out.update(fused_ms_mean=fused_mean, fused_ms_std=fused_std,
                       timing_mode=("fused-calibrated-split" if self._calibrate_split
                                    else "fused-estimated-split"),
                       enc_frac=self._enc_frac)
        else:
            out["timing_mode"] = "per-side"
        return out
