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

``AudioCodec``, ``AudioCodecStreamer`` and the CLI are later slices
(ROADMAP.md).
"""

from __future__ import annotations

import torch

from dl_speech_enhancement_tpu_torch.nn.vq import VQState
from dl_speech_enhancement_tpu_torch.ops.mega_kernel import (
    init_half_cache,
    join_halves,
    make_mega_stream_batched,
    mega_encoder,
    mega_topology_error,
)
from dl_speech_enhancement_tpu_torch.ops.stream_kernel import make_fused_chunk_step
from dl_speech_enhancement_tpu_torch.ops.vocoder_kernel import (
    vocoder_half,
    vocoder_topology_error,
)
from dl_speech_enhancement_tpu_torch.utils.device import resolve_device

BACKENDS = ("auto", "cuda", "cuda_chain", "eager")


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


class StreamingTransmitter:
    """Tx side of the codec: audio chunk (B, T, C) -> flattened wire codes
    (L, B, T / hop) int32 (with PQC) or encoder features (without), through
    the plain modules on ``device``, as the JAX transmitter runs an XLA step.
    Caches carry across ``encode`` calls."""

    def __init__(self, gen, vq_state: VQState | None, batch: int = 1, device="cuda"):
        self.gen = gen
        self.device = _check_endpoint(gen, device)
        self.use_pqc = gen.use_pqc
        gen.check_vq_state(vq_state)
        self.vq_state = _vq_on(vq_state, self.device) if self.use_pqc else None
        self.batch = batch
        self.reset_buffer()

    def reset_buffer(self):
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
        z, new_cache = self.gen.encode_step(self.cache, chunk.to(self.device))
        self.cache.update(new_cache)
        return self.gen.quantize(self.vq_state, z) if self.use_pqc else z


class StreamingReceiver:
    """Rx side of the codec: wire codes (L, B, T_code) int32 (or encoder
    features without PQC) -> audio (B, T, C), through the plain modules on
    ``device``. Codes from a transmitter on another device are moved here
    first; a code outside its book's range raises ValueError. Caches carry
    across ``decode`` calls."""

    def __init__(self, gen, vq_state: VQState | None, batch: int = 1, device="cuda"):
        self.gen = gen
        self.device = _check_endpoint(gen, device)
        self.use_pqc = gen.use_pqc
        gen.check_vq_state(vq_state)
        self.flat_cb = (gen.flat_codebook(_vq_on(vq_state, self.device))
                        if self.use_pqc else None)
        self.batch = batch
        self.reset_buffer()

    def reset_buffer(self):
        self.cache = {"decoder": self.gen.init_cache(self.batch)["decoder"]}

    def initial_decoder(self, idx):
        return self.decode(idx)

    @torch.no_grad()
    def decode(self, idx: torch.Tensor) -> torch.Tensor:
        idx = idx.to(self.device)
        if self.use_pqc:
            _check_wire_codes(self.gen, idx)
        zq = self.gen.lookup(self.flat_cb, idx) if self.use_pqc else idx
        y, new_cache = self.gen.decode_step(self.cache, zq)
        self.cache.update(new_cache)
        return y


def _vocoder_route(backend, device, codec_gen, voc, rx_chunk, what):
    """The route a vocoder entry point takes: ``'cuda'`` or ``'eager'``;
    raises where the ``'cuda'`` route cannot run, naming the reason."""
    backend = resolve_scan_backend(backend, on_cuda=device.type == "cuda", batch=1,
                                   use_pqc=codec_gen.use_pqc)
    if backend == "cuda_chain":
        raise ValueError(f"{what} takes 'cuda', 'eager' or 'auto'; 'cuda_chain' runs the "
                         "denoiser alone")
    if backend == "cuda":
        reason = (mega_topology_error(codec_gen, codec_gen.hop)
                  or vocoder_topology_error(voc, rx_chunk, hop=codec_gen.hop))
        if reason:
            raise ValueError(f"{what}'s 'cuda' route cannot run: {reason}; pass "
                             "backend='eager' for the plain modules")
        if device.type != "cuda":
            raise ValueError(f"backend 'cuda' runs CUDA kernels; device is {device}")
    return backend


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
    on the card) raises ValueError where it cannot run (K4's
    MultiReceptiveField arm, a vocoder whose total upsample is not the
    codec's hop)."""
    device = resolve_device(device)
    codec_gen.check_vq_state(vq_state)
    for g in (codec_gen, voc):
        if g.device != device:
            raise ValueError(f"generator is on {g.device}, stream asked for {device}")
    if frame_size <= 0 or frame_size % codec_gen.hop:
        raise ValueError(f"frame_size {frame_size} must be a positive multiple of the "
                         f"codec's hop {codec_gen.hop}")
    rx_chunk = frame_size // codec_gen.hop * voc.total_upsample
    backend = _vocoder_route(backend, device, codec_gen, voc, rx_chunk, "the vocoder stream")
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
    call, and raises where it cannot run; ``'eager'`` the plain modules.
    The cache does not depend on T, so a long priming call and the frames
    after it share it. A code outside its book's range raises ValueError."""

    def __init__(self, codec_gen, vocoder, vq_state, batch: int = 1, backend: str = "auto",
                 weight_dtype=None, device="cuda"):
        self.device = _check_endpoint(vocoder, device)
        codec_gen.check_vq_state(vq_state)
        if batch < 1:
            raise ValueError(f"batch must be at least 1, got {batch}")
        self.codec_gen, self.vocoder, self.batch = codec_gen, vocoder, batch
        self.use_pqc = codec_gen.use_pqc
        vq = _vq_on(vq_state, self.device) if self.use_pqc else None
        self.backend = _vocoder_route(backend, self.device, codec_gen, vocoder,
                                      vocoder.total_upsample, "VocoderReceiver")
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
        idx = idx.to(self.device)
        if self.backend == "cuda":
            # codebook_lookup checks the codes' range on the card
            wire = idx.permute(1, 2, 0) if self.use_pqc else idx
            y, new_cache = self._half.run(self.cache, wire.contiguous())
            self.cache.update(new_cache)
            return y
        if self.use_pqc:
            _check_wire_codes(self.codec_gen, idx)
            idx = self.codec_gen.lookup(self.flat_cb, idx)
        y, self.cache = self.vocoder.step(self.cache, idx)
        return y
