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

``AudioCodec``, ``AudioCodecStreamer`` and the CLI are later slices
(ROADMAP.md).
"""

from __future__ import annotations

import torch

from dl_speech_enhancement_tpu_torch.nn.vq import VQState
from dl_speech_enhancement_tpu_torch.ops.mega_kernel import (
    make_mega_stream_batched,
    mega_topology_error,
)
from dl_speech_enhancement_tpu_torch.ops.stream_kernel import make_fused_chunk_step
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
            q = self.gen.quantizer
            base = (torch.arange(q.codebook_num, device=self.device) * q.codebook_size).reshape(
                -1, *[1] * (idx.dim() - 1))
            if idx.shape[0] != q.codebook_num or bool(
                    ((idx < base) | (idx >= base + q.codebook_size)).any()):
                raise ValueError(f"wire codes {tuple(idx.shape)} hold a code outside its "
                                 f"book's range [l*K, (l+1)*K), K={q.codebook_size}")
        zq = self.gen.lookup(self.flat_cb, idx) if self.use_pqc else idx
        y, new_cache = self.gen.decode_step(self.cache, zq)
        self.cache.update(new_cache)
        return y
