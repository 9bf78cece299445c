"""Closed-loop fleet serving: ``streams`` streams advance one frame a
dispatch, their caches carried from the first dispatch to the last.

A dispatch uploads every stream's next frame from one pinned host buffer,
calls the fleet, brings the audio (and any wire codes) back to pinned host
memory and waits for it: its latency on the host clock covers all four.
Each stream plays its own seeded noisy-speech signal of ``signal_seconds``
in a loop. The next dispatch starts when the last has returned.

Traffic keys: ``driver`` ("fleet"), ``streams``, ``frame_samples``,
``signal_seconds``, ``snr_db``, ``warmup_dispatches``, ``checked_streams``,
``trace_seconds``. Configuration keys: ``model`` (``"denoiser"``: the
without-PQC AudioDec through ``parallel/serve.py::make_sharded_stream``;
``"codec_hifigan"``: the symAD codec's encoder half joined to the HiFiGAN
receiver, the pair ``make_sharded_stream(codec, vq, vocoder=...)`` builds on
one card, called through ``join_halves`` because the fleet's ``run`` drops
the wire codes the check reads), ``sample_rate``, ``generator_params``,
``vocoder_params``, ``codebook_warmup_frames``, ``weight_dtype`` and
``limits``.

The check (after the window, the program's state freed): a sample of
``checked_streams`` streams drawn from the seed, every frame each was served
from the first warm-up dispatch on, against the plain reference over the
stream's whole input. ``audio_err``: the largest gap between a served
sample and the reference's, over that stream's largest reference sample,
the worst stream. With codes, ``code_gap``: how far each served code lies
from the nearest codeword of the reference's residual (reference/
audiodec.py::code_gaps), and the audio is the reference receiver's on the
served codes.
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from port_bench import flops, weights
from port_bench.reference import audiodec as ref_ad
from port_bench.reference import hifigan as ref_voc
from port_bench.trace import counter_delta, launch_counters, profile, profiler_events
from port_bench.trace import reduce_trace, span
from port_bench.traffic import noisy_speech

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
CHECK_BLOCK = 4  # streams the reference runs at once


class Fleet(NamedTuple):
    run: Callable  # (cache, frames (1, B, F)) -> (audio (1, B, F), cache, codes or None)
    init_cache: Callable
    state: dict  # the generator's (or codec's) weights as the benchmark made them
    voc_state: dict | None
    books: torch.Tensor | None  # (L, D, K)
    sites: list  # flops.py's (kernel, site, flops, bytes) of one dispatch
    model_flops: float  # of one dispatch


def vocoder_params(config) -> dict:
    """The published HiFiGAN ``generator_params`` as the port's constructor
    and the reference take them."""
    vp = dict(config["vocoder_params"])
    if vp.pop("nonlinear_activation") != "LeakyReLU":
        raise ValueError("the receiver's activation must be LeakyReLU")
    vp["negative_slope"] = vp.pop("nonlinear_activation_params")["negative_slope"]
    vp.pop("use_weight_norm")
    vp.pop("stats")
    return vp


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class SetupStages:
    """Seconds of set-up from ``t_start`` (``time.time()`` at the process's
    start) to the end of each named stage; a call returns the total so far."""

    def __init__(self, t_start: float):
        self.t_start, self.seconds = t_start, {}

    def __call__(self, name: str) -> float:
        total = time.time() - self.t_start
        self.seconds[name] = total
        return total


@torch.no_grad()
def codebooks(state, gp, frames: int, frame: int, config, seed: int, device):
    """Residual-VQ books as a k-means init draws them (the port's
    ``chip_smoke.py::codec_vq_state``, over the reference encoder): book by
    book, K rows drawn from the residuals of a seeded warm-up stream, which
    then move on by their nearest codeword, so every book draws from rows no
    earlier book drew and the search meets realistic near ties."""
    x, _ = noisy_speech(1, frames * frame, seed, config["snr_db"], config["sample_rate"],
                        device)
    r = ref_ad.project(state, ref_ad.encode(state, gp, x[:, None, :]))[0].t().contiguous()
    n_books, k = gp["codebook_num"], gp["codebook_size"]
    if r.shape[0] < (n_books + 1) * k:
        raise ValueError("codebook warm-up stream too short")
    pick = torch.Generator(device=device).manual_seed(seed + 1)
    books = []
    for _ in range(n_books):
        order = torch.randperm(r.shape[0], generator=pick, device=device)
        book = r[order[:k]].t().contiguous()
        r = r[order[k:]]
        dist = (r * r).sum(1, keepdim=True) - 2.0 * (r @ book) + (book * book).sum(0)
        r = r - book.t()[torch.argmin(dist, 1)]
        books.append(book)
    return torch.stack(books)


def build(config, traffic, seed: int, device, weight_dtype) -> Fleet:
    from dl_speech_enhancement_tpu_torch.models import AudioDecGenerator
    from dl_speech_enhancement_tpu_torch.ops.mega_kernel import (
        join_halves, mega_decoder, mega_encoder)
    from dl_speech_enhancement_tpu_torch.parallel.serve import make_sharded_stream

    gp, b, frame = config["generator_params"], traffic["streams"], traffic["frame_samples"]
    if config["model"] == "denoiser":
        state = weights.audiodec_state(gp, False, seed, device)
        gen = AudioDecGenerator(**gp, use_pqc=False, device=device)
        gen.load_state_dict(state)
        if weight_dtype == torch.float32:
            fleet = make_sharded_stream(gen, None, batch=b, device=device)

            def run(cache, x):
                audio, cache = fleet(cache, x[..., None])
                return audio[..., 0], cache, None

            init = fleet.init_cache
        else:  # the port's bf16-weight arms, behind the same halves
            init, halves = join_halves(mega_encoder(gen, weight_dtype),
                                       mega_decoder(gen, weight_dtype), b, device)

            def run(cache, x):
                return (*halves(cache, x), None)

        return Fleet(run, init, state, None, None,
                     flops.encoder_sites(gp, frame, b) + flops.decoder_sites(gp, frame, b),
                     b * flops.audiodec_model_flops(gp, frame))
    if config["model"] != "codec_hifigan":
        raise ValueError(f"unknown fleet model {config['model']!r}")
    from dl_speech_enhancement_tpu_torch.models.hifigan import HiFiGANGenerator
    from dl_speech_enhancement_tpu_torch.nn.vq import VQState
    from dl_speech_enhancement_tpu_torch.ops.vocoder_kernel import vocoder_half

    vp = vocoder_params(config)
    state = weights.audiodec_state(gp, True, seed, device)
    voc_state = weights.hifigan_state(vp, seed + 1, device)
    books = codebooks(state, gp, config["codebook_warmup_frames"], frame, config, seed + 2,
                      device)
    codec = AudioDecGenerator(**gp, use_pqc=True, device=device)
    codec.load_state_dict(state)
    placeholder = np.zeros((2, vp["in_channels"]), np.float32)  # the state holds the real ones
    voc = HiFiGANGenerator(**vp, stats=placeholder, device=device)
    voc.load_state_dict(voc_state)
    vq = VQState(books, torch.zeros(books.shape[0], books.shape[2], device=device),
                 books.clone())
    init, run = join_halves(mega_encoder(codec, weight_dtype, vq),
                            vocoder_half(voc, weight_dtype, vq), b, device)
    rows, pqc = frame // flops.hop(gp), dict(gp, use_pqc=True)
    return Fleet(run, init, state, voc_state, books,
                 flops.encoder_sites(pqc, frame, b)
                 + flops.vocoder_sites(vp, rows, b, gp["codebook_num"], gp["codebook_size"]),
                 b * (flops.audiodec_model_flops(pqc, frame, decoder=False)
                      + flops.vocoder_model_flops(vp, rows)))


class Served:
    """What the served streams under check were given and gave back."""

    def __init__(self, picked):
        self.picked = picked
        self.audio, self.codes = [], []


def serve(fleet, host_in, picked, device):
    """``dispatch(k, traced) -> (latency s, host call s)``: dispatch ``k``
    plays frame ``k`` of the loop (host_in (frames, B, F), pinned on the
    card's host)."""
    n_loop, b, frame = host_in.shape
    cuda = device.type == "cuda"
    x_dev = torch.empty((1, b, frame), device=device)
    out_host = torch.empty((b, frame), pin_memory=cuda)
    out_np, rows = out_host.numpy(), picked.numpy()
    codes_host = None
    run = fleet.run
    served = Served(picked)
    cache = [fleet.init_cache()]

    def dispatch(k, traced=False):
        nonlocal codes_host
        t0 = time.perf_counter()
        with span("upload", traced):
            x_dev.copy_(host_in[k % n_loop][None], non_blocking=True)
        with span("enqueue", traced):
            t1 = time.perf_counter()
            audio, cache[0], codes = run(cache[0], x_dev)
            t2 = time.perf_counter()
        with span("download", traced):
            out_host.copy_(audio.reshape(b, frame), non_blocking=True)
            if codes is not None:
                if codes_host is None:
                    codes_host = torch.empty(codes.shape[1:], dtype=codes.dtype, pin_memory=cuda)
                codes_host.copy_(codes[0], non_blocking=True)
        with span("sync", traced):
            sync(device)
        t3 = time.perf_counter()
        served.audio.append(out_np[rows])  # numpy's fancy index copies
        if codes is not None:
            served.codes.append(codes_host.numpy()[rows])
        return t3 - t0, t2 - t1

    return dispatch, served


@torch.no_grad()
def check(config, fleet_parts, served, host_in, device) -> list:
    """``[(name, value, limit)]`` of the served streams under check against
    the reference. ``fleet_parts``: (state, voc_state, books)."""
    state, voc_state, books = fleet_parts
    gp, limits = config["generator_params"], config["limits"]
    n = len(served.audio)
    n_loop, _, frame = host_in.shape
    audio = torch.from_numpy(np.stack(served.audio, 1))  # (S, n, F)
    idx = torch.arange(n) % n_loop
    worst_audio, worst_gap = 0.0, 0.0
    for s0 in range(0, len(served.picked), CHECK_BLOCK):
        picked = served.picked[s0:s0 + CHECK_BLOCK]
        x = host_in[:, picked][idx].permute(1, 0, 2).reshape(len(picked), 1, n * frame)
        x = x.to(device)
        got = audio[s0:s0 + len(picked)].reshape(len(picked), -1).to(device)
        if books is None:
            want = ref_ad.denoise(state, gp, x)[:, 0]
        else:
            codes = torch.from_numpy(np.stack(served.codes, 1)[s0:s0 + len(picked)])
            codes = codes.reshape(len(picked), -1, codes.shape[-1]).to(device)  # (S, rows, L)
            z = ref_ad.project(state, ref_ad.encode(state, gp, x)).transpose(1, 2)
            gaps = ref_ad.code_gaps(z.reshape(-1, z.shape[-1]), books,
                                    codes.reshape(-1, codes.shape[-1]))
            worst_gap = max(worst_gap, float(gaps.max()))
            zq = ref_ad.lookup(books, codes.reshape(-1, codes.shape[-1]))
            zq = zq.reshape(len(picked), -1, zq.shape[-1]).transpose(1, 2)
            want = ref_voc.receive(voc_state, vocoder_params(config), zq)[:, 0]
        err = (got - want).abs().amax(1) / want.abs().amax(1).clamp_min(1e-30)
        worst_audio = max(worst_audio, float(err.max()))
        del x, got, want
    out = [("audio_err", worst_audio, limits["audio_err"])]
    if books is not None:
        out.append(("code_gap", worst_gap, limits["code_gap"]))
    return out


def run(*, config, traffic, seed: int, seconds: float, trace: bool, device, t_start: float,
        weight_dtype=None) -> dict:
    """One run of a fleet cell; see the module's docstring. ``weight_dtype``
    (default the configuration's) serves the control."""
    wd = weight_dtype or DTYPES[config["weight_dtype"]]
    stages = SetupStages(t_start)
    stages("imports")
    if device.type == "cuda":
        from dl_speech_enhancement_tpu_torch.ops import _cuda
        _cuda.build()
    stages("build")
    cfg = dict(config, snr_db=traffic["snr_db"])
    b, frame = traffic["streams"], traffic["frame_samples"]
    fleet = build(cfg, traffic, seed, device, wd)
    sync(device)
    stages("model")
    n_loop = int(traffic["signal_seconds"] * config["sample_rate"]) // frame
    mixed, _ = noisy_speech(b, n_loop * frame, seed + 4, traffic["snr_db"],
                            config["sample_rate"], device)
    host_in = torch.empty((n_loop, b, frame), pin_memory=device.type == "cuda")
    host_in.copy_(mixed.view(b, n_loop, frame).transpose(0, 1))
    del mixed
    stages("traffic")
    pick = torch.Generator().manual_seed(seed + 5)
    picked = torch.randperm(b, generator=pick)[:traffic["checked_streams"]].sort().values
    dispatch, served = serve(fleet, host_in, picked, device)
    for k in range(traffic["warmup_dispatches"]):
        dispatch(k)
    setup_s = stages("warmup")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    k0 = k = traffic["warmup_dispatches"]
    before = launch_counters()
    lat, host_s = [], 0.0
    w0 = time.perf_counter()
    while time.perf_counter() - w0 < seconds:
        latency, host = dispatch(k)
        lat.append(latency)
        host_s += host
        k += 1
    window = time.perf_counter() - w0
    launches = counter_delta(before, launch_counters())
    n = k - k0
    audio_s = n * b * frame / config["sample_rate"]
    out = {"attempted": n, "failed": 0,
           "e2e": {"rt_streams": audio_s / window,
                   "dispatch_p95_ms": 1e3 * float(np.percentile(lat, 95)),
                   "setup_s": setup_s},
           "window": {"calls": n, "window_s": window, "setup_stages": stages.seconds,
                      "dispatch_p50_ms": 1e3 * float(np.percentile(lat, 50)),
                      "dispatch_p99_ms": 1e3 * float(np.percentile(lat, 99)),
                      "dispatch_max_ms": 1e3 * max(lat), "dispatch_sum_s": sum(lat)}}
    if trace:
        k1 = k
        with profile(device) as prof:
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < traffic["trace_seconds"]:
                dispatch(k, traced=True)
                k += 1
        reduced = reduce_trace(profiler_events(prof))
        out["window"]["traced_calls"] = k - k1
        out["record"] = {"kind": "serve", "calls": n, "window_s": window,
                         "host_call_s": host_s, "launches": launches,
                         "model_flops": n * fleet.model_flops, "sites": fleet.sites,
                         "trace": reduced, "traced_calls": k - k1}
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                if device.type == "cuda" else 0)
    parts = (fleet.state, fleet.voc_state, fleet.books)
    del fleet, dispatch
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out["checks"] = check(config, parts, served, host_in, device)
    return out


def control_arguments() -> dict:
    """The control that the check has to fail: the port's bf16-weight arms."""
    return {"weight_dtype": torch.bfloat16}
