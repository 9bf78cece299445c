"""On-card smoke run of the PyTorch/CUDA port (dl_speech_enhancement_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Two main paths run, each at the full width of its model with seeded random
weights (no trained checkpoint is in the repository): the denoiser (the
without-PQC generator of configs/denoise/symAD_vctk_48000_hop300.yaml) and
the symAD codec (the PQC generator of configs/autoencoder/
symAD_vctk_48000_hop300.yaml, whose codebooks are drawn as a k-means init
draws them, from the residuals of a seeded warm-up stream). Phases (any
failure exits non-zero before the result line):

1. build the five CUDA kernels from ``dl_speech_enhancement_tpu_torch/csrc``
   (one ``nvcc`` each, all at once) and both generators on the card;
2. hold every kernel against its plain PyTorch version at every site of both
   main paths, at 1, 100 (the main paths' dispatch) and 400 frames per
   dispatch, with f32 and bf16 weights; the residual-VQ search up to near
   ties (``utils/checks.py::rvq_near_ties``);
3. drive each main path, ``make_scan_stream(batch=1, frame_size=1200)`` with
   ``backend='auto'`` (which must resolve to the ``'cuda'`` kernel route),
   over 200 frames in two dispatches, with every launch counter set to 0
   just before and read just after. The denoiser is held against the
   ``'eager'`` route on the same card and weights and its first frames
   against the CPU, and its ``'cuda_chain'`` route against ``'eager'``. The
   codec runs through ``run_with_codes`` with f32 weights: its wire codes
   and audio are held against the ``'eager'`` route, the first frames
   against the CPU, and ``StreamingTransmitter``/``StreamingReceiver``
   against the route; every book must use at least 32 codes; the bf16
   route's agreement with it is printed;
4. time per-frame latency at 1 frame per dispatch, the device's busy share
   of it (``torch.profiler``), throughput at 400, and every kernel site at 1,
   100 and 400 frames against its plain version, its bound and its one-call
   PyTorch equivalent (``F.conv1d`` / ``F.conv_transpose1d`` /
   ``F.embedding_bag``, yardsticks the port never calls), with CUDA events.

Prints the per-kernel JSON line (times summed over the kernel's sites in one
100-frame dispatch of the main path that first runs it, the codec's causal
conv sites beside them; launches summed over both paths), the card's name
and power limit, and last ``{"ok": true, "device": {...}}``. The full report
goes to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import copy
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from dl_speech_enhancement_tpu_torch.models import AudioDecGenerator
from dl_speech_enhancement_tpu_torch.nn.vq import VQState
from dl_speech_enhancement_tpu_torch.ops import _cuda
from dl_speech_enhancement_tpu_torch.ops.mega_kernel import (
    causal_conv,
    causal_conv_plain,
    causal_conv_transpose,
    causal_conv_transpose_plain,
    codebook_lookup,
    codebook_lookup_plain,
    conv_transpose_weight,
    conv_weight,
    rvq_assign,
    rvq_assign_plain,
    vq_tables,
)
from dl_speech_enhancement_tpu_torch.ops.stream_kernel import (
    DILATIONS,
    KERNEL_SIZE,
    chain_halo,
    chain_weights,
    residual_chain,
    residual_chain_plain,
)
from dl_speech_enhancement_tpu_torch.stream.runtime import (
    StreamingReceiver,
    StreamingTransmitter,
    make_scan_stream,
)
from dl_speech_enhancement_tpu_torch.utils.checks import rvq_near_ties
from dl_speech_enhancement_tpu_torch.utils.config import load_config

DEVICE = "cuda"  # the card; the port's entry points run there by default
REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(REPO, "configs", "denoise", "symAD_vctk_48000_hop300.yaml")
CODEC_CONFIG = os.path.join(REPO, "configs", "autoencoder", "symAD_vctk_48000_hop300.yaml")
SEED = 0
FRAME = 1200
SAMPLE_RATE = 48000
DISPATCH = 100
MAIN_FRAMES = (DISPATCH, DISPATCH)   # the main path: 200 frames in two dispatches
THROUGHPUT_FRAMES = 400
SIZES = (1, DISPATCH, THROUGHPUT_FRAMES)   # frames per dispatch of the kernel checks
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
F32_FLOPS = 67e12          # H100 SXM f32 rate outside the tensor cores
# Tolerances. Kernel vs plain: the same products summed in another order, up
# to 2560 terms of O(1) values -> atol 1e-4 (f32 weights), and 1e-4 of the
# largest output (bf16 weights, widened to f32 identically on both sides).
# Main path in f32 vs eager (cuDNN, TF32 off) and vs the CPU: 2e-4, the JAX
# package's flagship tolerance. bf16-weight main path vs f32 eager: weight
# rounding (2^-9 relative) through 34 layers -> 5e-2 of the largest output.
KERNEL_ATOL_F32 = 1e-4
KERNEL_RTOL_BF16 = 1e-4
MAIN_ATOL_F32 = 2e-4
MAIN_RTOL_BF16 = 5e-2
# Codec. Wire codes: equal to the reference's except at near ties, where the
# two searches' distances differ by at most 1e-5 * max(1, |min distance|)
# (the same r.E products summed in another order, or z moved by ~1e-6
# between routes). Lookup kernel vs plain: a sum of 8 f32 codewords, 1e-5.
# The codec's audio is held only with f32 weights: a code changed by bf16
# weights moves a frame's audio far more than 5e-2.
CODE_RTOL = 1e-5
LOOKUP_ATOL = 1e-5
MIN_DISTINCT_CODES = 32
WARMUP_FRAMES = 2400  # 9600 code rows: 8 books of 1024 codewords drawn from distinct rows
DENOISER_KERNELS = ("residual_chain", "causal_conv", "causal_conv_transpose")
LAUNCHES_PER_DISPATCH = {"denoiser": 18, "codec": 22}

KERNELS = {
    "residual_chain": {
        "fn": residual_chain,
        "source": "dl_speech_enhancement_tpu_torch/csrc/residual_chain.cu",
        "replaces": "dl_speech_enhancement_tpu/ops/stream_kernel.py:38 (K1; and the "
                    "chains of K2, ops/mega_kernel.py:324,522)",
    },
    "causal_conv": {
        "fn": causal_conv,
        "source": "dl_speech_enhancement_tpu_torch/csrc/causal_conv.cu",
        "replaces": "dl_speech_enhancement_tpu/ops/mega_kernel.py:324 (K2e input conv "
                    "and downsamples, PQC projector :412-417; K2d output conv, :522, "
                    "PQC input conv :561-565)",
    },
    "causal_conv_transpose": {
        "fn": causal_conv_transpose,
        "source": "dl_speech_enhancement_tpu_torch/csrc/causal_conv_transpose.cu",
        "replaces": "dl_speech_enhancement_tpu/ops/mega_kernel.py:522 (K2d upsamples)",
    },
    "rvq_assign": {
        "fn": rvq_assign,
        "source": "dl_speech_enhancement_tpu_torch/csrc/rvq_assign.cu",
        "replaces": "dl_speech_enhancement_tpu/ops/mega_kernel.py:418 (K2e PQC arm: "
                    "residual-VQ search and int32 wire codes, :418-432)",
    },
    "codebook_lookup": {
        "fn": codebook_lookup,
        "source": "dl_speech_enhancement_tpu_torch/csrc/codebook_lookup.cu",
        "replaces": "dl_speech_enhancement_tpu/ops/mega_kernel.py:552 (K2d PQC arm: "
                    "codebook lookup, :552-560)",
    },
}


class Failure(RuntimeError):
    pass


def require(ok: bool, msg: str) -> None:
    if not ok:
        raise Failure(msg)


def log(*parts) -> None:
    print(*parts, flush=True)


def gpu_ms(fn, reps: int, groups: int = 5) -> float:
    """ms per call of ``fn``: CUDA events around ``reps`` calls launched back
    to back, after a warm-up call; the median over ``groups`` such runs.
    Where a call's host work outlasts its kernels this measures the host's
    launch rate; :func:`device_profile` gives the kernels' own time."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(groups):
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / F32_FLOPS, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def chain_flops(channels: int, rows: int) -> float:
    """Operations of one residual chain that outputs ``rows`` rows. Unit u
    must also compute the rows that the later units' dilated taps reach back
    to (the cache holds inputs, not unit outputs)."""
    total = 0
    for u in range(len(DILATIONS)):
        needed = rows + sum((KERNEL_SIZE - 1) * d for d in DILATIONS[u + 1:])
        total += 2.0 * (KERNEL_SIZE + 1) * channels * channels * needed
    return total


# ---------------------------------------------------------------- sites


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def conv_site(name, layer, rows, stride, bias, wd, rand):
    """One causal_conv launch as a site tuple (see :func:`sites`)."""
    cin, cout, k = layer.in_channels, layer.out_channels, layer.kernel_size
    cache, x = rand(layer.pad_length, cin), rand(rows, cin)
    w = conv_weight(layer, wd)
    b = None if not bias else layer.bias.detach().float().contiguous()
    x_lib = torch.cat([cache, x]).t().contiguous()[None]
    w_lib = layer.weight.detach().float()
    t_out = rows // stride
    return ("causal_conv", name,
            lambda: causal_conv(cache, x, w, b, stride),
            lambda: causal_conv_plain(cache, x, w, b, stride),
            lambda: F.conv1d(x_lib, w_lib, b, stride),
            2.0 * t_out * k * cin * cout,
            nbytes(cache, x, w, b) + 4 * t_out * cout)


def sites(gen, n_frames: int, wd, rng: torch.Generator):
    """Every kernel launch of one main-path dispatch of ``n_frames`` frames:
    (kernel, site, kernel call, plain call, library call or None, flops,
    bytes), on random activations of the site's shape and the generator's
    own weights in ``wd``."""

    def rand(*shape):
        return torch.randn(*shape, generator=rng, device=DEVICE) * 0.3

    out = []
    t = n_frames * FRAME
    out.append(conv_site("enc_in", gen.encoder.conv, t, 1, False, wd, rand))
    for bi, blk in enumerate(gen.encoder.blocks):
        c = blk.conv.in_channels
        cache, x = rand(chain_halo(), c), rand(t, c)
        w1, w2 = chain_weights(blk.res_units, wd)
        out.append(("residual_chain", f"e{bi}ch",
                    lambda cache=cache, x=x, w1=w1, w2=w2: residual_chain(cache, x, w1, w2),
                    lambda cache=cache, x=x, w1=w1, w2=w2: residual_chain_plain(cache, x, w1, w2),
                    None, chain_flops(c, t), nbytes(cache, x, w1, w2) + 4 * t * c))
        out.append(conv_site(f"e{bi}d", blk.conv, t, blk.conv.stride, True, wd, rand))
        t //= blk.conv.stride
    for bi, blk in enumerate(gen.decoder.blocks):
        layer, s = blk.conv, blk.conv.stride
        cin, cout = layer.in_channels, layer.out_channels
        cache, x = rand(1, cin), rand(t, cin)
        w, b = conv_transpose_weight(layer, wd), layer.bias.detach().float().contiguous()
        x_lib = torch.cat([cache, x]).t().contiguous()[None]
        w_lib = layer.weight.detach().float()
        out.append(("causal_conv_transpose", f"d{bi}u",
                    lambda cache=cache, x=x, w=w, b=b, s=s: causal_conv_transpose(
                        cache, x, w, b, s),
                    lambda cache=cache, x=x, w=w, b=b, s=s: causal_conv_transpose_plain(
                        cache, x, w, b, s),
                    lambda x_lib=x_lib, w_lib=w_lib, b=b, s=s: F.conv_transpose1d(
                        x_lib, w_lib, b, s, s),
                    2.0 * t * s * 2 * cin * cout, nbytes(cache, x, w, b) + 4 * t * s * cout))
        t *= s
        c = cout
        cache, x = rand(chain_halo(), c), rand(t, c)
        w1, w2 = chain_weights(blk.res_units, wd)
        out.append(("residual_chain", f"d{bi}ch",
                    lambda cache=cache, x=x, w1=w1, w2=w2: residual_chain(cache, x, w1, w2),
                    lambda cache=cache, x=x, w1=w1, w2=w2: residual_chain_plain(cache, x, w1, w2),
                    None, chain_flops(c, t), nbytes(cache, x, w1, w2) + 4 * t * c))
    out.append(conv_site("dec_out", gen.decoder.conv2, t, 1, False, wd, rand))
    return out


def codec_sites(gen, tables, z_real, n_frames: int, wd, rng: torch.Generator):
    """The four launches the codec adds to a dispatch of ``n_frames`` frames
    (projector, rvq_assign, codebook_lookup, decoder input conv), as site
    tuples (see :func:`sites`). The search runs on real projector outputs
    ``z_real`` of the codec and the lookup on their codes."""
    books, sqnorm, books_t = tables
    n_books, dim, book_k = books.shape
    rows = n_frames * FRAME // gen.hop
    z = z_real[:rows].contiguous()
    codes = rvq_assign_plain(z, books, sqnorm)
    codes_lib, flat_cb = codes.long(), books_t.reshape(n_books * book_k, dim)
    used = int(torch.unique(codes).numel())  # codewords this lookup reads

    def rand(*shape):
        return torch.randn(*shape, generator=rng, device=DEVICE) * 0.3

    return [
        conv_site("prj", gen.projector.conv, rows, 1, False, wd, rand),
        ("rvq_assign", "rvq", lambda: rvq_assign(z, books, sqnorm),
         lambda: rvq_assign_plain(z, books, sqnorm), None,
         rows * n_books * (2.0 * dim * book_k + 3.0 * book_k),
         nbytes(z, books, sqnorm, codes)),
        ("codebook_lookup", "lookup", lambda: codebook_lookup(codes, books_t),
         lambda: codebook_lookup_plain(codes, books_t),
         lambda: F.embedding_bag(codes_lib, flat_cb, mode="sum"),
         float(rows * n_books * dim), nbytes(codes) + used * dim * 4 + rows * dim * 4),
        conv_site("dec_in", gen.decoder.conv1, rows, 1, False, wd, rand),
    ]


def check_site(kernel, site, run_kernel, run_plain, n_frames, wd) -> float:
    """A conv or chain site's kernel against its plain version; max |err|."""
    got, ref = run_kernel(), run_plain()
    torch.cuda.synchronize()
    require(got.shape == ref.shape, f"{kernel} {site}: shape {tuple(got.shape)} "
            f"vs plain {tuple(ref.shape)}")
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    limit = KERNEL_ATOL_F32 if wd == torch.float32 else KERNEL_RTOL_BF16 * scale
    require(err <= limit, f"{kernel} {site} n={n_frames} {wd}: max|err| {err} > {limit}")
    log(f"check {kernel:22s} {site:7s} frames={n_frames:<4d} {str(wd):14s} "
        f"max|err|={err:.3e} max|ref|={scale:.3e}")
    return err


def check_kernels(gen, rng):
    """Phase 2, denoiser: every site's kernel against its plain version."""
    worst = {name: 0.0 for name in DENOISER_KERNELS}
    for n_frames in SIZES:
        for wd in (torch.float32, torch.bfloat16):
            for kernel, site, run_kernel, run_plain, _, _, _ in sites(gen, n_frames, wd, rng):
                err = check_site(kernel, site, run_kernel, run_plain, n_frames, wd)
                worst[kernel] = max(worst[kernel], err)
    return worst


def check_codec_kernels(gen, tables, z_real, rng):
    """Phase 2, codec: the search up to near ties, the lookup to
    LOOKUP_ATOL, the projector and input conv as the other convs. Returns
    the worst error per kernel (for the search: the largest distance excess
    of a near-tie pick) and the near-tie rows."""
    books, sqnorm, books_t = tables
    worst = {"causal_conv": 0.0, "rvq_assign": 0.0, "codebook_lookup": 0.0}
    ties = 0
    for n_frames in SIZES:
        rows = n_frames * FRAME // gen.hop
        z = z_real[:rows].contiguous()
        got, ref = rvq_assign(z, books, sqnorm), rvq_assign_plain(z, books, sqnorm)
        torch.cuda.synchronize()
        require(got.shape == ref.shape and got.dtype == torch.int32,
                f"rvq_assign: codes {tuple(got.shape)} {got.dtype} vs plain {tuple(ref.shape)}")
        held = rvq_near_ties(z, books, sqnorm, got, ref, CODE_RTOL)
        require(held["mismatches"] == 0, f"rvq_assign n={n_frames}: {held}")
        ties += held["ties"]
        worst["rvq_assign"] = max(worst["rvq_assign"], held["max_excess"])
        zq, zq_ref = codebook_lookup(ref, books_t), codebook_lookup_plain(ref, books_t)
        torch.cuda.synchronize()
        err = float((zq - zq_ref).abs().max())
        require(err <= LOOKUP_ATOL, f"codebook_lookup n={n_frames}: max|err| {err}")
        bad = ref.clone()
        bad[-1, -1] = 0  # the last book's range starts at (L-1)*K
        try:
            codebook_lookup(bad, books_t)
            raise Failure("codebook_lookup took a code outside its book")
        except ValueError:
            pass
        worst["codebook_lookup"] = max(worst["codebook_lookup"], err)
        log(f"check rvq_assign / codebook_lookup frames={n_frames:<4d} rows={rows}: "
            f"near-tie rows {held['ties']}, mismatches 0; lookup max|err|={err:.3e}")
        for wd in (torch.float32, torch.bfloat16):
            for kernel, site, run_kernel, run_plain, *_ in codec_sites(
                    gen, tables, z_real, n_frames, wd, rng):
                if kernel == "causal_conv":
                    err = check_site(kernel, site, run_kernel, run_plain, n_frames, wd)
                    worst[kernel] = max(worst[kernel], err)
    return worst, ties


# ---------------------------------------------------------------- main path


def frames_for(n: int, seed: int) -> torch.Tensor:
    """Noisy harmonic test audio, (n, 1, FRAME, 1) on the card."""
    rng = np.random.default_rng(seed)
    t = np.arange(n * FRAME) / SAMPLE_RATE
    audio = 0.3 * np.sin(2 * np.pi * 220.0 * t) + 0.1 * rng.standard_normal(t.shape)
    return torch.from_numpy(audio.astype(np.float32)).reshape(n, 1, FRAME, 1).to(DEVICE)


def stream(run, frames, split):
    cache, outs, i = run.init_cache(), [], 0
    for n in split:
        y, cache = run(cache, frames[i:i + n])
        outs.append(y)
        i += n
    return torch.cat(outs)


def stream_codes(run, frames, split):
    """As :func:`stream` through ``run.run_with_codes``: (audio, codes (N,
    T_code, L))."""
    cache, outs, codes, i = run.init_cache(), [], [], 0
    for n in split:
        y, cache, c = run.run_with_codes(cache, frames[i:i + n])
        outs.append(y)
        codes.append(c)
        i += n
    return torch.cat(outs), torch.cat(codes)


def counted(path: str, kernels, drive):
    """Run ``drive()`` with every launch counter set to 0 just before and
    read just after; require each of ``kernels`` launched and the path's
    launches per dispatch. Returns (drive's result, counts)."""
    for spec in KERNELS.values():
        spec["fn"].launches = 0
    result = drive()
    torch.cuda.synchronize()
    launches = {name: spec["fn"].launches for name, spec in KERNELS.items()}
    log(f"{path} path launches", json.dumps(launches))
    for name in kernels:
        require(launches[name] > 0, f"the {path} path never launched {name}")
    want = LAUNCHES_PER_DISPATCH[path] * len(MAIN_FRAMES)
    require(sum(launches.values()) == want,
            f"the {path} path made {sum(launches.values())} launches, not {want}")
    return result, launches


def main_path(gen):
    """Phase 3, denoiser. Returns the launch counts of the main path's run."""
    frames = frames_for(sum(MAIN_FRAMES), SEED)
    run = make_scan_stream(gen, frame_size=FRAME)
    require(run.backend == "cuda", f"'auto' resolved to {run.backend!r}, not 'cuda'")
    out, launches = counted("denoiser", DENOISER_KERNELS,
                            lambda: stream(run, frames, MAIN_FRAMES))

    eager = make_scan_stream(gen, frame_size=FRAME, backend="eager")
    ref = stream(eager, frames, MAIN_FRAMES)
    require(out.shape == frames.shape and bool(torch.isfinite(out).all()),
            f"main path output {tuple(out.shape)} not finite or not the frames' shape")
    scale = float(ref.abs().max())
    err_bf16 = float((out - ref).abs().max())
    log(f"main path bf16 weights vs eager: max|err|={err_bf16:.3e} max|ref|={scale:.3e}")
    require(err_bf16 <= MAIN_RTOL_BF16 * scale, "bf16 main path disagrees with eager")

    run_f32 = make_scan_stream(gen, frame_size=FRAME, weight_dtype=torch.float32)
    out_f32 = stream(run_f32, frames, MAIN_FRAMES)
    err_f32 = float((out_f32 - ref).abs().max())
    log(f"main path f32 weights vs eager: max|err|={err_f32:.3e}")
    require(err_f32 <= MAIN_ATOL_F32, "f32 main path disagrees with eager")

    n_cpu = 3
    gen_cpu = copy.deepcopy(gen).to("cpu")
    cpu = make_scan_stream(gen_cpu, frame_size=FRAME, device="cpu")
    ref_cpu = stream(cpu, frames[:n_cpu].cpu(), (n_cpu,))
    err_cpu = float((out_f32[:n_cpu].cpu() - ref_cpu).abs().max())
    log(f"main path f32 weights vs CPU eager ({n_cpu} frames): max|err|={err_cpu:.3e}")
    require(err_cpu <= MAIN_ATOL_F32, "main path disagrees with the CPU")

    chain = make_scan_stream(gen, frame_size=FRAME, backend="cuda_chain")
    require(chain.backend == "cuda_chain", "cuda_chain route not taken")
    n_chain = 20
    out_chain = stream(chain, frames[:n_chain], (n_chain,))
    err_chain = float((out_chain - ref[:n_chain]).abs().max())
    log(f"cuda_chain vs eager ({n_chain} frames): max|err|={err_chain:.3e}")
    require(err_chain <= MAIN_ATOL_F32, "cuda_chain route disagrees with eager")
    return launches, {"bf16_vs_eager": err_bf16, "f32_vs_eager": err_f32,
                      "f32_vs_cpu": err_cpu, "cuda_chain_vs_eager": err_chain,
                      "eager_max_abs": scale}


# ---------------------------------------------------------------- codec


def streamed_z(gen, frames):
    """The projector output of each frame as the eager route computes it
    (per-frame ``encode_step`` with carried caches): (N * T_code, D)."""
    cache, zs = gen.init_cache(1), []
    with torch.no_grad():
        for frame in frames:
            z, enc_cache = gen.encode_step(cache, frame)
            cache.update(enc_cache)
            zs.append(z[0])
    return torch.cat(zs)


def codec_vq_state(gen) -> VQState:
    """Codebooks as a k-means init draws them: book by book, K rows sampled
    from the residuals of a seeded warm-up stream (not the stream under
    test), which then move on by their nearest codeword. A drawn row's
    residual becomes zero, so each book draws from rows no earlier book drew.
    (Seeded N(0, 1) books under an untrained encoder would give most rows the
    same few codes, and the code checks would prove little.)"""
    q = gen.quantizer
    audio = frames_for(WARMUP_FRAMES, SEED + 10).reshape(1, -1, 1)
    with torch.no_grad():
        z, _ = gen.encode_step(gen.init_cache(1), audio)
    r = z.reshape(-1, q.code_dim)
    require(r.shape[0] >= (q.codebook_num + 1) * q.codebook_size,
            "warm-up stream too short to draw every book from rows of its own")
    pick = torch.Generator(device=DEVICE).manual_seed(SEED + 11)
    books = []
    for _ in range(q.codebook_num):
        order = torch.randperm(r.shape[0], generator=pick, device=DEVICE)
        book = r[order[:q.codebook_size]].t().contiguous()
        r = r[order[q.codebook_size:]]
        dist = (r * r).sum(1, keepdim=True) - 2.0 * (r @ book) + (book * book).sum(0)
        r = r - book.t()[torch.argmin(dist, 1)]
        books.append(book)
    embed = torch.stack(books)
    return VQState(embed, torch.zeros(embed.shape[0], embed.shape[2], device=DEVICE),
                   embed.clone())


def held_codes(what, z, tables, codes, ref):
    """Require ``codes`` equal to ``ref`` up to near ties; the number of
    frames before the first differing one (the audio is compared there)."""
    n_frames, z_rows, n_books = ref.shape
    books, sqnorm, _ = tables
    held = rvq_near_ties(z, books, sqnorm, codes.reshape(-1, n_books),
                         ref.reshape(-1, n_books), CODE_RTOL)
    require(held["mismatches"] == 0, f"{what}: codes disagree beyond near ties: {held}")
    differ = (codes != ref).reshape(n_frames, -1).any(1).nonzero()
    agree = int(differ[0, 0]) if differ.numel() else n_frames
    log(f"{what}: codes equal but {held['ties']} near-tie rows (max distance excess "
        f"{held['max_excess']:.3e}); audio compared over the first {agree} frames")
    require(agree > 0, f"{what}: the first frame already differs at a near tie")
    return held, agree


def codec_path(gen, vq, tables):
    """Phase 3, codec. Returns the launch counts of the main path's run and
    its checks."""
    frames = frames_for(sum(MAIN_FRAMES), SEED)
    n_books = vq.embed.shape[0]
    try:
        make_scan_stream(gen, vq)
        raise Failure("the codec's 'auto' route without frame_size did not raise")
    except ValueError:
        pass  # it does not give way to the plain modules on the card
    run = make_scan_stream(gen, vq, frame_size=FRAME, weight_dtype=torch.float32)
    require(run.backend == "cuda", f"'auto' resolved to {run.backend!r}, not 'cuda'")
    (out, codes), launches = counted("codec", KERNELS,
                                     lambda: stream_codes(run, frames, MAIN_FRAMES))
    require(out.shape == frames.shape and bool(torch.isfinite(out).all()),
            f"codec output {tuple(out.shape)} not finite or not the frames' shape")
    require(codes.dtype == torch.int32 and tuple(codes.shape) == (
        sum(MAIN_FRAMES), FRAME // gen.hop, n_books), f"codes {tuple(codes.shape)}")
    distinct = [int(torch.unique(codes[..., l]).numel()) for l in range(n_books)]
    log(f"codec distinct codes per book over {sum(MAIN_FRAMES)} frames: {distinct}")
    require(min(distinct) >= MIN_DISTINCT_CODES,
            f"a book used fewer than {MIN_DISTINCT_CODES} codes: {distinct}")

    eager = make_scan_stream(gen, vq, frame_size=FRAME, backend="eager")
    require(eager.backend == "eager", "eager route not taken")
    ref, ref_codes = stream_codes(eager, frames, MAIN_FRAMES)
    z_eager = streamed_z(gen, frames)
    held, agree = held_codes("codec f32 route vs eager", z_eager, tables, codes, ref_codes)
    err_f32 = float((out[:agree] - ref[:agree]).abs().max())
    log(f"codec f32 route vs eager ({agree} frames): max|err|={err_f32:.3e} "
        f"max|ref|={float(ref.abs().max()):.3e}")
    require(err_f32 <= MAIN_ATOL_F32, "codec f32 route disagrees with eager")

    n_cpu = 3
    gen_cpu = copy.deepcopy(gen).to("cpu")
    vq_cpu = VQState(*(t.cpu() for t in vq))
    tables_cpu = tuple(t.cpu() for t in tables)
    cpu = make_scan_stream(gen_cpu, vq_cpu, frame_size=FRAME, device="cpu")
    frames_cpu = frames[:n_cpu].cpu()
    ref_cpu, codes_cpu = stream_codes(cpu, frames_cpu, (n_cpu,))
    _, agree_cpu = held_codes("codec f32 route vs CPU eager",
                              streamed_z(gen_cpu, frames_cpu), tables_cpu,
                              codes[:n_cpu].cpu(), codes_cpu)
    err_cpu = float((out[:agree_cpu].cpu() - ref_cpu[:agree_cpu]).abs().max())
    log(f"codec f32 route vs CPU eager ({agree_cpu} frames): max|err|={err_cpu:.3e}")
    require(err_cpu <= MAIN_ATOL_F32, "codec route disagrees with the CPU")

    # the transmitter's codes against the route's; the receiver decodes the
    # route's own codes, so its audio is held over every frame, near ties or not
    tx, rx = StreamingTransmitter(gen, vq), StreamingReceiver(gen, vq)
    tx_codes = torch.stack([tx.encode(frame)[:, 0].t() for frame in frames])
    rx_out = torch.stack([rx.decode(c.t()[:, None]) for c in codes])
    held_tx, _ = held_codes("StreamingTransmitter vs the codec route", z_eager, tables,
                            codes, tx_codes)
    err_txrx = float((rx_out - out).abs().max())
    log(f"StreamingReceiver on the route's codes vs the route ({len(frames)} frames): "
        f"max|err|={err_txrx:.3e}")
    require(err_txrx <= MAIN_ATOL_F32, "the receiver disagrees with the codec route")

    run16 = make_scan_stream(gen, vq, frame_size=FRAME)
    out16, codes16 = stream_codes(run16, frames, MAIN_FRAMES)
    share16 = float((codes16 == codes).float().mean())
    err16 = float((out16 - out).abs().max())
    log(f"codec bf16 weights vs f32 route (no bound): {share16:.4f} of codes equal, "
        f"audio max|err|={err16:.3e}")
    return launches, {"f32_vs_eager": err_f32, "f32_vs_eager_frames": agree,
                      "near_tie_rows_vs_eager": held["ties"], "f32_vs_cpu": err_cpu,
                      "rx_vs_route": err_txrx, "near_tie_rows_tx_vs_route": held_tx["ties"],
                      "distinct_codes": distinct,
                      "bf16_code_share_equal_f32": share16, "bf16_vs_f32_audio": err16,
                      "eager_max_abs": float(ref.abs().max())}


# ---------------------------------------------------------------- times


def latency(run, n_reps: int):
    """Per-dispatch wall ms of one 25 ms frame, cache carried (host clock
    around the call and a synchronize)."""
    frames = frames_for(n_reps + 10, SEED + 1)
    cache, walls = run.init_cache(), []
    for i in range(n_reps + 10):
        t0 = time.perf_counter()
        _, cache = run(cache, frames[i:i + 1])
        torch.cuda.synchronize()
        if i >= 10:
            walls.append((time.perf_counter() - t0) * 1e3)
    walls.sort()
    return {"median_ms": statistics.median(walls),
            "p90_ms": walls[int(0.9 * len(walls)) - 1], "samples": len(walls)}


def throughput(run, n_frames: int, reps: int):
    frames = frames_for(n_frames, SEED + 2)
    cache = run.init_cache()
    ms = gpu_ms(lambda: run(cache, frames), 1, groups=reps)
    audio_s = n_frames * FRAME / SAMPLE_RATE
    return {"frames": n_frames, "ms": ms, "frames_per_s": n_frames / ms * 1e3,
            "rtf": ms / 1e3 / audio_s}


def device_profile(run, latency_ms: float, n_reps: int = 50):
    """Device time of one 1-frame dispatch, from a ``torch.profiler`` trace
    of ``n_reps`` dispatches: in all, per port kernel and in other device
    work (cache tails, copies), and its share of the unprofiled median
    latency. None where the trace shows no device time."""
    frames = frames_for(n_reps + 1, SEED + 3)
    _, cache = run(run.init_cache(), frames[:1])
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(1, n_reps + 1):
            _, cache = run(cache, frames[i:i + 1])
        torch.cuda.synchronize()
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in device) / 1e3 / n_reps
    if device_ms <= 0:
        return None
    kernels_ms = {name: sum(e.self_device_time_total for e in device
                            if f"{name}_kernel" in e.key) / 1e3 / n_reps
                  for name in KERNELS}
    return {"device_ms_per_dispatch": device_ms, "busy_share": device_ms / latency_ms,
            "kernels_ms_per_dispatch": kernels_ms,
            "other_ms_per_dispatch": device_ms - sum(kernels_ms.values())}


def time_kernels(site_fn, names):
    """Phase 4b: each of ``names`` summed over its sites of one dispatch;
    ``site_fn(n_frames, weight_dtype)`` gives the sites."""
    report = {}
    for n_frames, reps in ((1, 50), (DISPATCH, 20), (THROUGHPUT_FRAMES, 10)):
        per_kernel = {name: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                             "library_ms": None, "ops": 0.0, "bytes": 0.0, "sites": {}}
                      for name in names}
        for kernel, site, run_kernel, run_plain, run_lib, flops, nb in site_fn(
                n_frames, torch.bfloat16):
            k_ms, p_ms = gpu_ms(run_kernel, reps), gpu_ms(run_plain, reps)
            l_ms = None if run_lib is None else gpu_ms(run_lib, reps)
            b_ms, b_by = bound_ms(flops, nb)
            agg = per_kernel[kernel]
            agg["ms"] += k_ms
            agg["plain_ms"] += p_ms
            agg["bound_ms"] += b_ms
            agg["ops"] += flops
            agg["bytes"] += nb
            if l_ms is not None:
                agg["library_ms"] = (agg["library_ms"] or 0.0) + l_ms
            agg["sites"][site] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
                                  "bound_ms": b_ms, "bound_by": b_by}
            log(f"time {kernel:22s} {site:7s} frames={n_frames:<4d} kernel={k_ms:.4f} ms "
                f"plain={p_ms:.4f} ms library={l_ms if l_ms is None else round(l_ms, 4)} "
                f"bound={b_ms:.4f} ms ({b_by})")
        for agg in per_kernel.values():
            t_ops, t_bytes = agg["ops"] / F32_FLOPS, agg["bytes"] / HBM_BYTES_PER_S
            agg["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
        report[n_frames] = per_kernel
    return report


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run needs the card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    started = time.perf_counter()

    t0 = time.perf_counter()
    built = _cuda.build()
    for name in KERNELS:
        _cuda.load(name)
    log(f"phase 1: built {sorted(built)} in {time.perf_counter() - t0:.1f} s")
    for name, info in built.items():
        regs = [ln.strip() for ln in info["log"].splitlines() if "registers" in ln]
        log(f"  {name}: nvcc {info['seconds']:.1f} s; " + " | ".join(regs))
    gp = dict(load_config(CONFIG)["generator_params"])
    gen = AudioDecGenerator(**gp, use_pqc=False, seed=SEED, device=DEVICE)
    log(f"flagship generator: {sum(p.numel() for p in gen.parameters())} params, "
        f"hop {gen.hop}, receptive length {gen.receptive_length}")
    codec_gp = dict(load_config(CODEC_CONFIG)["generator_params"])
    codec = AudioDecGenerator(**codec_gp, use_pqc=True, seed=SEED, device=DEVICE)
    vq = codec_vq_state(codec)
    tables = vq_tables(vq, DEVICE)
    log(f"flagship codec: {sum(p.numel() for p in codec.parameters())} params and "
        f"{vq.embed.numel()} codebook floats {tuple(vq.embed.shape)}, receptive length "
        f"{codec.receptive_length}")
    rng = torch.Generator(device=DEVICE).manual_seed(SEED)
    # real projector outputs of the codec for the search's checks and times
    z_real = streamed_z(codec, frames_for(THROUGHPUT_FRAMES, SEED + 4).reshape(1, 1, -1, 1))

    log("phase 2: kernels vs plain versions")
    worst = check_kernels(gen, rng)
    codec_worst, codec_ties = check_codec_kernels(codec, tables, z_real, rng)

    log("phase 3: main paths")
    launches, main_errs = main_path(gen)
    codec_launches, codec_errs = codec_path(codec, vq, tables)

    log("phase 4: times")
    cuda_run = make_scan_stream(gen, frame_size=FRAME)
    eager_run = make_scan_stream(gen, frame_size=FRAME, backend="eager")
    times = {
        "latency_n1_cuda": latency(cuda_run, 200),
        "latency_n1_eager": latency(eager_run, 50),
        "throughput_cuda": throughput(cuda_run, THROUGHPUT_FRAMES, 10),
        "throughput_eager": throughput(eager_run, THROUGHPUT_FRAMES, 3),
    }
    for key, val in times.items():
        log(key, json.dumps(val))
    profile = device_profile(cuda_run, times["latency_n1_cuda"]["median_ms"])
    times["device_n1_cuda"] = profile
    log("device_n1_cuda", json.dumps(profile) if profile
        else "not measured (the profiler trace shows no device time)")
    ktimes = time_kernels(lambda n, wd: sites(gen, n, wd, rng), DENOISER_KERNELS)

    codec_run = make_scan_stream(codec, vq, frame_size=FRAME)
    codec_f32 = make_scan_stream(codec, vq, frame_size=FRAME, weight_dtype=torch.float32)
    codec_times = {
        "latency_n1_codec": latency(codec_run, 200),
        "latency_n1_codec_f32": latency(codec_f32, 100),
        "throughput_codec": throughput(codec_run, THROUGHPUT_FRAMES, 5),
    }
    for key, val in codec_times.items():
        log(key, json.dumps(val))
    codec_profile = device_profile(codec_run, codec_times["latency_n1_codec"]["median_ms"])
    codec_times["device_n1_codec"] = codec_profile
    log("device_n1_codec", json.dumps(codec_profile) if codec_profile
        else "not measured (the profiler trace shows no device time)")
    times.update(codec_times)
    codec_ktimes = time_kernels(
        lambda n, wd: codec_sites(codec, tables, z_real, n, wd, rng),
        ("causal_conv", "rvq_assign", "codebook_lookup"))

    name_power = card()
    entries = []
    for name, spec in KERNELS.items():
        first_path = "denoiser" if name in DENOISER_KERNELS else "codec"
        kt = ktimes if name in DENOISER_KERNELS else codec_ktimes
        prof = profile if name in DENOISER_KERNELS else codec_profile
        agg1, agg, agg400 = (kt[n][name] for n in SIZES)
        entry = {
            "name": name, "route": "cuda", "source": spec["source"],
            "replaces": spec["replaces"],
            "launches": launches[name] + codec_launches[name],
            "launches_by_path": {"denoiser": launches[name], "codec": codec_launches[name]},
            "max_abs_err": (worst[name] if name in DENOISER_KERNELS else 0.0),
            "ms": agg["ms"], "plain_ms": agg["plain_ms"],
            "bound_ms": agg["bound_ms"], "bound_by": agg["bound_by"],
            "library_ms": agg["library_ms"],
            "per": f"sum over the kernel's sites in one {DISPATCH}-frame dispatch of the "
                   f"{first_path} path, bf16 weights",
            "ms_1frame": agg1["ms"], "plain_ms_1frame": agg1["plain_ms"],
            "bound_ms_1frame": agg1["bound_ms"], "library_ms_1frame": agg1["library_ms"],
            "device_ms_1frame_profiled": (prof["kernels_ms_per_dispatch"][name]
                                          if prof else None),
            f"ms_{THROUGHPUT_FRAMES}frames": agg400["ms"],
            f"plain_ms_{THROUGHPUT_FRAMES}frames": agg400["plain_ms"],
            f"bound_ms_{THROUGHPUT_FRAMES}frames": agg400["bound_ms"],
            f"library_ms_{THROUGHPUT_FRAMES}frames": agg400["library_ms"],
        }
        if name in codec_worst:
            entry["max_abs_err"] = max(entry["max_abs_err"], codec_worst[name])
        if name == "rvq_assign":
            entry["max_abs_err_is"] = "largest distance excess of a near-tie pick"
            entry["near_tie_rows"] = codec_ties
            entry["code_mismatches"] = 0
        if name == "causal_conv":
            entry["codec_sites"] = {str(n): codec_ktimes[n]["causal_conv"]["sites"]
                                    for n in SIZES}
        entries.append(entry)
    report = {"card": name_power, "seconds": time.perf_counter() - started,
              "main_path_errors": main_errs, "codec_path_checks": codec_errs,
              "times": times, "kernels": entries,
              "kernel_sites": {str(n): {k: v["sites"] for k, v in agg.items()}
                               for n, agg in ktimes.items()},
              "codec_kernel_sites": {str(n): {k: v["sites"] for k, v in agg.items()}
                                     for n, agg in codec_ktimes.items()}}
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    log(f"total {report['seconds']:.1f} s")
    print(json.dumps({"kernels": entries}))
    print(name_power)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
