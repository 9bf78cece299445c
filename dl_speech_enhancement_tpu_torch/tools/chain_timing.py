"""Device time of one residual_chain launch at every chain site of the paths,
on one card, against the eager cuDNN chain, the bound and, optionally, the
kernel of another checkout.

    python dl_speech_enhancement_tpu_torch/tools/chain_timing.py [--parent DIR]
        [--sweep] [--out FILE]
    python dl_speech_enhancement_tpu_torch/tools/chain_timing.py --fit FILE

Sites: the eight residual chains of a denoiser or codec dispatch (``e0ch`` -
``e3ch`` at C = 32 / 64 / 128 / 256 and 1200 / 400 / 100 / 20 rows a frame,
``d0ch`` - ``d3ch`` mirroring them; the receivers' transmitters run the
same eight), from configs/denoise/symAD_vctk_48000_hop300.yaml, at one
stream of 1, 100 and 400 frames, 16 streams of 1 and 16 frames and 64
streams of 1 frame, with bf16 weights and each cache a strided view. For
each it holds the kernel against its plain version
(``utils/checks.py::rounding_held``: the bf16 operands' rounding points
allow no tighter bound on dense weights) and prints the device time per call (``torch.profiler``, 50 calls
after 5 warm-up calls) of this tree's kernel at its planner's plan, of the
eager chain (six ``F.conv1d`` with the ELUs and residual adds, f32 weights,
TF32 off: no one PyTorch call computes a chain, so it is an informative
column, not a yardstick) and, with ``--parent``, of the kernel built from
``DIR``'s ``dl_speech_enhancement_tpu_torch/csrc/residual_chain.cu`` at
``DIR``'s own planner's plan (its ``ops/stream_kernel.py::_chain_plan``,
asking that build's library where it does), held to the function it
computes (the plain version on f32 operands, 1e-4 of the largest output),
and with f32 weights this tree's kernel must equal ``DIR``'s bit for bit.
The bound is the chain's operations (``chip_smoke.py::chain_flops``) at
the dense bf16 rate, 989 TFLOP/s, or its bytes at 3.35 TB/s, whichever is
longer; the f32-core bound (67 TFLOP/s) beside it.

``--sweep`` also times every plan the kernel could take at the four
distinct site shapes (``ops/stream_kernel.py::chain_plans``, but for grids
above 64 blocks an SM; CUDA events
around a CUDA graph of 20 launches) and requires each to equal the
planner's plan bit for bit. ``--fit FILE`` (no card) reads such a report
and fits the planner's cost constants of the bf16-weight arm
(``_CHAIN_BLOCK_US_BF16``, ``_CHAIN_SYNC_US_BF16``, ``_CHAIN_STEP_US_BF16``,
``_CHAIN_INSTR_US_BF16``, ``_CHAIN_COPY_US_BF16``) by coordinate descent, so
that the planner's pick is as close to each case's fastest plan as it can
be (the sum of the ratios, then the worst); it prints the constants and
each case's picked and fastest times.

The card first runs matmuls for 3 s so that its clocks leave idle; the
card's name, power limit and SM clock are printed before and after.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
import types

SHAPES = ((1, 1), (1, 100), (1, 400), (16, 1), (16, 16), (64, 1))  # (streams, frames)
FRAME = 1200
RTOL = 1e-4
BF16_FLOPS, F32_FLOPS, HBM_BYTES_PER_S = 989e12, 67e12, 3.35e12
MAX_SWEPT_BLOCKS = 64 * 132  # --sweep skips plans of larger grids (tiles of a few rows)
# the bf16-weight arm's constants (the sweeps run at bf16 weights)
FIT_NAMES = ("_CHAIN_BLOCK_US_BF16", "_CHAIN_SYNC_US_BF16", "_CHAIN_STEP_US_BF16",
             "_CHAIN_INSTR_US_BF16", "_CHAIN_COPY_US_BF16")


def _sites(root: str) -> list[tuple[str, int, int]]:
    """(name, C, rows a frame) of the eight chains of a denoiser dispatch."""
    from dl_speech_enhancement_tpu_torch.models import AudioDecGenerator
    from dl_speech_enhancement_tpu_torch.utils.config import load_config

    gp = load_config(os.path.join(root, "configs", "denoise",
                                  "symAD_vctk_48000_hop300.yaml"))["generator_params"]
    gen = AudioDecGenerator(**gp, use_pqc=False, device="cpu")
    sites, t = [], FRAME
    for bi, blk in enumerate(gen.encoder.blocks):
        sites.append((f"e{bi}ch", blk.conv.in_channels, t))
        t //= blk.conv.stride
    for bi, blk in enumerate(gen.decoder.blocks):
        t *= blk.conv.stride
        sites.append((f"d{bi}ch", blk.conv.out_channels, t))
    return sites


def chain_flops(channels: int, rows: int) -> float:
    """Operations of one chain that outputs ``rows`` rows, as chip_smoke.py
    counts them: unit u also computes the rows later units reach back to."""
    from dl_speech_enhancement_tpu_torch.ops.stream_kernel import DILATIONS, KERNEL_SIZE

    return sum(2.0 * (KERNEL_SIZE + 1) * channels * channels
               * (rows + sum((KERNEL_SIZE - 1) * d for d in DILATIONS[u + 1:]))
               for u in range(len(DILATIONS)))


def _parent_chain(root: str, build_dir: str):
    """The parent checkout's residual_chain library and its planner, which
    asks that library (not this tree's) wherever it asks one."""
    from dl_speech_enhancement_tpu_torch.ops import _cuda

    src = os.path.join(root, "dl_speech_enhancement_tpu_torch", "csrc", "residual_chain.cu")
    path = os.path.join(build_dir, "residual_chain_parent.so")
    os.makedirs(build_dir, exist_ok=True)
    proc = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", path, src],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc {src} failed:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(path)
    p, i, ll, z = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_size_t
    lib.takes_scratch = hasattr(lib, "dse_residual_chain_scratch")
    lib.dse_residual_chain.argtypes = ([p, ll, p, p, p, p] + [p] * lib.takes_scratch + [i] * 9
                                       + [p])
    lib.dse_residual_chain.restype = i
    for fn, n_args, restype in (("dse_residual_chain_smem", None, z),
                                ("dse_residual_chain_block_rows", 2, i)):
        if hasattr(lib, fn):
            getattr(lib, fn).restype = restype
            if n_args:
                getattr(lib, fn).argtypes = [i] * n_args
    lib.dse_error_string.argtypes, lib.dse_error_string.restype = [i], ctypes.c_char_p
    spec = importlib.util.spec_from_file_location(
        "parent_stream_kernel",
        os.path.join(root, "dl_speech_enhancement_tpu_torch", "ops", "stream_kernel.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod._cuda = types.SimpleNamespace(load=lambda name: lib)
    return lib, mod._chain_plan


def fit(path: str) -> int:
    """Fit the planner's cost constants to a ``--sweep`` report (see the
    module's docstring)."""
    import random

    from dl_speech_enhancement_tpu_torch.ops import stream_kernel as sk

    with open(path) as f:
        cases = [r for r in json.load(f)["sites"] if "sweep_us" in r]

    def picks(p):
        for name, v in zip(FIT_NAMES, p):
            setattr(sk, name, v)
        sk._chain_plan.cache_clear()
        for r in cases:
            plan = sk._chain_plan(r["streams"], r["rows_per_stream"], r["channels"])
            yield (r, r["sweep_us"].get(f"{plan[0]},{plan[1]}", math.inf),
                   min(r["sweep_us"].values()), plan)

    def score(p):
        ratios = [t / best for _, t, best, _ in picks(p)]
        return sum(ratios), max(ratios)

    start = [getattr(sk, name) for name in FIT_NAMES]
    rng = random.Random(1)
    found = None
    for restart in range(6):
        p = list(start) if restart == 0 else [v * math.exp(rng.gauss(0, 0.7)) for v in start]
        cur = score(p)
        for _ in range(8):
            improved = False
            for i in range(len(p)):
                for factor in (0.5, 0.7, 0.85, 0.93, 1.07, 1.2, 1.4, 2.0):
                    trial = p[:i] + [p[i] * factor] + p[i + 1:]
                    s = score(trial)
                    if s < cur:
                        cur, p, improved = s, trial, True
            if not improved:
                break
        if found is None or cur < found[0]:
            found = (cur, p)
    print(f"start: sum of ratios {score(start)[0]:.3f}, worst {score(start)[1]:.3f} "
          f"over {len(cases)} cases")
    (total, worst), p = found
    print(f"fitted: sum of ratios {total:.3f}, worst {worst:.3f}")
    for name, v in zip(FIT_NAMES, p):
        print(f"{name} = {v:.3g}")
    for r, t, best, plan in picks(p):
        fastest = min(r["sweep_us"], key=r["sweep_us"].get)
        print(f"{r['site']:5s} B={r['streams']:<2d} N={r['frames']:<3d} picked {plan} "
              f"{t:8.1f} us, fastest ({fastest}) {best:8.1f} us ({t / best:.2f}x)")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="a checkout whose residual_chain kernel is timed beside")
    ap.add_argument("--sweep", action="store_true", help="time every plan too")
    ap.add_argument("--fit", metavar="FILE", help="fit the planner's constants to a --sweep "
                    "report (no card)")
    ap.add_argument("--out", help="write the numbers as JSON here")
    args = ap.parse_args()
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.path.insert(0, root)
    if args.fit:
        return fit(args.fit)
    import torch
    import torch.nn.functional as F

    from dl_speech_enhancement_tpu_torch.ops import _cuda
    from dl_speech_enhancement_tpu_torch.ops import stream_kernel as sk
    from dl_speech_enhancement_tpu_torch.tools.conv_timing import _card
    from dl_speech_enhancement_tpu_torch.utils.checks import rounding_held

    if not torch.cuda.is_available():
        print("chain_timing: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    report = _cuda.build(["residual_chain"])
    for name, info in report.items():
        print(f"{name}: nvcc {info['seconds']:.1f} s", *[
            line.strip() for line in info["log"].splitlines() if "registers" in line
            or "spill" in line], sep="\n  ", flush=True)
    lib = _cuda.load("residual_chain")
    parent = _parent_chain(args.parent, str(_cuda.BUILD_DIR)) if args.parent else None
    sites = _sites(root)
    card = _card()
    print("idle:", card, flush=True)
    a = torch.randn(8192, 8192, device="cuda")
    t0 = time.time()
    while time.time() - t0 < 3:
        a @ a
    torch.cuda.synchronize()
    print("after warm-up:", _card(), flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)

    def rn(*shape):
        return torch.randn(*shape, generator=g, device="cuda") * 0.3

    def device_us(fn, reps=50):
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        return sum(e.device_time_total for e in prof.key_averages()
                   if e.device_time_total > 0 and "Memcpy" not in e.key) / reps

    def graph_us(fn, out, expect, reps=20):
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        if not torch.equal(out, expect):
            raise RuntimeError("a replay of the graph did not write the plan's output")
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        times = []
        for _ in range(5):
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) * 1e3 / reps)
        return sorted(times)[2]

    halo, dil = sk.chain_halo(), sk.DILATIONS
    out_report = {"card": card, "sites": []}
    swept = set()
    for batch, n_frames in SHAPES:
        for name, c, rows in sites:
            t = rows * n_frames
            cache = rn(batch, halo + 5, c)[:, 5:]  # a view: streams 5 rows apart
            x = rn(batch, t, c)
            w1 = rn(3, 7, c, c) / (7 * c) ** 0.5
            w2 = rn(3, c, c) / c ** 0.5
            w1b, w2b = w1.bfloat16(), w2.bfloat16()
            out = torch.empty(batch, t, c, device="cuda")
            plan = sk._chain_plan(batch, t, c, dil, True)
            swept_plans = [(tile, cluster) for tile, cluster, _ in sk.chain_plans(t, c, dil, True)
                           if batch * -(-t // tile) * cluster <= MAX_SWEPT_BLOCKS
                           or (tile, cluster) == plan] if args.sweep else [plan]
            # every plan this site runs, sized by the f32 formula (f32 weights', and
            # any parent's)
            tiles = {p[0] for p in swept_plans} | {sk._chain_plan(batch, t, c, dil, False)[0]}
            if parent:
                tiles |= {parent[1](batch, t, c, dil, bf)[0] for bf in (False, True)}
            scratch = torch.empty(max(batch * -(-t // tile) * sk.chain_scratch_floats(
                tile, c, dil) for tile in tiles), device="cuda")

            def run(tile, cluster, lib=lib, cache=cache, x=x, w1=w1b, w2=w2b, out=out,
                    batch=batch, t=t, c=c, what=name, scratch=scratch):
                # an older parent's entry point takes no scratch
                extra = (scratch.data_ptr(),) if getattr(lib, "takes_scratch", True) else ()
                _cuda.check(lib, lib.dse_residual_chain(
                    cache.data_ptr(), cache.stride(0), x.data_ptr(), w1.data_ptr(),
                    w2.data_ptr(), out.data_ptr(), *extra, batch, t, c, *dil, tile, cluster,
                    int(w1.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream),
                    f"residual_chain {what}")

            got = sk.residual_chain(cache, x, w1b, w2b)
            ref = sk.residual_chain_plain(cache, x, w1b, w2b)
            held = rounding_held(got, ref,
                                 sk.residual_chain_plain(cache, x, w1b.float(), w2b.float()))
            err = held["max_err"]
            if not held["held"]:
                print(f"FAIL {name} B={batch} N={n_frames} plan {plan}: {held}", flush=True)
                return 1
            flops, nbytes = batch * chain_flops(c, t), 4 * batch * (halo + 2 * t) * c + 2 * (
                w1b.numel() + w2b.numel())
            row = {"site": name, "streams": batch, "frames": n_frames, "channels": c,
                   "rows_per_stream": t, "plan": list(plan), "max_abs_err": err,
                   "kernel_us": device_us(lambda: run(*plan)),
                   "bound_us": max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e6,
                   "bound_us_f32_cores": max(flops / F32_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e6}
            # the eager chain: (B, C, time), f32 weights, TF32 off
            h_lib = torch.cat([cache, x], dim=1).transpose(1, 2).contiguous()
            w1_lib = [w1[u].permute(2, 1, 0).contiguous() for u in range(3)]  # (out, in, k)
            w2_lib = [w2[u].t().contiguous()[:, :, None] for u in range(3)]

            def eager(h=h_lib, w1_lib=w1_lib, w2_lib=w2_lib):
                for u, d in enumerate(dil):
                    y = F.elu(F.conv1d(F.elu(h), w1_lib[u], dilation=d))
                    h = h[:, :, 6 * d:] + F.conv1d(y, w2_lib[u])
                return h

            e = eager()
            torch.cuda.synchronize()
            e_err = float((e.transpose(1, 2) - sk.residual_chain_plain(cache, x, w1, w2))
                          .abs().max())
            row["eager_us"] = device_us(eager)
            line = (f"{name:5s} B={batch:<2d} N={n_frames:<3d} plan {plan}: kernel "
                    f"{row['kernel_us']:.1f} us, eager {row['eager_us']:.1f} us "
                    f"(|err| {e_err:.1e}), bound {row['bound_us']:.2f} us, max|err| {err:.1e}")
            if parent:
                p_lib, p_plan = parent
                pp = p_plan(batch, t, c, dil)
                run(*pp, lib=p_lib)
                torch.cuda.synchronize()
                # the parent multiplied f32 operands by the bf16 weights
                p_ref = sk.residual_chain_plain(cache, x, w1b.float(), w2b.float())
                p_err = float((out - p_ref).abs().max())
                if not p_err <= RTOL * float(p_ref.abs().max()):
                    print(f"FAIL parent {name} B={batch} N={n_frames}: max|err| {p_err}",
                          flush=True)
                    return 1
                # f32 weights: this tree's arm is the parent's, bit for bit
                run(*sk._chain_plan(batch, t, c, dil, False), w1=w1, w2=w2)
                mine = out.clone()
                run(*p_plan(batch, t, c, dil, False), lib=p_lib, w1=w1, w2=w2)
                torch.cuda.synchronize()
                if not torch.equal(out, mine):
                    print(f"FAIL {name} B={batch} N={n_frames}: f32 weights differ from the "
                          f"parent's by {float((out - mine).abs().max())}", flush=True)
                    return 1
                row.update(parent_plan=list(pp),
                           parent_us=device_us(lambda: run(*pp, lib=p_lib)))
                line += f", parent {row['parent_us']:.1f} us at {pp}"
            key = (batch, n_frames, c, t)
            if args.sweep and key not in swept:
                swept.add(key)
                run(*plan)
                planned = out.clone()
                sweep = {}
                for tile, cluster in swept_plans:
                    out.zero_()
                    run(tile, cluster)
                    torch.cuda.synchronize()
                    if not torch.equal(out, planned):
                        print(f"FAIL {name} B={batch} N={n_frames}: plan {(tile, cluster)} "
                              f"differs from the planned {plan} by "
                              f"{float((out - planned).abs().max())}", flush=True)
                        return 1
                    sweep[f"{tile},{cluster}"] = graph_us(
                        lambda: run(tile, cluster), out, planned)
                best = min(sweep, key=sweep.get)
                row["sweep_us"] = sweep
                line += (f"; sweep: best {best} {sweep[best]:.1f} us, planned "
                         f"{sweep[f'{plan[0]},{plan[1]}']:.1f} us (all {len(sweep)} plans "
                         "equal bit for bit)")
            print(line, flush=True)
            out_report["sites"].append(row)
    print("end:", _card())
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out_report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
