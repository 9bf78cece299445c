"""Device time of one causal_conv or causal_conv_transpose launch at the
paths' conv and upsample sites, on one card, against cuDNN and, optionally,
the kernels of another checkout or of this tree built with other compiler
flags.

    python dl_speech_enhancement_tpu_torch/tools/conv_timing.py [--parent DIR]
        [--variant FLAGS] [--sweep] [--out FILE]
    python dl_speech_enhancement_tpu_torch/tools/conv_timing.py --fit FILE

Sites (``ops/vocoder_kernel.py::conv_sites``): every causal_conv launch of
the codec's dispatch (input conv, the four downsamples, the PQC projector and
decoder input conv, output conv; the denoiser's are the same less the two PQC
ones) and of the ``vctk_v1`` receiver's (input conv, the four 1x1 fuses, the
activated tanh output conv), and every causal_conv_transpose launch of the
two (the decoder's four upsamples ``d0u``-``d3u``; the receiver's four
``v0u``-``v3u``, LeakyReLU(0.1) on load), at one stream of 1, 100 and 400
frames and at 16 streams of 1 and 16 frames, with bf16 weights. For each it
first holds the kernel against its plain version (1e-4 of the largest
output), then prints the device time per call (``torch.profiler``, 50 calls
after 5 warm-up calls) of this tree's kernel at its planner's plan, of
``F.conv1d`` / ``F.conv_transpose1d`` on the same input and f32 weights
(TF32 off), with ``--parent`` of the kernels built from ``DIR``'s
``dl_speech_enhancement_tpu_torch/csrc/causal_conv.cu`` and
``causal_conv_transpose.cu``, and with ``--variant`` of this tree's kernels
built with the extra nvcc ``FLAGS`` (e.g. ``-DDSE_CONV_MIN_BLOCKS_256=1``)
at the same plan. A parent kernel whose entry point takes this tree's plan
arguments (causal_conv from the redesigned one on, causal_conv_transpose
once it runs on the GEMM arm) runs at this tree's plan and must equal this
tree's output bit for bit; an older one is timed only. It prints ptxas's
registers, stack frame and spills of each GEMM-arm instantiation it builds.

``--sweep`` also times every plan the GEMM arm could take at each GEMM site
and upsample site (``ops/mega_kernel.py::conv_gemm_plans``, at 2 taps for an
upsample; CUDA events around a CUDA graph of 20 launches) and requires each
to equal the planner's plan bit for bit; it fails unless a replay of each
graph writes the output (the graph holds the launches) and the planned
plan's graph time is at least half its profiled device time. ``--fit FILE``
(no card) reads such a ``--out`` file and fits the planner's cost constants
(``_CONV_BLOCK_US``, ``_CONV_FOLD_US``, ``_CONV_FOLD_US_PER_ELEM``,
``_CONV_STEP_US``) by coordinate descent from their current values, so that
the planner's pick (``_conv_plan``, ``_upsample_plan``) is as close to each
case's fastest plan as it can be (the sum of the ratios over all cases,
then the worst), while every case whose pick covers 32 SMs keeps such a
pick; it prints the constants and, per case, the picked and the fastest
plan's times.

The card first runs matmuls for 3 s so that its clocks leave idle; the
card's name, power limit and SM clock are printed before and after.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import re
import subprocess
import sys
import time

SHAPES = ((1, 1), (1, 100), (1, 400), (16, 1), (16, 16))  # (streams, frames)
FRAME = 1200
RTOL = 1e-4


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()


def _sites(root: str) -> tuple[list, list]:
    """The codec's and the v1 receiver's causal_conv sites, as (name, Cin,
    Cout, taps, stride, leaky, tanh, output rows a frame), and their
    causal_conv_transpose sites, as (name, Cin, Cout, stride, leaky, input
    rows a frame)."""
    from dl_speech_enhancement_tpu_torch.models import AudioDecGenerator
    from dl_speech_enhancement_tpu_torch.ops.vocoder_kernel import conv_sites
    from dl_speech_enhancement_tpu_torch.tools.host_latency import _receiver
    from dl_speech_enhancement_tpu_torch.utils.config import load_config

    gp = load_config(os.path.join(root, "configs", "autoencoder",
                                  "symAD_vctk_48000_hop300.yaml"))["generator_params"]
    codec, voc = AudioDecGenerator(**gp, use_pqc=True, device="cpu"), _receiver(root, load_config)
    sites = []
    for model in (codec, voc):
        for name, c, rows in conv_sites(model, FRAME):
            leaky, tanh = (0.01, True) if name == "v_out" else (None, False)  # vocoder_half's
            sites.append((name, c.in_channels, c.out_channels, c.kernel_size, c.stride, leaky,
                          tanh, rows))
    upsamples, rows = [], FRAME // codec.hop
    for prefix, layers, leaky in (("d", [blk.conv for blk in codec.decoder.blocks], None),
                                  ("v", voc.upsamples, voc.negative_slope)):
        t = rows
        for i, up in enumerate(layers):
            upsamples.append((f"{prefix}{i}u", up.in_channels, up.out_channels, up.stride,
                              leaky, t))
            t *= up.stride
    return sites, upsamples


def _build_conv(src: str, lib_path: str, flags=(), entries=None):
    """nvcc ``src`` into ``lib_path`` with the port's flags and ``flags``;
    the library, its ``entries`` (by default this tree's) typed, and ptxas's
    output."""
    from dl_speech_enhancement_tpu_torch.ops import _cuda

    os.makedirs(os.path.dirname(lib_path), exist_ok=True)
    proc = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, *flags, "-o", lib_path, src],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc {src} failed:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(lib_path)
    for fn, (argtypes, restype) in (entries or _cuda._ENTRIES["causal_conv"]).items():
        getattr(lib, fn).argtypes, getattr(lib, fn).restype = argtypes, restype
    lib.dse_error_string.argtypes, lib.dse_error_string.restype = [ctypes.c_int], ctypes.c_char_p
    return lib, proc.stdout + proc.stderr


def _ptxas_gemm(log: str, kernel: str = "causal_conv_kernel_gemm") -> list[str]:
    """``tile dims, weight type: registers; stack frame and spills`` of each
    GEMM-arm instantiation (of ``kernel``) in ptxas's -v output."""
    out, name, regs = [], None, {}
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
        elif name and kernel in name:
            if "registers" in line:
                regs[name] = line.split(":", 1)[1].strip()
            elif "stack frame" in line:
                m = re.search(r"ILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E(f|13__nv_bfloat16)", name)
                dims = ",".join(m.groups()[:4]) if m else name
                out.append((name, f"gemm<{dims}, {'f32' if m and m.group(5) == 'f' else 'bf16'}>"
                            f": {{}}; {line.strip()}"))
    return [text.format(regs.get(name, "?")) for name, text in out]


def fit(path: str) -> int:
    """Fit the planner's cost constants to a ``--sweep`` report (see the
    module's docstring)."""
    import random

    from dl_speech_enhancement_tpu_torch.ops import mega_kernel as mk

    with open(path) as f:
        report = json.load(f)
    cases = [r for r in report["sites"] + report.get("upsample_sites", []) if "sweep_us" in r]

    def set_params(p):
        mk._CONV_BLOCK_US, mk._CONV_FOLD_US, mk._CONV_FOLD_US_PER_ELEM = p[:3]
        mk._CONV_STEP_US = tuple(p[3:])

    def picks(p):
        set_params(p)
        for r in cases:  # the GEMM arm's pick, as _conv_plan and _upsample_plan make it
            cin, cout, taps, _ = r["layer"]
            phases = r.get("phases", 1)
            tile, q = mk._gemm_plan(r["rows"], cin, cout, taps, True, phases)
            bm, bn, _ = mk.conv_tile_dims(tile)
            blocks = (-(-r["rows"] // bm) * -(-cout // bn)
                      * -(-len(mk.conv_chunks(taps, cin)) // q) * phases)
            yield r, r["sweep_us"][f"{tile},{q}"], min(r["sweep_us"].values()), blocks

    def spread(p):
        return {i for i, (*_, blocks) in enumerate(picks(p)) if blocks >= mk._CONV_MIN_BLOCKS}

    start = [mk._CONV_BLOCK_US, mk._CONV_FOLD_US, mk._CONV_FOLD_US_PER_ELEM, *mk._CONV_STEP_US]
    kept = spread(start)

    def score(p):
        """(sum of ratios, worst); infinite where a case whose pick covered
        32 SMs under the current constants would no longer."""
        ratios = [t / best for _, t, best, _ in picks(p)]
        if not kept <= spread(p):
            return math.inf, math.inf
        return sum(ratios), max(ratios)

    rng = random.Random(1)
    found = None
    for restart in range(5):
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
    print(f"_CONV_STEP_US = {tuple(round(v, 3) for v in p[3:])}")
    print(f"_CONV_BLOCK_US, _CONV_FOLD_US, _CONV_FOLD_US_PER_ELEM = {p[0]:.3g}, {p[1]:.3g}, "
          f"{p[2]:.3g}")
    for r, t, best, blocks in picks(p):
        print(f"{r['site']:7s} B={r['streams']:<2d} N={r['frames']:<3d} picked {t:7.1f} us "
              f"({blocks} blocks), fastest {best:7.1f} us ({t / best:.2f}x)")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="a checkout whose causal_conv kernel is timed beside")
    ap.add_argument("--variant", help="nvcc flags of a build of this tree's kernel timed beside")
    ap.add_argument("--sweep", action="store_true", help="time every GEMM-arm plan too")
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
    from dl_speech_enhancement_tpu_torch.ops import mega_kernel as mk

    if not torch.cuda.is_available():
        print("conv_timing: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    sites, upsamples = _sites(root)
    build_dir = str(_cuda.BUILD_DIR)
    conv_src = str(_cuda.CSRC / "causal_conv.cu")
    up_src = str(_cuda.CSRC / "causal_conv_transpose.cu")
    up_entries = _cuda._ENTRIES["causal_conv_transpose"]
    new, log = _build_conv(conv_src, os.path.join(build_dir, "causal_conv_timed.so"))
    new_up, up_log = _build_conv(up_src, os.path.join(build_dir, "causal_conv_transpose_timed.so"),
                                 entries=up_entries)
    print("ptxas, this tree:", *_ptxas_gemm(log),
          *_ptxas_gemm(up_log, "causal_conv_transpose_kernel"), sep="\n  ", flush=True)
    libs = {"conv": {"new": new}, "upsample": {"new": new_up}}
    same_entry = {"conv": True, "upsample": True}  # whether the parent takes this tree's plan
    if args.parent:
        parent_csrc = os.path.join(args.parent, "dl_speech_enhancement_tpu_torch", "csrc")
        libs["conv"]["parent"], _ = _build_conv(os.path.join(parent_csrc, "causal_conv.cu"),
                                                os.path.join(build_dir, "causal_conv_parent.so"))
        with open(os.path.join(parent_csrc, "causal_conv_transpose.cu")) as f:
            same_entry["upsample"] = "dse_causal_conv_transpose_smem" in f.read()
        p, i, ll, f_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        libs["upsample"]["parent"], _ = _build_conv(
            os.path.join(parent_csrc, "causal_conv_transpose.cu"),
            os.path.join(build_dir, "causal_conv_transpose_parent.so"),
            entries=up_entries if same_entry["upsample"] else {
                "dse_causal_conv_transpose": ([p, ll, p, p, p, p, i, i, i, i, i, i, f_, i, p], i)})
    if args.variant:
        libs["conv"]["variant"], log = _build_conv(
            conv_src, os.path.join(build_dir, "causal_conv_variant.so"), args.variant.split())
        libs["upsample"]["variant"], up_log = _build_conv(
            up_src, os.path.join(build_dir, "causal_conv_transpose_variant.so"),
            args.variant.split(), up_entries)
        print(f"ptxas, {args.variant}:", *_ptxas_gemm(log),
              *_ptxas_gemm(up_log, "causal_conv_transpose_kernel"), sep="\n  ", flush=True)
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

    def measure(kind, name, batch, n_frames, plan, run_plan, got, ref, run_lib, row, gemm_plans):
        """Holds ``got`` (the wrapper's output) to ``ref`` (the plain
        version's) and the variant and parent to it, then times the kernel,
        cuDNN, the variant and the parent, and with --sweep every GEMM plan;
        returns the report row, or None after printing a failure."""
        out = row.pop("out")
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        limit = RTOL * float(ref.abs().max())
        if not err <= limit:
            print(f"FAIL {name} B={batch} N={n_frames} plan {plan}: max|err| {err} > {limit}",
                  flush=True)
            return None
        row.update(plan=list(plan), max_abs_err=err,
                   kernel_us=device_us(lambda: run_plan(*plan)), cudnn_us=device_us(run_lib))
        line = (f"{name:7s} B={batch:<2d} N={n_frames:<3d} plan {plan}: kernel "
                f"{row['kernel_us']:.1f} us, cudnn {row['cudnn_us']:.1f} us")
        for other in ("variant", "parent"):
            if other not in libs[kind]:
                continue
            planned = other == "variant" or same_entry[kind]
            if planned:  # the same plan: the bits must be this tree's
                run_plan(*plan, lib=libs[kind][other])
                torch.cuda.synchronize()
                if not torch.equal(out, got):
                    print(f"FAIL {name} B={batch} N={n_frames}: the {other}'s bits differ by "
                          f"{float((out - got).abs().max())}", flush=True)
                    return None
                row[f"{other}_us"] = device_us(lambda: run_plan(*plan, lib=libs[kind][other]))
            else:
                row[f"{other}_us"] = device_us(lambda: run_plan(lib=libs[kind][other]))
            line += f", {other} {row[f'{other}_us']:.1f} us" + (" (bit-equal)" if planned else "")
        if args.sweep and gemm_plans:
            run_plan(*plan)
            planned = out.clone()
            sweep = {}
            for tile, q in gemm_plans:
                out.zero_()
                run_plan(*plan[:-2], tile, q)
                torch.cuda.synchronize()
                if not torch.equal(out, planned):
                    print(f"FAIL {name} B={batch} N={n_frames}: plan {(tile, q)} differs "
                          f"from the planned {plan} by "
                          f"{float((out - planned).abs().max())}", flush=True)
                    return None
                sweep[f"{tile},{q}"] = graph_us(lambda: run_plan(*plan[:-2], tile, q), out,
                                                planned)
            best = min(sweep, key=sweep.get)
            at_plan = sweep[f"{plan[-2]},{plan[-1]}"]
            if at_plan < 0.5 * row["kernel_us"]:
                print(f"FAIL {name} B={batch} N={n_frames}: the planned plan's graph time "
                      f"{at_plan:.2f} us is under half its device time "
                      f"{row['kernel_us']:.2f} us", flush=True)
                return None
            row["sweep_us"] = sweep
            line += (f"; sweep: best {best} {sweep[best]:.1f} us, planned {at_plan:.1f} us "
                     f"(all {len(sweep)} plans equal bit for bit)")
        print(line, flush=True)
        return row

    report = {"card": card, "variant": args.variant, "sites": [], "upsample_sites": []}
    for batch, n_frames in SHAPES:
        for name, cin, cout, taps, stride, leaky, tanh, rows in sites:
            t_out = rows * n_frames
            cache = rn(batch, taps - 1 + 5, cin)[:, 5:]  # a view: streams 5 rows apart
            x = rn(batch, t_out * stride, cin) * (3 if leaky else 1)
            w = rn(taps, cin, cout) / (taps * cin) ** 0.5
            wb = w.bfloat16()
            b = rn(cout)
            out = torch.empty(batch, t_out, cout, device="cuda")
            plan = mk._conv_plan(batch, t_out, cin, cout, taps, stride, 1, True)
            head = (cache.data_ptr(), cache.stride(0), x.data_ptr(), wb.data_ptr(), b.data_ptr(),
                    out.data_ptr(), batch, t_out, cin, cout, taps, stride, 1,
                    int(leaky is not None), leaky or 0.0, int(tanh), 1)

            def run_conv(*plan, lib=new, head=head, name=name):
                arm = (mk.CONV_ARMS.index(plan[0]),) if plan else ()
                _cuda.check(lib, lib.dse_causal_conv(
                    *head, *arm, *plan[1:], torch.cuda.current_stream().cuda_stream),
                    f"causal_conv {name}")

            got = mk.causal_conv(cache, x, wb, b, stride, 1, leaky, tanh)
            ref = mk.causal_conv_plain(cache, x, wb, b, stride, 1, leaky, tanh)
            x_lib = torch.cat([cache, x], dim=1).transpose(1, 2).contiguous()
            w_lib = w.permute(2, 1, 0).contiguous()
            if leaky is not None:
                x_lib = F.leaky_relu(x_lib, leaky)
            row = measure("conv", name, batch, n_frames, plan, run_conv, got, ref,
                          lambda: F.conv1d(x_lib, w_lib, b, stride),
                          {"site": name, "streams": batch, "frames": n_frames,
                           "layer": [cin, cout, taps, stride], "rows": batch * t_out,
                           "out": out},
                          [p[:2] for p in mk.conv_gemm_plans(cin, cout, taps, stride, 1, True)]
                          if plan[0] == "gemm" else None)
            if row is None:
                return 1
            report["sites"].append(row)
        for name, cin, cout, stride, leaky, rows in upsamples:
            t_in = rows * n_frames
            cache = rn(batch, 1 + 5, cin)[:, 5:]
            x = rn(batch, t_in, cin) * (3 if leaky else 1)
            w = rn(2 * stride, cin, cout) / (2 * cin) ** 0.5  # conv-ready, tap-flipped
            wb = w.bfloat16()
            b = rn(cout)
            out = torch.empty(batch, t_in * stride, cout, device="cuda")
            plan = mk._upsample_plan(batch, t_in, cin, cout, stride, True)
            head = (cache.data_ptr(), cache.stride(0), x.data_ptr(), wb.data_ptr(), b.data_ptr(),
                    out.data_ptr(), batch, t_in, cin, cout, stride, int(leaky is not None),
                    leaky or 0.0, 1)

            def run_up(*plan, lib=new_up, head=head, name=name):
                _cuda.check(lib, lib.dse_causal_conv_transpose(
                    *head, *plan, torch.cuda.current_stream().cuda_stream),
                    f"causal_conv_transpose {name}")

            got = mk.causal_conv_transpose(cache, x, wb, b, stride, leaky)
            ref = mk.causal_conv_transpose_plain(cache, x, wb, b, stride, leaky)
            x_lib = torch.cat([cache, x], dim=1).transpose(1, 2).contiguous()
            if leaky is not None:
                x_lib = F.leaky_relu(x_lib, leaky)
            w_lib = w.flip(0).permute(1, 2, 0).contiguous()  # (Cin, Cout, k)
            row = measure("upsample", name, batch, n_frames, plan, run_up, got, ref,
                          lambda: F.conv_transpose1d(x_lib, w_lib, b, stride, stride),
                          {"site": name, "streams": batch, "frames": n_frames,
                           "layer": [cin, cout, 2, 1], "phases": stride,
                           "rows": batch * t_in, "out": out},
                          [p[:2] for p in mk.conv_gemm_plans(cin, cout, 2, 1, 1, True)])
            if row is None:
                return 1
            report["upsample_sites"].append(row)
    print("end:", _card())
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
