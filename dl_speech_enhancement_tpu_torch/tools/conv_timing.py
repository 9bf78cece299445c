"""Device time of one causal_conv or causal_conv_transpose launch at the
paths' conv and upsample sites, on one card, against cuDNN and, optionally,
the kernels of another checkout or of this tree built with other compiler
flags.

    python dl_speech_enhancement_tpu_torch/tools/conv_timing.py [--parent DIR]
        [--variant FLAGS] [--sweep] [--only {f32,bf16}] [--out FILE]
    python dl_speech_enhancement_tpu_torch/tools/conv_timing.py --fit FILE
        [--fit-x {f32,bf16}]

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
once it runs on the GEMM arm) runs at this tree's plan; with bf16 weights
it is held to the function it computes (the plain version on f32 operands:
a parent from before the bf16 operands' rounding; 1e-4 of the largest
output), and with f32 weights it must equal this tree's output bit for bit;
an older one is timed only. It prints ptxas's
registers, stack frame and spills of each GEMM-arm instantiation it builds.

The bf16-x sites: every causal_conv and causal_conv_transpose call of the
denoiser's and the codec's dispatches at bf16 launch boundaries
(``ops/mega_stacked.py``), at DISPATCHES (64 and 16 streams of 16 frames),
with x and out in the dtypes the path gives them (bf16 between launches; the
audio in and out f32), bf16 weights and bf16-exact caches, as the path has
them. Each call is held to its plain version (1e-4 of the largest output
plus one bf16 step of the value) and to the f32 arm on its widened inputs,
rounded, bit for bit; then the device time of the call, of cuDNN in bf16 on
the same inputs (``F.conv1d`` / ``F.conv_transpose1d`` on bf16 tensors, as
``chip_smoke.py::call_library`` builds it), and of the f32 arm (f32 x and
out: the call at f32 boundaries), its bound (bytes each read or written
once at 3.35 TB/s, or operations at the rate of its arithmetic: 989 TFLOP/s
with bf16 weights, 67 TFLOP/s off the GEMM arm) and its plan; and per dispatch the
sums. With ``--parent`` the parent's bf16 call runs at the parent's own plan
(its planner, loaded from ``DIR``) and must equal the parent's f32 arm (run
at this tree's f32-x plan) rounded, bit for bit, and that arm the plain
version on f32 operands within 1e-4 of the largest output; both are
timed. With ``--variant`` this tree's
kernels built with the extra flags run at this tree's plan, bit for bit.

``--sweep`` also times every plan the GEMM arm could take at each GEMM site
and upsample site (``ops/mega_kernel.py::conv_gemm_plans``, at 2 taps for an
upsample; the bf16-x plans at the bf16-x sites; CUDA events around a CUDA
graph of 20 launches) and requires each to equal the planner's plan bit for
bit; it fails unless a replay of each graph writes the output (the graph
holds the launches) and the planned plan's graph time is at least half its
profiled device time. ``--fit FILE`` (no card) reads such a ``--out`` file
and fits the planner's cost constants by coordinate descent from their
current values: from the f32-x cases ``_CONV_BLOCK_US``, ``_CONV_FOLD_US``,
``_CONV_FOLD_US_PER_ELEM`` and ``_CONV_STEP_US``; from the bf16-x cases
``_CONV_BLOCK_US_BF16X`` and ``_CONV_STEP_US_BF16X`` (``--fit-x bf16``), so
that the planner's pick (``_conv_plan``, ``_upsample_plan``) is as close to
each case's fastest plan as it can be (the sum of the ratios over all cases,
then the worst), while every case whose pick covers 32 SMs keeps such a
pick; it prints the constants and, per case, the picked and the fastest
plan's times.

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
import re
import subprocess
import sys
import time

SHAPES = ((1, 1), (1, 100), (1, 400), (16, 1), (16, 16))  # (streams, frames)
DISPATCHES = ((64, 16), (16, 16))  # (streams, frames) of the bf16-x sites
FRAME = 1200
RTOL = 1e-4
BF16_STEP = 2.0 ** -7  # a bf16 output may round either way at a boundary
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS, TF32_FLOPS, F32_FLOPS = 989e12, 495e12, 67e12  # H100 SXM, dense


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


def _demangle(names: list[str]) -> dict:
    """C++ names of ``names`` (cu++filt or c++filt), or the names as they are
    where neither runs."""
    for tool in (os.path.join(os.path.dirname(_nvcc_path()), "cu++filt"), "c++filt"):
        try:
            proc = subprocess.run([tool], input="\n".join(names), capture_output=True,
                                  text=True, timeout=60)
        except OSError:
            continue
        lines = proc.stdout.splitlines()
        if proc.returncode == 0 and len(lines) == len(names):
            return dict(zip(names, lines))
    return {n: n for n in names}


def _nvcc_path() -> str:
    from dl_speech_enhancement_tpu_torch.ops import _cuda

    return _cuda._nvcc()


def _ptxas_gemm(log: str, kernel: str = "causal_conv_kernel_gemm") -> list[str]:
    """``gemm<tile dims, weight, x, out types>: registers; stack frame and
    spills`` of each GEMM-arm instantiation (of ``kernel``) in ptxas's -v
    output."""
    out, name, regs = [], None, {}
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
        elif name and kernel in name:
            if "registers" in line:
                regs[name] = line.split(":", 1)[1].strip()
            elif "stack frame" in line:
                out.append((name, line.strip()))
    plain = _demangle([name for name, _ in out])
    rows = []
    for name, frame in out:
        m = re.search(r"<(\d+), (\d+), (\d+), (\d+), ([^,]+), ([^,]+), ([^,>]+)>", plain[name])
        what = (f"gemm<{','.join(m.groups()[:4])}> w {m.group(5)}, x {m.group(6)}, "
                f"out {m.group(7)}".replace("__nv_bfloat16", "bf16") if m else plain[name])
        rows.append(f"{what}: {regs.get(name, '?')}; {frame}")
    return rows


def fit(path: str, kind: str = "f32") -> int:
    """Fit the planner's cost constants of the ``kind`` x arm to a
    ``--sweep`` report (see the module's docstring)."""
    import random

    from dl_speech_enhancement_tpu_torch.ops import mega_kernel as mk

    with open(path) as f:
        report = json.load(f)
    x_bf16 = kind == "bf16"
    cases = [r for r in report["sites"] + report.get("upsample_sites", [])
             + report.get("bf16_sites", []) if "sweep_us" in r and r.get("x", "f32") == kind]

    def set_params(p):
        if x_bf16:
            mk._CONV_BLOCK_US_BF16X, mk._CONV_STEP_US_BF16X = p[0], tuple(p[1:])
        else:
            mk._CONV_BLOCK_US, mk._CONV_FOLD_US, mk._CONV_FOLD_US_PER_ELEM = p[:3]
            mk._CONV_STEP_US = tuple(p[3:])

    def picks(p):
        set_params(p)
        for r in cases:  # the GEMM arm's pick, as _conv_plan and _upsample_plan make it
            cin, cout, taps, stride = r["layer"]
            phases = r.get("phases", 1)
            tile, q = mk._gemm_plan(r["rows"], cin, cout, taps, True, phases, x_bf16,
                                    r.get("t_out", 0), stride)
            bm, bn, _ = mk.conv_tile_dims(tile)
            blocks = (-(-r["rows"] // bm) * -(-cout // bn)
                      * -(-len(mk.conv_chunks(taps, cin)) // q) * phases)
            yield r, r["sweep_us"][f"{tile},{q}"], min(r["sweep_us"].values()), blocks

    def spread(p):
        return {i for i, (*_, blocks) in enumerate(picks(p)) if blocks >= mk._CONV_MIN_BLOCKS}

    start = ([mk._CONV_BLOCK_US_BF16X, *mk._CONV_STEP_US_BF16X] if x_bf16 else
             [mk._CONV_BLOCK_US, mk._CONV_FOLD_US, mk._CONV_FOLD_US_PER_ELEM, *mk._CONV_STEP_US])
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
    if x_bf16:
        print(f"_CONV_STEP_US_BF16X = {tuple(round(v, 3) for v in p[1:])}")
        print(f"_CONV_BLOCK_US_BF16X = {p[0]:.3g}")
    else:
        print(f"_CONV_STEP_US = {tuple(round(v, 3) for v in p[3:])}")
        print(f"_CONV_BLOCK_US, _CONV_FOLD_US, _CONV_FOLD_US_PER_ELEM = {p[0]:.3g}, "
              f"{p[1]:.3g}, {p[2]:.3g}")
    for r, t, best, blocks in picks(p):
        print(f"{r['site']:7s} B={r['streams']:<2d} N={r['frames']:<3d} picked {t:7.1f} us "
              f"({blocks} blocks), fastest {best:7.1f} us ({t / best:.2f}x)")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="a checkout whose causal_conv kernel is timed beside")
    ap.add_argument("--variant", help="nvcc flags of a build of this tree's kernel timed beside")
    ap.add_argument("--sweep", action="store_true", help="time every GEMM-arm plan too")
    ap.add_argument("--only", choices=("f32", "bf16"),
                    help="only the f32-x sites (SHAPES) or only the bf16-x sites (DISPATCHES)")
    ap.add_argument("--fit", metavar="FILE", help="fit the planner's constants to a --sweep "
                    "report (no card)")
    ap.add_argument("--fit-x", choices=("f32", "bf16"), default="f32",
                    help="the x arm whose constants --fit fits")
    ap.add_argument("--out", help="write the numbers as JSON here")
    args = ap.parse_args()
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.path.insert(0, root)
    if args.fit:
        return fit(args.fit, args.fit_x)
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

    def measure(kind, name, batch, n_frames, plan, run_plan, got, ref, run_lib, row, gemm_plans,
                ref_f32_operands=None, run_f32=None):
        """Holds ``got`` (the wrapper's output) to ``ref`` (the plain
        version's) and the variant to it, the parent to ``ref_f32_operands``
        and, with f32 weights (``run_f32(lib)``, the output), to this tree
        bit for bit, then times the kernel, cuDNN, the variant and the
        parent, and with --sweep every GEMM plan; returns the report row, or
        None after printing a failure."""
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
            if planned and other == "parent":  # its own function; f32 weights bit for bit
                run_plan(*plan, lib=libs[kind][other])
                torch.cuda.synchronize()
                p_err = float((out - ref_f32_operands).abs().max())
                mine32 = run_f32(libs[kind]["new"]).clone()
                theirs32 = run_f32(libs[kind][other])
                torch.cuda.synchronize()
                if p_err > RTOL * float(ref_f32_operands.abs().max()) or not torch.equal(
                        mine32, theirs32):
                    print(f"FAIL {name} B={batch} N={n_frames}: the parent is {p_err} from its "
                          f"function, or its f32-weight bits differ by "
                          f"{float((mine32 - theirs32).abs().max())}", flush=True)
                    return None
                row["parent_us"] = device_us(lambda: run_plan(*plan, lib=libs[kind][other]))
            elif planned:  # the same plan: the bits must be this tree's
                run_plan(*plan, lib=libs[kind][other])
                torch.cuda.synchronize()
                if not torch.equal(out, got):
                    print(f"FAIL {name} B={batch} N={n_frames}: the {other}'s bits differ by "
                          f"{float((out - got).abs().max())}", flush=True)
                    return None
                row[f"{other}_us"] = device_us(lambda: run_plan(*plan, lib=libs[kind][other]))
            if not planned:
                row[f"{other}_us"] = device_us(lambda: run_plan(lib=libs[kind][other]))
            line += f", {other} {row[f'{other}_us']:.1f} us" + (
                "" if not planned else " (f32 weights bit for bit)" if other == "parent"
                else " (bit-equal)")
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
    for batch, n_frames in SHAPES if args.only != "bf16" else ():
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
            ref_f32_operands = mk.causal_conv_plain(cache, x, wb.float(), b, stride, 1, leaky,
                                                    tanh)
            plan_f32 = mk._conv_plan(batch, t_out, cin, cout, taps, stride, 1, False)
            out_f32 = torch.empty_like(out)
            head_f32 = (*head[:3], w.data_ptr(), head[4], out_f32.data_ptr(), *head[6:-1], 0)

            def run_f32(lib, head_f32=head_f32, plan_f32=plan_f32, out_f32=out_f32,
                        name=name):
                _cuda.check(lib, lib.dse_causal_conv(
                    *head_f32, mk.CONV_ARMS.index(plan_f32[0]), *plan_f32[1:],
                    torch.cuda.current_stream().cuda_stream), f"causal_conv {name} f32")
                return out_f32

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
                          if plan[0] == "gemm" else None, ref_f32_operands, run_f32)
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
            ref_f32_operands = mk.causal_conv_transpose_plain(cache, x, wb.float(), b, stride,
                                                              leaky)
            plan_f32 = mk._upsample_plan(batch, t_in, cin, cout, stride, False)
            out_f32 = torch.empty_like(out)
            head_f32 = (*head[:3], w.data_ptr(), head[4], out_f32.data_ptr(), *head[6:-1], 0)

            def run_f32(lib, head_f32=head_f32, plan_f32=plan_f32, out_f32=out_f32,
                        name=name):
                _cuda.check(lib, lib.dse_causal_conv_transpose(
                    *head_f32, *plan_f32, torch.cuda.current_stream().cuda_stream),
                    f"causal_conv_transpose {name} f32")
                return out_f32

            x_lib = torch.cat([cache, x], dim=1).transpose(1, 2).contiguous()
            if leaky is not None:
                x_lib = F.leaky_relu(x_lib, leaky)
            w_lib = w.flip(0).permute(1, 2, 0).contiguous()  # (Cin, Cout, k)
            row = measure("upsample", name, batch, n_frames, plan, run_up, got, ref,
                          lambda: F.conv_transpose1d(x_lib, w_lib, b, stride, stride),
                          {"site": name, "streams": batch, "frames": n_frames,
                           "layer": [cin, cout, 2, 1], "phases": stride,
                           "rows": batch * t_in, "out": out},
                          [p[:2] for p in mk.conv_gemm_plans(cin, cout, 2, 1, 1, True)],
                          ref_f32_operands, run_f32)
            if row is None:
                return 1
            report["upsample_sites"].append(row)
    report["bf16_sites"], report["dispatches"] = [], []
    parent_mk = None
    if args.parent:  # the parent's planner: its plan for each bf16 call
        spec = importlib.util.spec_from_file_location("parent_mega_kernel", os.path.join(
            args.parent, "dl_speech_enhancement_tpu_torch", "ops", "mega_kernel.py"))
        parent_mk = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(parent_mk)
    bf16 = torch.bfloat16

    def bound(ins, out, ops, rate):
        """(us, what bounds it): each input read once, the output written
        once, against the operations at ``rate``."""
        moved = sum(t.numel() * t.element_size() for t in (*ins, out))
        byte_us, op_us = moved / HBM_BYTES_PER_S * 1e6, ops / rate * 1e6
        return max(byte_us, op_us), "bytes" if byte_us >= op_us else "operations"

    def bf16_site(kind, row, call, f32_call, plans, got, twin, ref, run_lib, gemm_plans,
                  ref_f32_operands):
        """Holds a bf16-x call (``got``, through the wrapper) to the f32 arm
        rounded (``twin``) and its plain version (``ref``), then times it at
        this tree's plan, cuDNN in bf16 (``run_lib``), the f32 arm, and with
        --parent the parent's call at its plan and its f32 arm at this tree's
        f32-x plan (the first that rounded, bit for bit; the second within
        RTOL of ``ref_f32_operands``, the parent's function), and with
        --sweep every bf16-x plan; returns the report row, or None after
        printing a failure."""
        plan, plan32, parent_plan = plans
        out, out32 = row.pop("out"), row.pop("out32")
        where = f"{row['site']} B={row['streams']} N={row['frames']}"
        torch.cuda.synchronize()
        if not torch.equal(got, twin):
            print(f"FAIL {where}: the bf16 arm is not the f32 arm rounded", flush=True)
            return None
        err = (got.float() - ref.float()).abs()
        limit = RTOL * float(ref.float().abs().max()) + (
            BF16_STEP * ref.float().abs() if got.dtype == bf16 else 0.0)
        if not bool((err <= limit).all()):
            print(f"FAIL {where}: max|err| {float(err.max())} beyond its bound", flush=True)
            return None
        new_lib = libs[kind]["new"]
        call(new_lib, plan, out)
        f32_call(new_lib, plan32, out32)
        torch.cuda.synchronize()
        if not torch.equal(out, got):
            print(f"FAIL {where}: the C entry at the plan differs from the wrapper", flush=True)
            return None
        mine32 = out32.clone()
        row.update(plan=list(plan), f32_plan=list(plan32), max_abs_err=float(err.max()),
                   kernel_us=device_us(lambda: call(new_lib, plan, out)),
                   cudnn_bf16_us=device_us(run_lib),
                   f32_us=device_us(lambda: f32_call(new_lib, plan32, out32)))
        line = (f"{row['site']:7s} B={row['streams']:<2d} N={row['frames']:<3d} plan {plan}: "
                f"kernel {row['kernel_us']:.1f} us, cudnn bf16 {row['cudnn_bf16_us']:.1f} us, "
                f"f32 arm {row['f32_us']:.1f} us, bound {row['bound_us']:.2f} us "
                f"({row['bound_by']})")
        if "parent" in libs[kind]:
            lib = libs[kind]["parent"]
            out.zero_()
            call(lib, parent_plan, out)
            out32.zero_()
            f32_call(lib, plan32, out32)
            torch.cuda.synchronize()
            p_err = float((out32 - ref_f32_operands).abs().max())
            if not (torch.equal(out, out32.to(out.dtype))
                    and p_err <= RTOL * float(ref_f32_operands.abs().max())):
                print(f"FAIL {where}: the parent's bf16 call is not its f32 arm rounded, or "
                      f"that arm is {p_err} from its function", flush=True)
                return None
            row.update(parent_plan=list(parent_plan),
                       parent_us=device_us(lambda: call(lib, parent_plan, out)),
                       parent_f32_us=device_us(lambda: f32_call(lib, plan32, out32)))
            line += (f", parent {row['parent_us']:.1f} us at {parent_plan}, parent f32 arm "
                     f"{row['parent_f32_us']:.1f} us")
        if "variant" in libs[kind]:  # this tree built with other flags, at the plan
            lib = libs[kind]["variant"]
            out.zero_()
            call(lib, plan, out)
            torch.cuda.synchronize()
            if not torch.equal(out, got):
                print(f"FAIL {where}: the variant's bits differ", flush=True)
                return None
            row["variant_us"] = device_us(lambda: call(lib, plan, out))
            line += f", variant {row['variant_us']:.1f} us (bit-equal)"
        if args.sweep and gemm_plans:
            sweep = {}
            for p in gemm_plans:
                out.zero_()
                call(new_lib, p, out)
                torch.cuda.synchronize()
                if not torch.equal(out, got):
                    print(f"FAIL {where}: plan {p} differs from the planned {plan}", flush=True)
                    return None
                sweep[f"{p[-2]},{p[-1]}"] = graph_us(lambda: call(new_lib, p, out), out, got)
            best = min(sweep, key=sweep.get)
            at_plan = sweep[f"{plan[-2]},{plan[-1]}"]
            if at_plan < 0.5 * row["kernel_us"]:
                print(f"FAIL {where}: the planned plan's graph time {at_plan:.2f} us is under "
                      f"half its device time {row['kernel_us']:.2f} us", flush=True)
                return None
            row["sweep_us"] = sweep
            line += (f"; sweep: best {best} {sweep[best]:.1f} us, planned {at_plan:.1f} us "
                     f"(all {len(sweep)} plans equal bit for bit)")
        print(line, flush=True)
        return row

    def conv_dtypes(cin, cout):
        """The bf16-boundary path's x and out dtypes at a causal_conv site:
        the audio in and out f32, bf16 between launches."""
        return torch.float32 if cin == 1 else bf16, torch.float32 if cout == 1 else bf16

    for batch, n_frames in DISPATCHES if args.only != "f32" else ():
        rows_of = []
        for name, cin, cout, taps, stride, leaky, tanh, rows in sites:
            if name.startswith("v"):  # the receiver's: not on these paths
                continue
            t_out = rows * n_frames
            x_dt, y_dt = conv_dtypes(cin, cout)
            # bf16-exact caches (the tails of bf16 activations, widened), streams 5 rows apart
            cache = rn(batch, taps - 1 + 5, cin)[:, 5:]
            if cin > 1:
                cache.copy_(cache.to(bf16).float())
            x = rn(batch, t_out * stride, cin).to(x_dt)
            wb = (rn(taps, cin, cout) / (taps * cin) ** 0.5).to(bf16)
            b = rn(cout)
            out = torch.empty(batch, t_out, cout, device="cuda", dtype=y_dt)
            out32 = torch.empty(batch, t_out, cout, device="cuda")
            x32 = x.float()
            plan = mk._conv_plan(batch, t_out, cin, cout, taps, stride, 1, True, x_dt == bf16)
            plan32 = mk._conv_plan(batch, t_out, cin, cout, taps, stride, 1, True)
            parent_plan = (parent_mk._conv_plan(batch, t_out, cin, cout, taps, stride, 1, True)
                           if parent_mk else None)
            types = 1 | (x_dt == bf16) << 1 | (y_dt == bf16) << 2

            def run(lib, plan, into, xx=x, types=types, cache=cache, wb=wb, b=b,
                    t_out=t_out, cin=cin, cout=cout, taps=taps, stride=stride, name=name):
                _cuda.check(lib, lib.dse_causal_conv(
                    cache.data_ptr(), cache.stride(0), xx.data_ptr(), wb.data_ptr(),
                    b.data_ptr(), into.data_ptr(), batch, t_out, cin, cout, taps, stride, 1, 0,
                    0.0, 0, types, mk.CONV_ARMS.index(plan[0]), plan[1], plan[2],
                    torch.cuda.current_stream().cuda_stream), f"causal_conv {name}")

            def run32(lib, plan, into, run=run, x32=x32):
                run(lib, plan, into, xx=x32, types=1)

            got = mk.causal_conv(cache, x, wb, b, stride, out_dtype=y_dt)
            twin = mk.causal_conv(cache, x32, wb, b, stride).to(y_dt)
            ref = mk.causal_conv_plain(cache, x, wb, b, stride, out_dtype=y_dt)
            x_lib = torch.cat([cache, x32], dim=1).transpose(1, 2).to(bf16).contiguous()
            w_lib = wb.permute(2, 1, 0).contiguous()
            b_lib = b.to(bf16)
            arm = plan[0]
            row = bf16_site("conv", {
                "site": name, "streams": batch, "frames": n_frames, "x": "bf16",
                "layer": [cin, cout, taps, stride], "rows": batch * t_out, "t_out": t_out,
                "arm": arm, "out": out, "out32": out32,
                **dict(zip(("bound_us", "bound_by"), bound(
                    (x, cache, wb, b), out, 2.0 * batch * t_out * taps * cin * cout,
                    F32_FLOPS if arm != "gemm" else BF16_FLOPS)))},
                run, run32, (plan, plan32, parent_plan), got, twin, ref,
                lambda x_lib=x_lib, w_lib=w_lib, b_lib=b_lib, stride=stride:
                F.conv1d(x_lib, w_lib, b_lib, stride),
                [("gemm", *p[:2]) for p in mk.conv_gemm_plans(cin, cout, taps, stride, 1, True,
                                                              True, t_out)]
                if arm == "gemm" and x_dt == bf16 else None,
                mk.causal_conv_plain(cache, x32, wb.float(), b, stride))
            if row is None:
                return 1
            rows_of.append(("causal_conv", row))
        for name, cin, cout, stride, leaky, rows in upsamples:
            if name.startswith("v"):
                continue
            t_in = rows * n_frames
            cache = rn(batch, 1 + 5, cin)[:, 5:]
            cache.copy_(cache.to(bf16).float())
            x = rn(batch, t_in, cin).to(bf16)
            x32 = x.float()
            wb = (rn(2 * stride, cin, cout) / (2 * cin) ** 0.5).to(bf16)  # conv-ready, flipped
            b = rn(cout)
            out = torch.empty(batch, t_in * stride, cout, device="cuda", dtype=bf16)
            out32 = torch.empty(batch, t_in * stride, cout, device="cuda")
            plan = mk._upsample_plan(batch, t_in, cin, cout, stride, True, True)
            plan32 = mk._upsample_plan(batch, t_in, cin, cout, stride, True)
            parent_plan = (parent_mk._upsample_plan(batch, t_in, cin, cout, stride, True)
                           if parent_mk else None)

            def run(lib, plan, into, xx=x, types=3, cache=cache, wb=wb, b=b, t_in=t_in,
                    cin=cin, cout=cout, stride=stride, name=name):
                _cuda.check(lib, lib.dse_causal_conv_transpose(
                    cache.data_ptr(), cache.stride(0), xx.data_ptr(), wb.data_ptr(),
                    b.data_ptr(), into.data_ptr(), batch, t_in, cin, cout, stride, 0, 0.0,
                    types, *plan, torch.cuda.current_stream().cuda_stream),
                    f"causal_conv_transpose {name}")

            def run32(lib, plan, into, run=run, x32=x32):
                run(lib, plan, into, xx=x32, types=1)

            got = mk.causal_conv_transpose(cache, x, wb, b, stride)
            twin = mk.causal_conv_transpose(cache, x32, wb, b, stride).to(bf16)
            ref = mk.causal_conv_transpose_plain(cache, x, wb, b, stride)
            x_lib = torch.cat([cache, x32], dim=1).transpose(1, 2).to(bf16).contiguous()
            w_lib = wb.flip(0).permute(1, 2, 0).contiguous()  # (Cin, Cout, k)
            b_lib = b.to(bf16)
            row = bf16_site("upsample", {
                "site": name, "streams": batch, "frames": n_frames, "x": "bf16",
                "layer": [cin, cout, 2, 1], "phases": stride, "rows": batch * t_in,
                "t_out": t_in, "arm": "gemm", "out": out, "out32": out32,
                **dict(zip(("bound_us", "bound_by"), bound(
                    (x, cache, wb, b), out, 2.0 * batch * t_in * stride * 2 * cin * cout,
                    BF16_FLOPS)))},
                run, run32, (plan, plan32, parent_plan), got, twin, ref,
                lambda x_lib=x_lib, w_lib=w_lib, b_lib=b_lib, stride=stride:
                F.conv_transpose1d(x_lib, w_lib, b_lib, stride, stride),
                [p[:2] for p in mk.conv_gemm_plans(cin, cout, 2, 1, 1, True, True, t_in)],
                mk.causal_conv_transpose_plain(cache, x32, wb.float(), b, stride))
            if row is None:
                return 1
            rows_of.append(("causal_conv_transpose", row))
        for path, skip in (("denoiser", ("prj", "dec_in")), ("codec", ())):
            for kernel in ("causal_conv", "causal_conv_transpose"):
                picked = [r for k, r in rows_of if k == kernel and r["site"] not in skip]
                total = {key: sum(r[key] for r in picked) / 1e3 for key in (
                    "kernel_us", "cudnn_bf16_us", "f32_us", "bound_us", "parent_us",
                    "parent_f32_us", "variant_us") if all(key in r for r in picked)}
                entry = {"path": path, "streams": batch, "frames": n_frames, "kernel": kernel,
                         "calls": len(picked),
                         **{key.replace("_us", "_ms"): v for key, v in total.items()}}
                report["dispatches"].append(entry)
                print(f"dispatch {path} B={batch} N={n_frames} {kernel}.bf16: "
                      + ", ".join(f"{k} {v:.4f}" for k, v in entry.items()
                                  if k.endswith("_ms")), flush=True)
        report["bf16_sites"] += [r for _, r in rows_of]
    print("end:", _card())
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
