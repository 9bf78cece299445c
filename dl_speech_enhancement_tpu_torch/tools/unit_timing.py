"""Device time of one hifigan_unit launch at the receivers' unit shapes, on
one card, against cuDNN and, optionally, the unit kernel of another
checkout.

    python dl_speech_enhancement_tpu_torch/tools/unit_timing.py [--parent DIR]
        [--out FILE]

For each shape (streams, rows, c, groups, taps, dilation) it holds the
kernel at bf16 weights against its plain version
(``utils/checks.py::rounding_held``) and prints the device
time per call (``torch.profiler``, 50 calls after 5 warm-up calls, bf16
weights) of this tree's kernel at its planner's (tile, cluster), of the two
grouped ``F.conv1d`` calls that compute the unit's convolutions in f32 (TF32
off) and in bf16, and its bound (the operations at 989 TFLOP/s or the bytes
at 3.35 TB/s). With ``--parent`` it also builds the unit kernel of ``DIR``'s
``dl_speech_enhancement_tpu_torch/csrc/hifigan_unit.cu`` (an entry point
with this tree's arguments, planned by ``DIR``'s own
``ops/vocoder_kernel.py::_unit_plan``), holds its bf16-weight call to the
function it computes (the plain version on f32 operands, 1e-4 of the
largest output), requires this tree's call with f32 weights to equal the
parent's bit for bit, and times the parent. The card first runs matmuls for
3 s so that its clocks leave idle; the card's name, power limit and SM clock
are printed before and after.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys
import time

# (streams, rows, c, groups, taps, dilation): the v0 receiver's stages at one
# frame, v1's stage 0, the v0 stages at 100 frames (k = 7), 16 streams and
# stage 0 at 400 frames
SHAPES = ((1, 20, 256, 1, 3, 1), (1, 20, 256, 1, 11, 5), (1, 20, 256, 3, 11, 1),
          (1, 100, 128, 1, 11, 5), (1, 400, 64, 1, 11, 5), (1, 1200, 32, 1, 11, 5),
          (1, 2000, 256, 1, 7, 3), (1, 10000, 128, 1, 7, 3), (1, 40000, 64, 1, 7, 3),
          (1, 120000, 32, 1, 7, 3), (16, 20, 256, 1, 11, 5), (1, 8000, 256, 1, 11, 5))


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()


def _parent_unit(root: str, build_dir: str):
    """The unit kernel of ``root`` (its entry point takes this tree's
    arguments) and its planner."""
    from dl_speech_enhancement_tpu_torch.ops import _cuda

    os.makedirs(build_dir, exist_ok=True)
    lib_path = os.path.join(build_dir, "hifigan_unit_parent.so")
    subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", lib_path,
                    os.path.join(root, "dl_speech_enhancement_tpu_torch", "csrc",
                                 "hifigan_unit.cu")], check=True, capture_output=True)
    lib = ctypes.CDLL(lib_path)
    argtypes, restype = _cuda._ENTRIES["hifigan_unit"]["dse_hifigan_unit"]
    lib.dse_hifigan_unit.argtypes, lib.dse_hifigan_unit.restype = argtypes, restype
    lib.dse_error_string.argtypes = [ctypes.c_int]
    lib.dse_error_string.restype = ctypes.c_char_p
    spec = importlib.util.spec_from_file_location(
        "parent_vocoder_kernel",
        os.path.join(root, "dl_speech_enhancement_tpu_torch", "ops", "vocoder_kernel.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return lib, mod._unit_plan


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="a checkout whose unit kernel is timed beside")
    ap.add_argument("--out", help="write the rows as JSON here")
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    import torch
    import torch.nn.functional as F

    from dl_speech_enhancement_tpu_torch.ops import _cuda, vocoder_kernel
    from dl_speech_enhancement_tpu_torch.utils.checks import rounding_held

    if not torch.cuda.is_available():
        print("unit_timing: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    new = _cuda.load("hifigan_unit")
    parent = (_parent_unit(args.parent, str(_cuda.BUILD_DIR)) if args.parent else None)
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

    stream = torch.cuda.current_stream().cuda_stream
    rows_out = []
    for batch, rows, c, groups, taps, d in SHAPES:
        gc = groups * c
        c1, c2, x = rn(batch, (taps - 1) * d, gc), rn(batch, taps - 1, gc), rn(batch, rows, gc)
        w1 = rn(taps, c, gc) / 0.3 / (taps * c) ** 0.5
        w2 = rn(taps, c, gc) / 0.3 / (taps * c) ** 0.5
        w1b, w2b = w1.bfloat16(), w2.bfloat16()
        b1, b2 = rn(gc), rn(gc)
        out, n2 = torch.empty(batch, rows, gc, device="cuda"), torch.empty_like(c2)

        def call(lib, plan, w1=w1b, w2=w2b, tag="unit"):
            _cuda.check(lib, lib.dse_hifigan_unit(
                c1.data_ptr(), c1.stride(0), c2.data_ptr(), c2.stride(0), x.data_ptr(),
                w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), None, 1.0,
                out.data_ptr(), n2.data_ptr(), batch, rows, c, groups, 0, taps, d, *plan, 0.1,
                int(w1.dtype == torch.bfloat16), stream), tag)
            return out

        plan = vocoder_kernel._unit_plan(batch, rows, c, groups, taps, d, True)
        got = call(new, plan).clone()
        ref = vocoder_kernel.hifigan_unit_plain(c1, c2, x, w1b, b1, w2b, b2, d, groups)[0]
        held = rounding_held(got, ref, vocoder_kernel.hifigan_unit_plain(
            c1, c2, x, w1b.float(), b1, w2b.float(), b2, d, groups)[0])
        scale, err = held["scale"], held["max_err"]
        if not held["held"]:
            print(f"FAIL {(batch, rows, c, groups, taps, d)}: {held}", flush=True)
            return 1
        x1, h1 = rn(batch, gc, rows + (taps - 1) * d), rn(batch, gc, rows + taps - 1)
        wl1, wl2 = rn(gc, c, taps), rn(gc, c, taps)
        lib16 = [t.bfloat16() for t in (x1, h1, wl1, wl2, b1, b2)]

        def run_lib(x1=x1, h1=h1, wl1=wl1, wl2=wl2, b1=b1, b2=b2):
            F.conv1d(x1, wl1, b1, dilation=d, groups=groups)
            F.conv1d(h1, wl2, b2, groups=groups)

        flops = 2 * 2.0 * batch * rows * taps * c * gc
        moved = sum(t.numel() * t.element_size() for t in (c1, c2, x, w1b, w2b, b1, b2, out, n2))
        row = {"shape": [batch, rows, c, groups, taps, d], "plan": list(plan),
               "max_abs_err": err, "scale": scale,
               "kernel_us": device_us(lambda: call(new, plan)),
               "cudnn_us": device_us(run_lib),
               "cudnn_bf16_us": device_us(lambda: run_lib(*lib16)),
               "bound_us": max(flops / 989e12, moved / 3.35e12) * 1e6}
        line = (f"{tuple(row['shape'])} plan {plan}: kernel {row['kernel_us']:.1f} us, cudnn "
                f"{row['cudnn_us']:.1f} us (bf16 {row['cudnn_bf16_us']:.1f}), bound "
                f"{row['bound_us']:.2f} us, max|err| {err:.1e}")
        if parent:
            lib, parent_plan = parent
            pplan = parent_plan(batch, rows, c, groups, taps, d, True)
            theirs = call(lib, pplan, tag="parent")
            p_ref = vocoder_kernel.hifigan_unit_plain(c1, c2, x, w1b.float(), b1, w2b.float(),
                                                      b2, d, groups)[0]
            torch.cuda.synchronize()
            p_err = float((theirs - p_ref).abs().max())
            mine32 = call(new, vocoder_kernel._unit_plan(batch, rows, c, groups, taps, d, False),
                          w1, w2).clone()
            theirs32 = call(lib, parent_plan(batch, rows, c, groups, taps, d, False), w1, w2,
                            "parent")
            torch.cuda.synchronize()
            if p_err > 1e-4 * float(p_ref.abs().max()) or not torch.equal(mine32, theirs32):
                print(f"FAIL parent {tuple(row['shape'])}: {p_err} from its function, or f32 "
                      f"weights differ by {float((mine32 - theirs32).abs().max())}", flush=True)
                return 1
            row.update(parent_plan=list(pplan),
                       parent_us=device_us(lambda: call(lib, pplan, tag="parent")))
            line += (f", parent {row['parent_us']:.1f} us at {pplan} (f32 weights bit for "
                     f"bit)")
        rows_out.append(row)
        print(line, flush=True)
    print("end:", _card())
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "shapes": rows_out}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
