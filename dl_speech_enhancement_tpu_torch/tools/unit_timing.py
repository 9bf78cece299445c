"""Device time of one hifigan_unit launch at the receivers' unit shapes, on
one card, against cuDNN and, optionally, the unit kernel of another
checkout.

    python dl_speech_enhancement_tpu_torch/tools/unit_timing.py [--parent DIR]

For each shape (streams, rows, c, groups, taps, dilation) it prints the
device time per call (``torch.profiler``, 50 calls after 5 warm-up calls,
bf16 weights) of this tree's kernel at its planner's (tile, cluster), of the
two grouped ``F.conv1d`` calls that compute the unit's convolutions (TF32
off), and with ``--parent`` of the unit kernel built from ``DIR``'s
``dl_speech_enhancement_tpu_torch/csrc/hifigan_unit.cu`` with the entry
point of the CUDA-core kernel before clusters (no cluster argument; its
tile chosen by that kernel's own model, repeated here). The card first runs
matmuls for 3 s so that its clocks leave idle; the card's name, power limit
and SM clock are printed before and after.
"""

from __future__ import annotations

import argparse
import ctypes
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
    """The unit kernel of ``root`` with the CUDA-core entry point (no cluster
    argument), and that kernel's tile model."""
    from dl_speech_enhancement_tpu_torch.ops import _cuda

    p, i, ll, z, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_size_t,
                      ctypes.c_float)
    os.makedirs(build_dir, exist_ok=True)
    lib_path = os.path.join(build_dir, "hifigan_unit_parent.so")
    subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", lib_path,
                    os.path.join(root, "dl_speech_enhancement_tpu_torch", "csrc",
                                 "hifigan_unit.cu")], check=True, capture_output=True)
    lib = ctypes.CDLL(lib_path)
    lib.dse_hifigan_unit.argtypes = [p, ll, p, ll, p, p, p, p, p, p, f, p, p, i, i, i, i, i, i,
                                     i, i, f, i, p]
    lib.dse_hifigan_unit.restype = i
    lib.dse_hifigan_unit_smem.argtypes = [i, i, i]
    lib.dse_hifigan_unit_smem.restype = z
    lib.dse_error_string.argtypes = [i]
    lib.dse_error_string.restype = ctypes.c_char_p

    def tile(batch, rows, c, groups, taps):  # that tree's ops/vocoder_kernel.py::_unit_plan
        bm = 128 if c <= 32 else 64
        plans = []
        for t in sorted({4, 8, 16, 32, 64, 128, 256, rows}
                        | {m * bm - (taps - 1) for m in (1, 2, 3, 4)}):
            smem = lib.dse_hifigan_unit_smem(t, c, taps) if 0 < t <= rows else 1 << 30
            if smem > 232448:
                continue
            steps = ((-(-(t + taps - 1) // bm) + -(-t // bm)) * -(-c // (32 if c <= 32 else 64))
                     * taps * -(-c // 32))
            blocks = batch * -(-rows // t) * groups
            per_sm = max(1, min(8, (232448 + 1024) // (smem + 1024)))
            plans.append(((-(-blocks // (132 * per_sm)) * min(per_sm, -(-blocks // 132))
                           * steps, blocks), t))
        return min(plans)[1]

    return lib, tile


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="a checkout whose unit kernel is timed beside")
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    import torch
    import torch.nn.functional as F

    from dl_speech_enhancement_tpu_torch.ops import _cuda, vocoder_kernel

    if not torch.cuda.is_available():
        print("unit_timing: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    new = _cuda.load("hifigan_unit")
    parent = (_parent_unit(args.parent, str(_cuda.BUILD_DIR)) if args.parent else None)
    print("idle:", _card(), flush=True)
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
    for batch, rows, c, groups, taps, d in SHAPES:
        gc = groups * c
        c1, c2, x = rn(batch, (taps - 1) * d, gc), rn(batch, taps - 1, gc), rn(batch, rows, gc)
        w1 = (rn(taps, c, gc) / (taps * c) ** 0.5).bfloat16()
        w2 = (rn(taps, c, gc) / (taps * c) ** 0.5).bfloat16()
        b1, b2 = rn(gc), rn(gc)
        out, n2 = torch.empty(batch, rows, gc, device="cuda"), torch.empty_like(c2)
        ptrs = (c1.data_ptr(), c1.stride(0), c2.data_ptr(), c2.stride(0), x.data_ptr(),
                w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), None, 1.0,
                out.data_ptr(), n2.data_ptr(), batch, rows, c, groups, 0, taps, d)
        plan = vocoder_kernel._unit_plan(batch, rows, c, groups, taps, d, True)

        def run_new():
            _cuda.check(new, new.dse_hifigan_unit(*ptrs, *plan, 0.1, 1, stream), "unit")

        x1, h1 = rn(batch, gc, rows + (taps - 1) * d), rn(batch, gc, rows + taps - 1)
        wl1, wl2 = rn(gc, c, taps), rn(gc, c, taps)

        def run_lib():
            F.conv1d(x1, wl1, b1, dilation=d, groups=groups)
            F.conv1d(h1, wl2, b2, groups=groups)

        line = (f"{(batch, rows, c, groups, taps, d)} plan {plan}: kernel "
                f"{device_us(run_new):.1f} us, cudnn {device_us(run_lib):.1f} us")
        if parent:
            lib, tile_of = parent
            ptile = tile_of(batch, rows, c, groups, taps)

            def run_parent():
                _cuda.check(lib, lib.dse_hifigan_unit(*ptrs, ptile, 0.1, 1, stream), "parent")

            line += f", parent (tile {ptile}) {device_us(run_parent):.1f} us"
        print(line, flush=True)
    print("end:", _card())
    return 0


if __name__ == "__main__":
    sys.exit(main())
