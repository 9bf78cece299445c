"""Where a residual_chain launch spends its time: the kernel against copies of
it with one part taken out, on one card.

    python dl_speech_enhancement_tpu_torch/tools/chain_ablation.py [--out FILE]

Each variant is this tree's ``csrc`` copied into the build directory with one
edit, built with the port's nvcc flags, and called through its
``dse_residual_chain`` at a fixed plan (tile, cluster) on the chain sites
below, bf16 weights; it prints the device time per call (``torch.profiler``,
30 calls after 3 warm-up calls) and the largest error against the plain
version (only ``base`` computes the chain; the others are wrong by design):

- ``base``: the kernel as it is;
- ``no_exchange``: no block publishes its slice or fills its window from the
  cluster's scratch (the window keeps what it held);
- ``no_mma``: each tensor-core product replaced by one f32 multiply-add on
  the same operands, so the operand loads and splits stay;
- ``no_split``: the operands passed to the tensor cores unsplit (hi = lo =
  the f32 value), so the split's integer operations go;
- ``no_products``: a step does no product at all (its weight tiles still
  stream through the ring, its barrier still holds);
- ``bare_steps``: no products and no weight copies, only each step's
  barrier and ring wait.

A variant's time below ``base`` bounds what that part costs.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import time

# (C, rows a stream, streams, tile, cluster): the planner's plans at the
# denoiser's chain sites at one stream of 1 and 100 frames, and e3ch at 16
# and 64 streams of one frame
CASES = ((256, 20, 1, 8, 16), (128, 100, 1, 20, 16), (64, 400, 1, 56, 8),
         (32, 1200, 1, 56, 4), (256, 2000, 1, 64, 8), (128, 10000, 1, 184, 4),
         (32, 120000, 1, 312, 1), (256, 20, 16, 20, 8), (256, 20, 64, 20, 4))
VARIANTS = {
    "base": [],
    "no_exchange": [
        ("residual_chain.cu", "    if (shared) publish<true>(sE, C, c_base, X, off, R, nc);\n",
         ""),
        ("residual_chain.cu", "            fetch(A, lda, sE, R, C);", "            {}"),
        ("residual_chain.cu", "            fetch(A, lda, sH, M, C);", "            {}")],
    "no_mma": [
        ("tile_mma.cuh",
         "              mma_tf32(bg, hi, bh[f][0], bh[f][1]);\n"
         "              mma_tf32(sm, lo, bh[f][0], bh[f][1]);\n"
         "              if constexpr (sizeof(WT) == 4) mma_tf32(sm, hi, bl[f][0], bl[f][1]);",
         "              bg[0] += __uint_as_float(hi[0]) * __uint_as_float(bh[f][0]);\n"
         "              sm[1] += __uint_as_float(lo[3]) * __uint_as_float(bh[f][1]);")],
    "no_split": [
        ("tile_mma.cuh",
         "  hi = tf32_rna(x);\n  lo = tf32_rna(x - __uint_as_float(hi));",
         "  hi = __float_as_uint(x);\n  lo = hi;")],
    "no_products": [("tile_mma.cuh", "      if (live[0]) {\n", "      if (false) {\n")],
    "bare_steps": [
        ("tile_mma.cuh", "      if (live[0]) {\n", "      if (false) {\n"),
        ("tile_mma.cuh",
         "          cp_async<kVec * (int)sizeof(WT)>(dst + dst_off[i], ok ? src + src_off[i] : w,\n"
         "                                           ok ? kVec * (int)sizeof(WT) : 0);",
         "          (void)ok;")],
}


def _build(name: str, edits, build_dir: str):
    """This tree's residual_chain with ``edits`` applied, built and bound."""
    from dl_speech_enhancement_tpu_torch.ops import _cuda

    src = os.path.join(build_dir, f"chain_ablation_{name}")
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(_cuda.CSRC, src)
    for fn, old, new in edits:
        path = os.path.join(src, fn)
        with open(path) as f:
            text = f.read()
        if old not in text:
            raise RuntimeError(f"variant {name}: {fn} no longer holds the text it edits")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    lib_path = os.path.join(src, "residual_chain.so")
    proc = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", lib_path,
                           os.path.join(src, "residual_chain.cu")],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"variant {name}: nvcc failed:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(lib_path)
    lib.dse_residual_chain.argtypes, lib.dse_residual_chain.restype = \
        _cuda._ENTRIES["residual_chain"]["dse_residual_chain"]
    lib.dse_error_string.argtypes, lib.dse_error_string.restype = [ctypes.c_int], \
        ctypes.c_char_p
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the numbers as JSON here")
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    import torch

    from dl_speech_enhancement_tpu_torch.ops import _cuda
    from dl_speech_enhancement_tpu_torch.ops import stream_kernel as sk
    from dl_speech_enhancement_tpu_torch.tools.conv_timing import _card
    from dl_speech_enhancement_tpu_torch.utils.trace import is_device_op

    if not torch.cuda.is_available():
        print("chain_ablation: no CUDA device", file=sys.stderr)
        return 1
    libs = {name: _build(name, edits, str(_cuda.BUILD_DIR)) for name, edits in VARIANTS.items()}
    a = torch.randn(8192, 8192, device="cuda")
    t0 = time.time()
    while time.time() - t0 < 3:
        a @ a
    torch.cuda.synchronize()
    card = _card()
    print(card, flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)

    def rn(*shape):
        return torch.randn(*shape, generator=g, device="cuda") * 0.3

    def device_us(fn, reps=30):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        return sum(e.device_time_total for e in prof.key_averages()
                   if is_device_op(e)) / reps

    report = {"card": card, "cases": []}
    for c, rows, batch, tile, cluster in CASES:
        cache, x = rn(batch, sk.chain_halo(), c), rn(batch, rows, c)
        w1 = (rn(3, 7, c, c) / (7 * c) ** 0.5).bfloat16()
        w2 = (rn(3, c, c) / c ** 0.5).bfloat16()
        ref = sk.residual_chain_plain(cache, x, w1, w2)
        out = torch.empty_like(x)
        scratch = torch.empty(batch * -(-rows // tile) * sk.chain_scratch_floats(tile, c),
                              device="cuda")
        row = {"channels": c, "rows": rows, "streams": batch, "plan": [tile, cluster]}
        for name, lib in libs.items():
            def run(lib=lib):
                _cuda.check(lib, lib.dse_residual_chain(
                    cache.data_ptr(), cache.stride(0), x.data_ptr(), w1.data_ptr(),
                    w2.data_ptr(), out.data_ptr(), scratch.data_ptr(), batch, rows, c,
                    *sk.DILATIONS, tile, cluster, 1, torch.cuda.current_stream().cuda_stream),
                    f"residual_chain {name}")

            run()
            torch.cuda.synchronize()
            row[name] = {"us": device_us(run), "max_abs_err": float((out - ref).abs().max())}
        print(f"C={c} rows={rows} B={batch} plan=({tile},{cluster}): " + ", ".join(
            f"{name} {row[name]['us']:.1f} us" for name in VARIANTS), flush=True)
        report["cases"].append(row)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
