"""Device time of rvq_assign at every row count of the codec's paths and of
T1's fold_copy at the probe's shapes, on one card, against their plain
versions, their bounds, a yardstick and, optionally, the kernels of another
checkout.

    python dl_speech_enhancement_tpu_torch/tools/rvq_timing.py [--parent DIR]
        [--sweep] [--out FILE]

rvq_assign: seeded books (8, 64, 1024) and rows (R, 64), R the rows of one
stream at 1, 100 and 400 frames (4, 400, 1,600), of 16 streams at 1 and 16
frames (64, 1,024) and of 64 streams at 1 and 16 frames (256, 4,096). For
each R it holds the kernel against its plain version up to near ties
(``utils/checks.py::rvq_near_ties``, 1e-5) and prints the device time per
call (CUDA events around a CUDA graph of 20 launches) at the planner's plan
(``ops/mega_kernel.py::_rvq_plan``) with all 8 books and with the first
book alone (the rest is the cost of 7 stages), how many of its clusters the
card holds at once (cudaOccupancyMaxActiveClusters), its event time, the
plain version's time, the bound (operations at 67 TFLOP/s f32 or bytes at
3.35 TB/s) and, with ``--parent``, the time of the kernel built from
``DIR``'s ``csrc/rvq_assign.cu`` (its own entry point and plan) and whether
its codes equal this tree's. ``--sweep`` also times, for clusters of 16 and
8 blocks with every book resident or 4 or 3 slots, the largest tile that
fits with as many clusters as the card runs at once carrying the rows in
one pass where they can (how the planner's regimes were chosen), each
required to give the planner's codes bit for bit.

fold_copy: the four shapes the probe folds (``tools/reshape_probe.py``),
the kernel's device time (CUDA graph) and event time (back-to-back calls)
against ``torch.clone`` of the folded view (both ways), the host time of a
wrapper call (the calls enqueued with no synchronisation, over their
count), and the parent's kernel with ``--parent``.

The card first runs matmuls for 3 s so that its clocks leave idle; the
card's name, power limit and SM clock are printed before and after.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import time

SITES = ((1, 1), (1, 100), (1, 400), (16, 1), (16, 16), (64, 1), (64, 16))  # (streams, frames)
ROWS_A_FRAME = 4  # 1200 samples at hop 300
D, K, L = 64, 1024, 8
F32_FLOPS, HBM_BYTES_PER_S = 67e12, 3.35e12


def _parent_lib(root: str, build_dir: str, name: str):
    """``DIR``'s csrc/<name>.cu built into its own library (its C entry as it
    was: fold_copy's and rvq_assign's before the cluster plan take the
    operands, the shape and the stream)."""
    from dl_speech_enhancement_tpu_torch.ops import _cuda

    src = os.path.join(root, "dl_speech_enhancement_tpu_torch", "csrc", f"{name}.cu")
    path = os.path.join(build_dir, f"{name}_parent.so")
    os.makedirs(build_dir, exist_ok=True)
    proc = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", path, src],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc {src} failed:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(path)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = getattr(lib, f"dse_{name}")
    fn.argtypes = ([p, p, p, p, i, i, i, i, p] if name == "rvq_assign"
                   else [p, p, i, i, i, i, p])
    fn.restype = i
    return fn


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="a checkout whose kernels are timed beside")
    ap.add_argument("--sweep", action="store_true", help="time other plans too")
    ap.add_argument("--out", help="write the numbers as JSON here")
    args = ap.parse_args()
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.path.insert(0, root)
    import torch

    from dl_speech_enhancement_tpu_torch.ops import _cuda
    from dl_speech_enhancement_tpu_torch.ops import mega_kernel as mk
    from dl_speech_enhancement_tpu_torch.tools import reshape_probe
    from dl_speech_enhancement_tpu_torch.tools.conv_timing import _card
    from dl_speech_enhancement_tpu_torch.utils.checks import rvq_near_ties

    if not torch.cuda.is_available():
        print("rvq_timing: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    for name, info in _cuda.build(["rvq_assign", "fold_copy"]).items():
        print(f"{name}: nvcc {info['seconds']:.1f} s", *[
            line.strip() for line in info["log"].splitlines() if "registers" in line
            or "spill" in line], sep="\n  ", flush=True)
    lib = _cuda.load("rvq_assign")
    parent = ({n: _parent_lib(args.parent, str(_cuda.BUILD_DIR), n)
               for n in ("rvq_assign", "fold_copy")} if args.parent else None)
    card = _card()
    print("idle:", card, flush=True)
    a = torch.randn(8192, 8192, device="cuda")
    t0 = time.time()
    while time.time() - t0 < 3:
        a @ a
    torch.cuda.synchronize()
    del a
    print("after warm-up:", _card(), flush=True)
    stream = torch.cuda.Stream()

    def graph_us(fn, reps=20):
        with torch.cuda.stream(stream):
            for _ in range(3):
                fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            for _ in range(reps):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        times = []
        for _ in range(5):
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) * 1e3 / reps)
        return statistics.median(times)

    def event_us(fn, reps=200):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        times = []
        for _ in range(5):
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) * 1e3 / reps)
        return statistics.median(times)

    def host_us(fn, reps=1000):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        host = (time.perf_counter() - t) * 1e6 / reps
        torch.cuda.synchronize()
        return host

    g = torch.Generator(device="cuda").manual_seed(0)
    books = torch.randn(L, D, K, generator=g, device="cuda") * 0.3
    sqnorm = (books * books).sum(1).contiguous()
    books_t = books.transpose(1, 2).contiguous()
    report = {"card": card, "rvq_assign": [], "fold_copy": []}
    failed = []

    def run_plan(z, codes, plan, n_books=L):
        err = lib.dse_rvq_assign(z.data_ptr(), books.data_ptr(), sqnorm.data_ptr(),
                                 books_t.data_ptr(), codes.data_ptr(), z.shape[0], D, K, n_books,
                                 plan.cluster, plan.tile, plan.clusters,
                                 min(plan.stages, n_books), 0,
                                 torch.cuda.current_stream().cuda_stream)
        _cuda.check(lib, err, f"rvq_assign at {tuple(plan)}")

    def co_resident(rows, plan):
        n = ctypes.c_int(0)
        _cuda.check(lib, lib.dse_rvq_assign_max_clusters(rows, D, K, L, plan.cluster, plan.tile,
                                                         plan.stages,
                                                         ctypes.byref(n)),
                    "rvq_assign occupancy")
        return n.value

    for streams, frames in SITES:
        rows = streams * frames * ROWS_A_FRAME
        z = torch.randn(rows, D, generator=g, device="cuda") * 1.2
        plan = mk._rvq_plan(rows, D, K, L)
        codes = torch.empty(rows, L, dtype=torch.int32, device="cuda")
        run_plan(z, codes, plan)
        ref = mk.rvq_assign_plain(z, books, sqnorm)
        torch.cuda.synchronize()
        held = rvq_near_ties(z, books, sqnorm, codes, ref)
        if held["mismatches"]:
            failed.append(f"R={rows}: {held}")
        flops = rows * L * (2.0 * D * K + 3.0 * K)
        nbytes = 4.0 * (z.numel() + books.numel() + sqnorm.numel() + codes.numel())
        bound = max(flops / F32_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e6
        row = {"streams": streams, "frames": frames, "rows": rows, "plan": list(plan),
               "co_resident_clusters": co_resident(rows, plan),
               "device_us": graph_us(lambda: run_plan(z, codes, plan)),
               "one_book_device_us": graph_us(lambda: run_plan(z, codes, plan, 1)),
               "event_us": event_us(lambda: mk.rvq_assign(z, books, sqnorm, books_t), 50),
               "plain_device_us": graph_us(lambda: mk.rvq_assign_plain(z, books, sqnorm)),
               "bound_us": bound,
               "bound_by": "operations" if flops / F32_FLOPS >= nbytes / HBM_BYTES_PER_S
               else "bytes", "near_ties": held["ties"]}
        line = (f"rvq R={rows:5d} plan={tuple(plan)} ({row['co_resident_clusters']} at once): "
                f"{row['device_us']:.2f} us device ({row['one_book_device_us']:.2f} with one "
                f"book), {row['event_us']:.2f} us events, plain "
                f"{row['plain_device_us']:.1f}, bound {bound:.2f} ({row['bound_by']})")
        if parent:
            old = torch.empty_like(codes)

            def run_parent():
                err = parent["rvq_assign"](z.data_ptr(), books.data_ptr(), sqnorm.data_ptr(),
                                           old.data_ptr(), rows, D, K, L,
                                           torch.cuda.current_stream().cuda_stream)
                _cuda.check(lib, err, "parent rvq_assign")

            run_parent()
            torch.cuda.synchronize()
            row["parent_device_us"] = graph_us(run_parent)
            row["parent_codes_equal"] = bool(torch.equal(old, codes))
            line += (f"; parent {row['parent_device_us']:.2f} us, codes "
                     f"{'equal' if row['parent_codes_equal'] else 'DIFFER'}")
        print(line, flush=True)
        if args.sweep:
            # each cluster size and book slots (every book resident, 4, 3)
            # at the largest tile that fits, as many clusters as run at once
            # carrying the rows in one pass where they can
            variants = []
            for cluster in (16, 8):
                groups = mk.rvq_groups(K, cluster)
                if groups > 32 or (cluster - 1) * 4 * groups >= K:
                    continue
                for stages in (L, 4, 3):
                    top = mk._rvq_tile_fit(D, K, cluster, stages, 8 * (512 // groups))
                    if not top:
                        continue
                    tile = min(top, rows)
                    for _ in range(3):
                        co = co_resident(rows, mk.RvqPlan(cluster, tile, 1, stages))
                        tile = min(top, max(1, -(-rows // max(co, 1))))
                    var = mk.RvqPlan(cluster, tile, min(co, -(-rows // tile)), stages)
                    if var != plan and var not in variants:
                        variants.append(var)
            row["sweep"] = []
            for var in variants:
                got = torch.empty_like(codes)
                run_plan(z, got, var)
                torch.cuda.synchronize()
                same = bool(torch.equal(got, codes))
                if not same:
                    failed.append(f"R={rows} plan {tuple(var)}: codes differ from the planner's")
                us = graph_us(lambda v=var, o=got: run_plan(z, o, v))
                row["sweep"].append({"plan": list(var), "device_us": us, "bits_equal": same,
                                     "co_resident_clusters": co_resident(rows, var)})
                print(f"    plan {tuple(var)}: {us:.2f} us, "
                      f"{'same bits' if same else 'BITS DIFFER'}", flush=True)
        report["rvq_assign"].append(row)

    for shape, s, mode in reshape_probe.SHAPES:
        try:
            out_shape = reshape_probe.folded_shape(shape, s, mode)
        except ValueError:
            continue
        x = torch.arange(shape[0] * shape[1], dtype=torch.float32, device="cuda").reshape(shape)
        view = x.reshape(out_shape)
        got = reshape_probe.fold_copy(x, s, mode)
        if not torch.equal(got, view):
            failed.append(f"fold_copy {mode} {shape}: differs from the reshape")
        nbytes = 2.0 * x.numel() * 4
        row = {"shape": list(shape), "s": s, "mode": mode, "bytes": nbytes,
               "bound_us": nbytes / HBM_BYTES_PER_S * 1e6,
               "device_us": graph_us(lambda: reshape_probe.fold_copy(x, s, mode)),
               "event_us": event_us(lambda: reshape_probe.fold_copy(x, s, mode)),
               "host_us": host_us(lambda: reshape_probe.fold_copy(x, s, mode)),
               "library_device_us": graph_us(view.clone),
               "library_event_us": event_us(view.clone),
               "library_host_us": host_us(view.clone)}
        if parent:
            out = torch.empty_like(got)

            def run_parent():
                err = parent["fold_copy"](x.data_ptr(), out.data_ptr(), shape[0], shape[1], s,
                                          int(mode == "unfold"),
                                          torch.cuda.current_stream().cuda_stream)
                _cuda.check(lib, err, "parent fold_copy")

            row["parent_device_us"] = graph_us(run_parent)
        print(f"fold_copy {mode} {tuple(shape)} s={s}: " + ", ".join(
            f"{k} {v:.2f}" for k, v in row.items() if k.endswith("_us")), flush=True)
        report["fold_copy"].append(row)

    report["after"] = _card()
    print("after:", report["after"], flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    for msg in failed:
        print("FAIL", msg)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
