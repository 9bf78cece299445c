"""N=1 latency of the codec and receiver streams in fresh processes, to tell a
change in host time apart from run-to-run spread, on one card.

    python dl_speech_enhancement_tpu_torch/tools/host_latency.py \\
        --tree parent=DIR --tree change=DIR \\
        --order parent,change,change,parent,change+vocoder --out FILE

``DIR`` is the root of a checkout (its ``dl_speech_enhancement_tpu_torch/``
and ``configs/``); the script itself may come from another checkout. Each
entry of ``--order`` runs one child process on that tree's package, which:

- builds the tree's kernels (not timed);
- builds the flagship denoiser (configs/denoise/symAD_vctk_48000_hop300.yaml,
  without PQC) and the PQC codec (configs/autoencoder/
  symAD_vctk_48000_hop300.yaml) with seeded random weights and codebooks;
- with ``+vocoder`` first drives the AudioDec v1 receiver (configs/vocoder/
  AudioDec_v1_symAD_vctk_48000_hop300_clean.yaml) as ``chip_smoke.py``'s
  phase 3 does before its codec timings: ``make_vocoder_scan_stream`` over
  200 frames in two dispatches and a 16-stream fleet over 16 frames, whose
  models, streams and outputs it keeps alive;
- times ``make_scan_stream(gen, frame_size=1200)`` of each codec at one
  frame per dispatch, the cache carried (10 warm-up and 200 timed
  dispatches; wall time on the host clock around the call and a
  synchronize, and the host time until the call returns), and the same for
  the ``vctk_v1`` and ``vctk_v0`` receiver paths, ``make_vocoder_scan_stream``
  of the codec and the AudioDec v1 receiver, and of the codec and the
  AudioDec v0 (MultiReceptiveField) receiver (bf16 weights);
- digests (SHA-256) each receiver path's audio over those frames from zero
  caches, so two trees whose digests agree computed it bit for bit alike;
- times the host cost of one ``causal_conv`` / ``causal_conv_transpose`` /
  ``residual_chain`` wrapper call (2000 calls on a 4-row, 32-channel input,
  so that the host sets the pace wherever the call takes longer than its
  kernel).

The parent process prints one line per child and writes every child's
numbers, the card's name and power limit and the order to ``--out``, then
the summary that ``--summary FILE`` prints for such a file: per entry and
metric the median over its runs and the quartiles of those runs, and for
each two runs in a row that come from different entries (the pairs of an
order such as ``parent,change,change,parent``), which one was lower.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

FRAME = 1200
REPS, WARMUP = 200, 10
WRAPPER_CALLS = 2000


def _latency(torch, run, frames):
    cache, walls, enqueue = run.init_cache(), [], []
    for i in range(len(frames)):
        t0 = time.perf_counter()
        _, cache = run(cache, frames[i:i + 1])
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        if i >= WARMUP:
            walls.append((time.perf_counter() - t0) * 1e3)
            enqueue.append((t1 - t0) * 1e3)
    walls.sort()
    return {"median_ms": statistics.median(walls), "p90_ms": walls[int(0.9 * len(walls)) - 1],
            "enqueue_median_ms": statistics.median(enqueue)}


def _wrapper_us(torch, fn, *args):
    for _ in range(50):
        fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(WRAPPER_CALLS):
        fn(*args)
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host / WRAPPER_CALLS * 1e6


def _receiver(root, load_config, version="v1"):
    from dl_speech_enhancement_tpu_torch.models import HiFiGANGenerator

    gp = dict(load_config(os.path.join(
        root, "configs", "vocoder", f"AudioDec_{version}_symAD_vctk_48000_hop300_clean.yaml"))
        ["generator_params"])
    gp.pop("nonlinear_activation")
    gp["negative_slope"] = gp.pop("nonlinear_activation_params")["negative_slope"]
    for key in ("use_weight_norm", "stats"):
        gp.pop(key)
    return HiFiGANGenerator(**gp, seed=0)


def _drive_vocoder(torch, root, codec, vq, load_config):
    from dl_speech_enhancement_tpu_torch.parallel import make_sharded_stream
    from dl_speech_enhancement_tpu_torch.stream.runtime import make_vocoder_scan_stream

    voc = _receiver(root, load_config)
    kept = [voc]
    run = make_vocoder_scan_stream(codec, vq, voc, FRAME, weight_dtype=torch.float32)
    frames = torch.randn(200, FRAME, device="cuda") * 0.1
    cache = run.init_cache()
    for part in (frames[:100], frames[100:]):
        out, cache = run(cache, part)
        kept.append(out)
    fleet = make_sharded_stream(codec, vq, batch=16, vocoder=voc)
    frames = torch.randn(16, 16, FRAME, 1, device="cuda") * 0.1
    cache = fleet.init_cache()
    for part in (frames[:8], frames[8:]):
        out, cache = fleet(cache, part)
        kept.append(out)
    torch.cuda.synchronize()
    kept += [run, fleet, cache]
    return kept


def child(root: str, vocoder: bool) -> dict:
    sys.path.insert(0, root)
    import gc

    import torch

    import dl_speech_enhancement_tpu_torch as port
    from dl_speech_enhancement_tpu_torch.models import AudioDecGenerator
    from dl_speech_enhancement_tpu_torch.ops import _cuda
    from dl_speech_enhancement_tpu_torch.ops.mega_kernel import (
        causal_conv,
        causal_conv_transpose,
    )
    from dl_speech_enhancement_tpu_torch.ops.stream_kernel import residual_chain
    from dl_speech_enhancement_tpu_torch.stream.runtime import (
        make_scan_stream,
        make_vocoder_scan_stream,
    )
    from dl_speech_enhancement_tpu_torch.utils.config import load_config

    if not os.path.abspath(port.__file__).startswith(os.path.abspath(root)):
        raise RuntimeError(f"imported {port.__file__}, not the package under {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _cuda.build()
    for name in _cuda.SOURCES:
        _cuda.load(name)
    gp = load_config(os.path.join(root, "configs", "denoise",
                                  "symAD_vctk_48000_hop300.yaml"))["generator_params"]
    gen = AudioDecGenerator(**gp, use_pqc=False, seed=0)
    cgp = load_config(os.path.join(root, "configs", "autoencoder",
                                   "symAD_vctk_48000_hop300.yaml"))["generator_params"]
    codec = AudioDecGenerator(**cgp, use_pqc=True, seed=0)
    vq = codec.quantizer.init(seed=0)
    kept = _drive_vocoder(torch, root, codec, vq, load_config) if vocoder else []

    frames = torch.randn(REPS + WARMUP, 1, FRAME, 1,
                         generator=torch.Generator().manual_seed(1)).cuda() * 0.1
    report = {"root": root, "vocoder_first": vocoder, "kept_objects": len(kept),
              "gc_tracked_objects": len(gc.get_objects()),
              "cuda_reserved_bytes": torch.cuda.memory_reserved()}
    report["denoiser"] = _latency(torch, make_scan_stream(gen, frame_size=FRAME), frames)
    report["codec"] = _latency(torch, make_scan_stream(codec, vq, frame_size=FRAME), frames)
    for version in ("v1", "v0"):
        receiver = make_vocoder_scan_stream(codec, vq, _receiver(root, load_config, version),
                                            FRAME)
        report[f"receiver_{version}"] = _latency(torch, receiver, frames[:, 0, :, 0])
        audio, _ = receiver(receiver.init_cache(), frames[:, 0, :, 0])
        report[f"receiver_{version}_digest"] = hashlib.sha256(
            audio.cpu().numpy().tobytes()).hexdigest()
    g = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn(1, 4, 32, device="cuda", generator=g)
    cache = torch.randn(1, 6, 32, device="cuda", generator=g)
    w = torch.randn(7, 32, 32, device="cuda", generator=g).to(torch.bfloat16)
    wt = torch.randn(4, 32, 32, device="cuda", generator=g).to(torch.bfloat16)
    b = torch.zeros(32, device="cuda")
    report["causal_conv_host_us"] = _wrapper_us(torch, causal_conv, cache, x, w, b, 1, 1)
    report["causal_conv_transpose_host_us"] = _wrapper_us(
        torch, causal_conv_transpose, cache[:, :1], x, wt, b, 2)
    # a chain whose plan takes a cluster of several blocks (and its scratch)
    chain_cache = torch.randn(1, 78, 32, device="cuda", generator=g)
    w1 = torch.randn(3, 7, 32, 32, device="cuda", generator=g).to(torch.bfloat16)
    w2 = torch.randn(3, 32, 32, device="cuda", generator=g).to(torch.bfloat16)
    report["residual_chain_host_us"] = _wrapper_us(torch, residual_chain, chain_cache,
                                                   x[:, :4].contiguous(), w1, w2)
    return report


METRICS = (("denoiser", "median_ms"), ("codec", "median_ms"), ("receiver_v1", "median_ms"),
           ("receiver_v0", "median_ms"), ("causal_conv_host_us", None),
           ("causal_conv_transpose_host_us", None), ("residual_chain_host_us", None))


def _quartiles(xs):
    q = statistics.quantiles(xs, n=4) if len(xs) > 1 else [xs[0]] * 3
    return q[0], q[2]


def summary(result: dict) -> list[str]:
    runs, lines = result["runs"], [result["card"]]
    entries = sorted({r["entry"] for r in runs})
    for version in ("v1", "v0"):
        key = f"receiver_{version}_digest"
        digests = {r["entry"]: sorted({q[key] for q in runs
                                       if q["entry"] == r["entry"] and key in q})
                   for r in runs}
        lines.append(f"receiver {version} audio digests: " + "; ".join(
            f"{entry} {' '.join(d[:12] for d in ds)}" for entry, ds in sorted(digests.items()))
            + ("; all equal" if len({d for ds in digests.values() for d in ds}) == 1
               else "; they differ"))
    for key, sub in METRICS:
        def value(r):
            return r[key][sub] if sub else r[key]

        for entry in entries:
            xs = [value(r) for r in runs if r["entry"] == entry]
            lo, hi = _quartiles(xs)
            lines.append(f"{key:30s} {entry:16s} runs {len(xs):2d} median "
                         f"{statistics.median(xs):.4f} quartiles {lo:.4f} / {hi:.4f}")
        wins = {}
        for a, b in zip(runs[0::2], runs[1::2]):
            if a["entry"] != b["entry"] and value(a) != value(b):
                low = a if value(a) < value(b) else b
                pair = " vs ".join(sorted((a["entry"], b["entry"])))
                wins.setdefault(pair, {}).setdefault(low["entry"], 0)
                wins[pair][low["entry"]] += 1
        for pair, counts in wins.items():
            lines.append(f"{key:30s} pairs {pair}: lower in " + ", ".join(
                f"{entry} {n}" for entry, n in sorted(counts.items())))
    return lines


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", default=[], help="NAME=DIR")
    ap.add_argument("--order", help="comma-separated NAME or NAME+vocoder")
    ap.add_argument("--out")
    ap.add_argument("--summary", metavar="FILE", help="print the summary of an --out file")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--vocoder", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.child, args.vocoder)))
        return 0
    if args.summary:
        with open(args.summary) as f:
            print("\n".join(summary(json.load(f))))
        return 0
    trees = dict(t.split("=", 1) for t in args.tree)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()
    runs = []
    for i, entry in enumerate(args.order.split(",")):
        name, _, extra = entry.partition("+")
        cmd = [sys.executable, os.path.abspath(__file__), "--child",
               os.path.abspath(trees[name])] + (["--vocoder"] if extra == "vocoder" else [])
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        rep = json.loads(proc.stdout.strip().splitlines()[-1])
        rep.update(run=i + 1, entry=entry)
        runs.append(rep)
        print(f"{i + 1:2d} {entry:16s} denoiser {rep['denoiser']['median_ms']:.3f} ms "
              f"(enqueue {rep['denoiser']['enqueue_median_ms']:.3f}) codec "
              f"{rep['codec']['median_ms']:.3f} ms (enqueue "
              f"{rep['codec']['enqueue_median_ms']:.3f}) receiver v1 "
              f"{rep['receiver_v1']['median_ms']:.3f} ms, digest "
              f"{rep['receiver_v1_digest'][:12]}; receiver v0 "
              f"{rep['receiver_v0']['median_ms']:.3f} ms, digest "
              f"{rep['receiver_v0_digest'][:12]}; wrapper host us: causal_conv "
              f"{rep['causal_conv_host_us']:.2f}, causal_conv_transpose "
              f"{rep['causal_conv_transpose_host_us']:.2f}; gc objects "
              f"{rep['gc_tracked_objects']}", flush=True)
    result = {"card": card, "order": args.order, "trees": trees, "runs": runs}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print("\n".join(summary(result)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
