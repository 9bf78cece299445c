"""Phase 7's recipe runs with the native reader and with the plain one, in
turns, on one card: whether the reader moves a training step, the statistics
pass or the loader's wait.

    python -m dl_speech_enhancement_tpu_torch.tools.reader_ab [--rounds 4]
        [--read-passes 30] [--out FILE]

Run from the root of a checkout: it imports ``chip_smoke.py`` for phase 7's
seeded corpus, config cuts and step probe. The reader is the one
``data/native.py`` gives (the native library, built at first use) or the
plain Python reader and numpy crop (the library marked as not loaded). On
one corpus, after one run that is not counted (the K6 kernel's build and
cuDNN's first plans land there), each round runs these, for the readers in
the order native, plain, plain, native:

- 7a, the codec through ``cli.train``: stage 1 at 16 x 96000 for 3 steps,
  stage 2 (the discriminator on) at 16 x 9600 for STAGE2_STEPS steps;
  each step's wall ms (synchronised, the loader outside it), the median of
  each stage's steps after its first (cuDNN plans there), the loader's
  share of the loop, and the busy share of one profiled stage-2 step
  (``chip_smoke.device_breakdown``'s union of kernel intervals over the
  stage-2 median);
- 7b, the analyzer's statistics on that run's checkpoint: audio-seconds a
  second of ``compute_statistics``, which reads every train wav;
- 7d, the denoise fine-tune, 3 steps at 16 x 96000: its step median and the
  loader's share of the loop.

Then it times the denoise loader's reads and crops (``batch_costs``, both
batches of an epoch, 16 clean and 16 noisy wavs a batch) for ``--read-passes`` passes, the two readers in turns
within each pass, over files just written (warm in the file cache).

It prints one JSON line per run and, last, a summary: per reader and
number, the median, quartiles and range over the runs (over the batches for the
reads), and for the reads the ratio of the native median to the plain one.
With ``--out`` the whole report is written there as JSON.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ORDER = ("native", "plain", "plain", "native")
STAGE2_STEPS = 9  # phase 7a runs 3: one where cuDNN plans and two timed


@contextlib.contextmanager
def reader(name: str):
    """``data/native.py`` as it is (``native``) or with its library marked
    as not loaded, so every wrapper returns None and the callers use their
    plain versions (``plain``)."""
    from dl_speech_enhancement_tpu_torch.data import native

    saved = (native._LIB, native._TRIED)
    if name == "plain":
        native._LIB, native._TRIED = None, True
    try:
        yield
    finally:
        native._LIB, native._TRIED = saved


def spread(values) -> dict:
    values = sorted(values)
    q1, _, q3 = statistics.quantiles(values, n=4) if len(values) > 1 else values * 3
    return {"median": statistics.median(values), "q1": q1, "q3": q3, "min": values[0],
            "max": values[-1], "n": len(values)}


def batch_costs(loader, b: int) -> dict:
    """ms of batch ``b``'s reads (its dataset's items) and of its crop."""
    bs = loader.batch_size
    t0 = time.perf_counter()
    items = [loader.dataset[i] for i in range(b * bs, (b + 1) * bs)]
    t1 = time.perf_counter()
    loader.collate_fn(items)
    return {"read_ms": (t1 - t0) * 1e3, "crop_ms": (time.perf_counter() - t1) * 1e3}


def one_run(cs, root: str, run, train_seconds: float) -> dict:
    """7a, 7b and 7d once, with the reader the caller set, under
    ``root/run<run>``; ``train_seconds`` is the train subset's audio."""
    import torch

    from dl_speech_enhancement_tpu_torch.cli import statistic as stat_cli
    from dl_speech_enhancement_tpu_torch.cli import train as train_cli

    exp = os.path.join(root, f"run{run}", "exp")
    total = 3 + STAGE2_STEPS
    ae_cfg = cs.recipe_config(root, cs.CODEC_CONFIG,
                              start_steps={"generator": 0, "discriminator": 3},
                              train_max_steps=3, adv_train_max_steps=total,
                              eval_interval_steps=total, log_interval_steps=3)
    probe = cs.RecipeProbe()
    with probe:
        trainer = train_cli.main(["-c", ae_cfg, "--exp-root", exp, "--tag", "symAD"])
    torch.cuda.synchronize()
    steps = {s["step"]: s["ms"] for s in probe.steps}
    require(sorted(steps) == list(range(total)), f"7a steps {sorted(steps)}")
    _, busy_ms, _ = cs.profiled_step(
        trainer, total - 1, cs.first_batch(trainer, "autoencoder", cs.VOCODER_METRIC_LENGTH))
    stage2 = statistics.median(steps[s] for s in range(4, total))
    out = {"stage1_median_ms": statistics.median(steps[s] for s in (1, 2)),
           "stage2_median_ms": stage2,
           "stage2_step_ms": [steps[s] for s in range(4, total)],
           "stage2_busy_share": busy_ms / stage2,
           "7a_loader_wait_share": trainer.loader_wait / probe.run_s}
    del trainer
    ckpt = glob.glob(os.path.join(exp, "autoencoder", "symAD", f"checkpoint-{total}steps"))
    require(len(ckpt) == 1, f"7a: no checkpoint-{total}steps under {exp}")

    stats_path = os.path.join(root, f"run{run}", "stats.npy")
    stat_cfg = cs.recipe_config(root, cs.STATISTIC_CONFIG, analyzer=ckpt[0], stats=stats_path)
    compute, compute_s = stat_cli.compute_statistics, []

    def timed_compute(*args, **kwargs):
        t0 = time.perf_counter()
        result = compute(*args, **kwargs)  # ends in a read from the card
        compute_s.append(time.perf_counter() - t0)
        return result

    stat_cli.compute_statistics = timed_compute
    try:
        stat_cli.main(["-c", stat_cfg])
    finally:
        stat_cli.compute_statistics = compute
    out["7b_audio_seconds_per_second"] = train_seconds / compute_s[0]

    dn_cfg = cs.recipe_config(root, cs.CONFIG, initial=ckpt[0], train_max_steps=3,
                              adv_train_max_steps=3, eval_interval_steps=3,
                              log_interval_steps=3)
    probe = cs.RecipeProbe()
    with probe:
        trainer = train_cli.main(["-c", dn_cfg, "--exp-root", exp])
    torch.cuda.synchronize()
    out["7d_step_median_ms"] = statistics.median(s["ms"] for s in probe.steps[1:])
    out["7d_loader_wait_share"] = trainer.loader_wait / probe.run_s
    del trainer
    torch.cuda.empty_cache()
    return out


def require(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rounds", type=int, default=4,
                        help="rounds of native, plain, plain, native")
    parser.add_argument("--read-passes", type=int, default=30)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)

    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("reader_ab: torch.cuda.is_available() is false; this run needs the card",
              file=sys.stderr)
        return 1
    import chip_smoke as cs

    from dl_speech_enhancement_tpu_torch.cli import train as train_cli
    from dl_speech_enhancement_tpu_torch.data import native

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    require(native.available(), "the native library did not build or load")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=30).stdout.strip()
    runs = []
    with tempfile.TemporaryDirectory() as root:
        seconds = cs.write_recipe_corpus(root)
        one_run(cs, root, "warmup", seconds["train"])
        for rnd in range(args.rounds):
            for name in ORDER:
                with reader(name):
                    t0 = time.perf_counter()
                    got = one_run(cs, root, len(runs), seconds["train"])
                got.update(reader=name, round=rnd, seconds=time.perf_counter() - t0)
                runs.append(got)
                print(json.dumps(got), flush=True)

        cfg = cs.load_config(cs.recipe_config(root, cs.CONFIG))
        reads = {"native": [], "plain": []}
        for p in range(args.read_passes):
            for name in (("native", "plain") if p % 2 == 0 else ("plain", "native")):
                with reader(name):
                    loader = train_cli.build_data_loaders(cfg, "denoise",
                                                          cs.RECIPE_LENGTH)["train"]
                    for b in range(len(loader.dataset) // loader.batch_size):
                        reads[name].append(batch_costs(loader, b))

    keys = ("stage1_median_ms", "stage2_median_ms", "stage2_busy_share",
            "7a_loader_wait_share", "7b_audio_seconds_per_second", "7d_step_median_ms",
            "7d_loader_wait_share")
    summary = {name: {k: spread(r[k] for r in runs if r["reader"] == name) for k in keys}
               for name in ("native", "plain")}
    for name in reads:
        for k in ("read_ms", "crop_ms"):
            summary[name][f"batch_{k}"] = spread(c[k] for c in reads[name])
    summary["native_over_plain_batch_read"] = (summary["native"]["batch_read_ms"]["median"]
                                               / summary["plain"]["batch_read_ms"]["median"])
    summary["card"] = card
    print(json.dumps(summary), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"runs": runs, "reads": reads, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
