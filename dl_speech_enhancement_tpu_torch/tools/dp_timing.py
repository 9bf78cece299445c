"""Times the course's data-parallel training step on the cards.

The ``train_disc`` step of configs/denoise/symAD_48MelWaveL1.yaml (the
without-PQC denoiser, then its MSD + MPD discriminator) at the config's batch
of 16 x 48000 samples, seeded weights and seeded harmonic audio, TF32 off:
first in this process on one card, then data-parallel over N ranks
(parallel/mesh.py::launch, one card a rank over NCCL, 16 / N rows each).
For each it reports the step's wall time (the median of ``--steps`` steps
after one warm-up step, each between two synchronizations), the gradient
reduction alone (the generator's and the discriminator's gradients averaged
over the ranks, the median of 5 between synchronizations) and its share of
the step, and each rank's peak memory. Run on a machine with N cards:

    python -m dl_speech_enhancement_tpu_torch.tools.dp_timing --cards 4 \\
        --out chiprun_out/dp_timing.json
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import time

import numpy as np
import torch
import torch.distributed as dist

from dl_speech_enhancement_tpu_torch.data.mixing import add_noise
from dl_speech_enhancement_tpu_torch.models import AudioDecGenerator
from dl_speech_enhancement_tpu_torch.parallel.mesh import launch, make_mesh, mesh_from_config
from dl_speech_enhancement_tpu_torch.parallel.mesh import shard_batch
from dl_speech_enhancement_tpu_torch.train.denoise_course import make_course_steps
from dl_speech_enhancement_tpu_torch.train.optim import build_optimizer
from dl_speech_enhancement_tpu_torch.utils.collectives import average_gradients
from dl_speech_enhancement_tpu_torch.utils.config import load_config
from dl_speech_enhancement_tpu_torch.utils.model_factory import build_discriminator

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "configs", "denoise", "symAD_48MelWaveL1.yaml")


def batch(cfg, seed: int = 0):
    """(mixed, clean) numpy (B, T, 1): four harmonics of a gliding pitch
    over a -60 dB noise floor, mixed with white noise at 15 dB."""
    rng = np.random.default_rng(seed)
    b, n, sr = cfg["batch_size"], cfg["batch_length"], cfg["sample_rate"]
    t = np.arange(n) / sr
    f0 = rng.uniform(100.0, 250.0, (b, 1)) * (1.0 + 0.1 * np.sin(np.pi * t))
    phase = 2.0 * np.pi * np.cumsum(f0, axis=1) / sr
    clean = sum(0.3 / h * np.sin(h * phase) for h in (1, 2, 3, 4))
    clean = (clean + 3e-4 * rng.standard_normal(clean.shape))[..., None].astype(np.float32)
    noise = (0.3 * rng.standard_normal(clean.shape)).astype(np.float32)
    return add_noise(clean, noise, 15).astype(np.float32), clean


def measure(device, cfg, mixed, clean, steps: int) -> dict:
    """The step on ``device``, data-parallel where a process group exists."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = mesh_from_config(cfg)
    group = None if mesh is None else mesh.get_group("data")
    gen = AudioDecGenerator(**cfg["generator_params"], use_pqc=False, seed=50, device=device)
    disc = build_discriminator("symAudioDec", cfg["discriminator_params"], device=device,
                               seed=70)
    opt_g = build_optimizer(gen.parameters(), "Adam", cfg["generator_optimizer_params"])
    opt_d = build_optimizer(disc.parameters(), "Adam", cfg["discriminator_optimizer_params"])
    step = make_course_steps(gen, disc, cfg, opt_g, opt_d, group)["train_disc"]
    x, t = (torch.from_numpy(a).to(device) for a in shard_batch(mesh, (mixed, clean)))
    walls = []
    torch.cuda.reset_peak_memory_stats(device)
    for i in range(steps + 1):
        torch.cuda.synchronize(device)
        if group is not None:
            dist.barrier()
        t0 = time.perf_counter()
        step(x, t)
        torch.cuda.synchronize(device)
        if i:
            walls.append((time.perf_counter() - t0) * 1e3)
    out = {"device": str(device), "rows": int(x.shape[0]),
           "step_ms": statistics.median(walls), "step_ms_all": walls,
           "peak_bytes": torch.cuda.max_memory_allocated(device),
           "grad_bytes": 4 * sum(p.numel() for p in (*gen.parameters(), *disc.parameters()))}
    if group is not None:
        params = [*gen.parameters(), *disc.parameters()]
        reduce = []
        for _ in range(5):
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            average_gradients(params, group)
            torch.cuda.synchronize(device)
            reduce.append((time.perf_counter() - t0) * 1e3)
        out["reduce_ms"] = statistics.median(reduce)
        out["reduce_share"] = out["reduce_ms"] / out["step_ms"]
    return out


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--cards", type=int, default=None, help="ranks (default: every card)")
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    cards = make_mesh(args.cards)
    cfg = load_config(CONFIG)
    mixed, clean = batch(cfg)
    report = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines(),
              "batch": list(mixed.shape), "one_card": measure(cards[0], cfg, mixed, clean,
                                                              args.steps)}
    torch.cuda.empty_cache()
    ranks = launch(measure, cards, dict(cfg, parallel={"data_devices": len(cards)}), mixed,
                   clean, args.steps)
    report[f"{len(cards)}_cards"] = ranks
    report["speedup"] = report["one_card"]["step_ms"] / max(r["step_ms"] for r in ranks)
    text = json.dumps(report, indent=1)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return report


if __name__ == "__main__":
    main()
