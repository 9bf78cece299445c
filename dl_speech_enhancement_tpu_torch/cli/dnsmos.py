"""DNSMOS scoring CLI (the reference's DNSMOS/dnsmos_local.py).

Counterpart of dl_speech_enhancement_tpu/cli/dnsmos.py, without pandas:

    python -m dl_speech_enhancement_tpu_torch.cli.dnsmos -t test_out -o scores.csv \\
        --model-dir DNSMOS [-p] [--device cpu]

Walks ``testset_dir`` (its wavs, then one subdirectory per model, as
cli/testing_denoise.py writes them), scores every clip (a clip that fails is
reported and skipped, as the reference's thread pool does), writes the rows
as CSV (the layout of pandas' ``to_csv``: an index column first) and prints
the per-model means of SIG, BAK, OVRL and P808_MOS. ``main`` returns the
rows, a list of dicts where the JAX package returns a ``DataFrame``. The
graphs are not in the repository: ``--model-dir`` is a directory laid out as
the reference's ``DNSMOS/``, or ``--primary-model`` / ``--p808-model`` name
the two files.
"""

from __future__ import annotations

import csv
import glob
import os
from argparse import ArgumentParser

import numpy as np

from dl_speech_enhancement_tpu_torch.eval.dnsmos import (
    DEFAULT_MODEL_DIR,
    ComputeScore,
    default_model_paths,
)

MEAN_KEYS = ("SIG", "BAK", "OVRL", "P808_MOS")


def find_clips(testset_dir: str) -> list:
    """The wavs of ``testset_dir``, then those under each subdirectory."""
    clips = sorted(glob.glob(os.path.join(testset_dir, "*.wav")))
    for sub in sorted(glob.glob(os.path.join(testset_dir, "*"))):
        if os.path.isdir(sub):
            clips.extend(sorted(glob.glob(os.path.join(sub, "**", "*.wav"), recursive=True)))
    return clips


def write_csv(path: str, rows: list) -> None:
    columns = list(dict.fromkeys(k for row in rows for k in row))
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["", *columns])
        for i, row in enumerate(rows):
            writer.writerow([i, *(row.get(k, "") for k in columns)])


def model_means(rows: list) -> dict:
    """{model: {key: mean over its clips}} for the MEAN_KEYS."""
    by_model: dict = {}
    for row in rows:
        by_model.setdefault(row["model"], []).append(row)
    return {model: {k: float(np.mean([r[k] for r in group])) for k in MEAN_KEYS}
            for model, group in sorted(by_model.items())}


def main(argv=None) -> list:
    parser = ArgumentParser()
    parser.add_argument("-t", "--testset_dir", default=".")
    parser.add_argument("-o", "--csv_path", default=None)
    parser.add_argument("-p", "--personalized_MOS", action="store_true")
    parser.add_argument("--model-dir", default=DEFAULT_MODEL_DIR,
                        help="directory laid out as the reference's DNSMOS/")
    parser.add_argument("--primary-model", default=None,
                        help="sig_bak_ovr.onnx (default: under --model-dir)")
    parser.add_argument("--p808-model", default=None,
                        help="model_v8.onnx (default: under --model-dir)")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (the card, the default) or 'cpu'")
    args = parser.parse_args(argv)

    primary, p808 = default_model_paths(args.personalized_MOS, args.model_dir)
    compute_score = ComputeScore(args.primary_model or primary, args.p808_model or p808,
                                 personalized=args.personalized_MOS, device=args.device)
    rows = []
    for clip in find_clips(args.testset_dir):
        try:
            row = compute_score(clip, 16000, args.personalized_MOS)
            row["model"] = os.path.relpath(os.path.dirname(clip), args.testset_dir)
            rows.append(row)
        except Exception as exc:  # noqa: BLE001 - the reference's per-clip tolerance
            print(f"{clip!r} generated an exception: {exc}")

    if args.csv_path:
        write_csv(args.csv_path, rows)
    for model, means in model_means(rows).items():
        n = sum(row["model"] == model for row in rows)
        print(f"== {model} (n={n})")
        for k, v in means.items():
            print(f"{k:<9} {v:.3f}")
    if not rows:
        print("no clip scored")
    return rows


if __name__ == "__main__":
    main()
