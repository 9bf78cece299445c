"""Analyzer code-statistics CLI (the reference's codecStatistic).

Counterpart of dl_speech_enhancement_tpu/cli/statistic.py: the analyzer
named by the config's ``analyzer`` (a port checkpoint with its
``config.yml`` beside it) runs over a clean subset, and the ``(2,
code_dim)`` [mean; scale] goes to the config's ``stats`` path, which a
vocoder config's ``generator_params.stats`` then names.

    python -m dl_speech_enhancement_tpu_torch.cli.statistic \\
        -c configs/statistic/symAD_vctk_48000_hop300_clean.yaml [--device cpu]
"""

from __future__ import annotations

import logging
import os
from argparse import ArgumentParser

import numpy as np

from dl_speech_enhancement_tpu_torch.data import SingleDataset
from dl_speech_enhancement_tpu_torch.train.workloads.statistic import (
    compute_statistics,
    save_statistics,
)
from dl_speech_enhancement_tpu_torch.utils.audiodec import load_generator_from_checkpoint
from dl_speech_enhancement_tpu_torch.utils.config import load_config
from dl_speech_enhancement_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


def main(argv=None) -> np.ndarray:
    """Compute and save the statistics; returns them."""
    parser = ArgumentParser()
    parser.add_argument("-c", "--config", required=True)
    parser.add_argument("--subset", default="train")
    parser.add_argument("--subset-num", type=int, default=-1)
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (the card, the default) or 'cpu' (the plain modules)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    config = load_config(args.config)
    analyzer, vq_state, _ = load_generator_from_checkpoint(config["analyzer"], device=device)
    dataset = SingleDataset(
        os.path.join(config["data"]["path"], config["data"]["subset"][args.subset]),
        sample_rate=config["sampling_rate"], subset_num=args.subset_num)
    stats = compute_statistics(analyzer, vq_state, dataset)
    save_statistics(config["stats"], stats)
    logger.info("saved stats %s -> %s", stats.shape, config["stats"])
    return stats


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s (%(module)s) %(message)s")
    main()
