"""AudioDec-framework training CLI (the reference's codecTrain).

Counterpart of dl_speech_enhancement_tpu/cli/train.py, over the stage
template of the reference's bin/train.py:26-124: seeding, the config with
the command line's overrides saved to ``{exp_root}/{train_mode}/{tag}/
config.yml``, the workload by ``train_mode`` (autoencoder / vocoder /
denoise), resuming from a checkpoint, and the two phases: the metric phase
to ``train_max_steps``, then, where the config has ``adv_batch_length``,
the adversarial phase on loaders rebuilt at that length to
``adv_train_max_steps`` (bin/train.py:106-123). The last checkpoint is
written however the run ends.

The AudioDec recipe, from a directory holding the corpus the configs name:

    python -m dl_speech_enhancement_tpu_torch.cli.train \\
        -c configs/autoencoder/symAD_vctk_48000_hop300.yaml
    python -m dl_speech_enhancement_tpu_torch.cli.statistic \\
        -c configs/statistic/symAD_vctk_48000_hop300_clean.yaml
    python -m dl_speech_enhancement_tpu_torch.cli.train \\
        -c configs/vocoder/AudioDec_v1_symAD_vctk_48000_hop300_clean.yaml

``--device cpu`` runs the plain PyTorch path; the default is the card.
Checkpoints are the port's own (train/checkpoint.py). ``--dp N`` trains
data-parallel over N ranks that this command spawns (parallel/mesh.py::
launch), as the JAX CLI's ``--dp N`` shards over N devices: with ``--device
cuda`` over the first N cards (NCCL; ``--dp -1`` takes every card), with
``--device cuda:K`` N ranks on card K (gloo), with ``--device cpu`` N gloo
ranks on the host. Rank 0 writes the checkpoints, which have the
one-process layout and resume on any number of ranks.
"""

from __future__ import annotations

import logging
import os
import random
import sys
from argparse import ArgumentParser

import numpy as np
import torch
import torch.distributed as dist

from dl_speech_enhancement_tpu_torch.data import (
    CollaterAudio,
    CollaterAudioPair,
    DataLoader,
    MultiDataset,
    SingleDataset,
)
from dl_speech_enhancement_tpu_torch.parallel.mesh import data_parallel_devices, launch
from dl_speech_enhancement_tpu_torch.train.checkpoint import (
    is_rank0,
    latest_checkpoint,
    load_checkpoint,
)
from dl_speech_enhancement_tpu_torch.utils.audiodec import load_generator_from_checkpoint
from dl_speech_enhancement_tpu_torch.utils.config import load_config, save_config
from dl_speech_enhancement_tpu_torch.utils.device import resolve_device
from dl_speech_enhancement_tpu_torch.utils.model_factory import (
    build_discriminator,
    build_generator,
)

logger = logging.getLogger(__name__)


def build_data_loaders(config: dict, mode: str, batch_length: int) -> dict:
    """``{"train", "dev"}`` loaders of a workload: clean clips for the
    autoencoder and the vocoder, (noisy, clean) pairs for denoise."""
    sr = config["sampling_rate"]
    path = config["data"]["path"]
    subset = config["data"]["subset"]
    seed = config.get("seed", 1337)

    def single(sub):
        return SingleDataset(os.path.join(path, sub), sample_rate=sr)

    def pair(noisy_sub, clean_sub):
        # CollaterAudioPair crops (clean, noisy) items into (noisy, clean)
        # batches, the denoise trainer's (input, target)
        return MultiDataset([os.path.join(path, clean_sub), os.path.join(path, noisy_sub)],
                            sample_rate=sr)

    if mode in ("autoencoder", "vocoder"):
        train_key = "clean_train" if "clean_train" in subset else "train"
        valid_key = "clean_valid" if "clean_valid" in subset else "valid"
        train, valid = single(subset[train_key]), single(subset[valid_key])
        coll = CollaterAudio(batch_length, rng=np.random.default_rng(seed))
    elif mode == "denoise":
        train = pair(subset["noisy_train"], subset["clean_train"])
        valid = pair(subset["noisy_valid"], subset["clean_valid"])
        pair_coll = CollaterAudioPair(batch_length, rng=np.random.default_rng(seed))

        def coll(items):
            return pair_coll([tuple(i) for i in items])
    else:
        raise NotImplementedError(f"train_mode: {mode}")
    bs = config["batch_size"]
    return {"train": DataLoader(train, bs, coll, seed=seed),
            "dev": DataLoader(valid, bs, coll, seed=seed + 1)}


def build_trainer(config: dict, data_loader, device="cuda"):
    """The workload trainer of ``config["train_mode"]``, its networks seeded
    from the config's seed on ``device``."""
    mode = config["train_mode"]
    model_type = config["model_type"]
    seed = config.get("seed", 1337)

    def generator():
        return build_generator(model_type, config["generator_params"], device=device, seed=seed)

    def discriminator():
        return build_discriminator(model_type, config["discriminator_params"], device=device,
                                   seed=seed + 1)

    if mode == "autoencoder":
        from dl_speech_enhancement_tpu_torch.train.workloads.autoencoder import Trainer
        return Trainer(0, 0, data_loader, generator(), discriminator(), config)
    if mode == "vocoder":
        from dl_speech_enhancement_tpu_torch.train.workloads.vocoder import Trainer
        analyzer, vq_state, _ = load_generator_from_checkpoint(config["analyzer"], device=device)
        return Trainer(0, 0, data_loader, analyzer, vq_state, generator(), discriminator(),
                       config)
    if mode == "denoise":
        from dl_speech_enhancement_tpu_torch.train.workloads.denoise import Trainer
        gen, vq_state = generator(), None
        if config.get("initial"):
            restored = load_checkpoint(config["initial"], like={
                "params_generator": gen.state_dict(),
                "vq_state": gen.quantizer.init(device=gen.device)})
            gen.load_state_dict(restored["params_generator"])
            vq_state = restored["vq_state"]
            logger.info("initialized from %s", config["initial"])
        return Trainer(0, 0, data_loader, gen, config, vq_state=vq_state)
    raise NotImplementedError(f"train_mode: {mode}")


def _rank(device, argv):
    """One rank of ``--dp N``: the same command on its own device."""
    trainer = main([*argv, "--device", str(device)])
    return {"steps": trainer.steps, "loader_wait": trainer.loader_wait}


def main(argv=None):
    """Train as the config says; returns the trainer, or, where ``--dp``
    launches ranks, each rank's ``{"steps", "loader_wait"}``."""
    parser = ArgumentParser()
    parser.add_argument("-c", "--config", required=True)
    parser.add_argument("--tag", default=None)
    parser.add_argument("--exp-root", default="exp")
    parser.add_argument("--resume", default="", nargs="?", const="auto",
                        help="checkpoint to resume from; a bare --resume resumes from the "
                             "newest checkpoint in the expdir")
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--dp", type=int, default=None, metavar="N",
                        help="data-parallel ranks (-1: every visible card); overrides the "
                             "config key parallel.data_devices")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (the card, the default) or 'cpu' (the plain modules)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    config = load_config(args.config)
    if args.dp is not None:
        # a bare `parallel:` YAML section loads as None
        config["parallel"] = dict(config.get("parallel") or {}, data_devices=args.dp)
    if not dist.is_initialized():
        devices = data_parallel_devices(config, args.device)
        if devices is not None:
            argv = list(sys.argv[1:] if argv is None else argv)
            return launch(_rank, devices, argv)
    if args.seed is not None:
        config["seed"] = args.seed
    seed = config.get("seed", 1337)
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)

    mode = config["train_mode"]
    tag = args.tag or os.path.splitext(os.path.basename(args.config))[0]
    outdir = os.path.join(args.exp_root, mode, tag)
    config["outdir"] = outdir
    os.makedirs(outdir, exist_ok=True)
    if is_rank0():
        save_config(os.path.join(outdir, "config.yml"), config)
    logger.info("expdir: %s", outdir)

    trainer = build_trainer(config, build_data_loaders(config, mode, config["batch_length"]),
                            device)
    resume = args.resume
    if resume == "auto":
        # a fresh start here would overwrite the run the user meant to resume
        resume = latest_checkpoint(outdir)
        if resume is None:
            raise SystemExit(f"--resume given but no checkpoint found under {outdir}")
    if resume:
        trainer.load_checkpoint(resume)
        logger.info("resumed from %s (steps=%d)", resume, trainer.steps)

    try:
        trainer.run()
        adv_max = config.get("adv_train_max_steps", 0)
        if adv_max and trainer.steps < adv_max and "adv_batch_length" in config:
            logger.info("entering adversarial phase 2 (batch_length=%d)",
                        config["adv_batch_length"])
            trainer.data_loader = build_data_loaders(config, mode, config["adv_batch_length"])
            trainer.train_max_steps = adv_max
            trainer.run()
    finally:
        trainer.save_checkpoint(os.path.join(outdir, f"checkpoint-{trainer.steps}steps"))
        if trainer.rank0:
            logger.info("Successfully saved checkpoint @ %d steps.", trainer.steps)
    return trainer


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s (%(module)s) %(message)s")
    main()
