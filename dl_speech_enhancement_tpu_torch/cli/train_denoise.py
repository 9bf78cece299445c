"""Course denoise training CLI (the reference's train_denoise.py).

Counterpart of dl_speech_enhancement_tpu/cli/train_denoise.py, with the
same flags and config contract (train_denoise.py:39-45): ``-c`` names a
file under ``--config-dir`` (``configs/denoise``). Clean speech and noise
are the wavs one and two directories under ``--clean-path`` and
``--noise-path`` (``AudioDataset``), each split 70/15/15 by the config's
seed into loaders of 1 s crops; the course loop
(train/denoise_course.py) mixes them. LAPTOP mode takes batches of 4 and
three of them an epoch, as a smoke run (train_denoise.py:308-310). A
config's ``initial_model`` (a course checkpoint under ``--job-dir``)
warm-starts the generator. Scalars go to the log and, where
``torch.utils.tensorboard`` imports, to TensorBoard under ``--job-dir``.

    python -m dl_speech_enhancement_tpu_torch.cli.train_denoise -e HPC \\
        -c symAD_48MelWaveL1.yaml --clean-path DIR --noise-path DIR

``--dp N`` trains data-parallel over N ranks that this command spawns, as
cli/train.py's does (``--device cuda``: the first N cards over NCCL, ``-1``
every card; ``--device cuda:K``: N ranks on card K over gloo; ``--device
cpu``: N gloo ranks on the host). Rank 0 reports and writes checkpoints.
"""

from __future__ import annotations

import logging
import os
import sys
from argparse import ArgumentParser

import torch.distributed as dist

from dl_speech_enhancement_tpu_torch.data import AudioDataset, get_dataloaders
from dl_speech_enhancement_tpu_torch.models import AudioDecGenerator, HiFiGANDiscriminator
from dl_speech_enhancement_tpu_torch.parallel.mesh import data_parallel_devices, launch
from dl_speech_enhancement_tpu_torch.train.checkpoint import is_rank0, load_checkpoint
from dl_speech_enhancement_tpu_torch.train.denoise_course import train_denoise_course
from dl_speech_enhancement_tpu_torch.utils.config import load_config
from dl_speech_enhancement_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


def _report_to_tensorboard(logdir: str):
    """The course loop's scalar sink on a TensorBoard writer, or None where
    ``torch.utils.tensorboard`` does not import."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return None
    writer = SummaryWriter(logdir)

    def report(category, series, value, iteration):
        writer.add_scalar(f"{category}/{series}", value, iteration)
    return report


def _rank(device, argv):
    """One rank of ``--dp N``: the same command on its own device."""
    state, history = main([*argv, "--device", str(device)])
    return {"steps": state["steps"], "history": history}


def main(argv=None):
    """Run the course loop; returns its ``(state, history)``, or, where
    ``--dp`` launches ranks, each rank's ``{"steps", "history"}``."""
    parser = ArgumentParser()
    parser.add_argument("-e", "--environment", default="LAPTOP")
    parser.add_argument("-c", "--config", default="symAD_custom.yaml")
    parser.add_argument("--config-dir", default=os.path.join("configs", "denoise"))
    parser.add_argument("--clean-path", default=None)
    parser.add_argument("--noise-path", default=None)
    parser.add_argument("--job-dir", default="job_out")
    parser.add_argument("--dp", type=int, default=None, metavar="N",
                        help="data-parallel ranks (-1: every visible card); overrides the "
                             "config key parallel.data_devices")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (the card, the default) or 'cpu' (the plain modules)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    config = load_config(os.path.join(args.config_dir, args.config))
    if args.dp is not None:
        config["parallel"] = dict(config.get("parallel") or {}, data_devices=args.dp)
    if not dist.is_initialized():
        devices = data_parallel_devices(config, args.device)
        if devices is not None:
            argv = list(sys.argv[1:] if argv is None else argv)
            return launch(_rank, devices, argv)
    env = args.environment
    if env == "LAPTOP":
        clean_path = args.clean_path or "corpus/train/clean"
        clean_root = "clean"
        noise_path = args.noise_path or "corpus/train/noise"
        noise_root = "noise"
        task_name = "Laptop-TEST-dropout"
    elif env == "HPC":
        clean_path = args.clean_path or os.environ.get("DLSE_CLEAN_PATH", "corpus/train/clean")
        clean_root = os.path.basename(clean_path.rstrip("/"))
        noise_path = args.noise_path or os.environ.get("DLSE_NOISE_PATH", "corpus/train/noise")
        noise_root = os.path.basename(noise_path.rstrip("/"))
        task_name = config["experiment_name"]
    else:
        raise ValueError("Illegal argument: " + env)

    sample_rate = config["sample_rate"]
    seed = config["seed"]
    gen = AudioDecGenerator(**config["generator_params"], use_pqc=False, seed=seed,
                            device=device)
    disc = HiFiGANDiscriminator(**config["discriminator_params"], seed=seed + 1, device=device)

    clean_dataset = AudioDataset(clean_path, clean_root, sample_rate)
    noise_dataset = AudioDataset(noise_path, noise_root, sample_rate)
    logger.info("clean files: %d, noise files: %d", len(clean_dataset), len(noise_dataset))
    batch_length = sample_rate
    batch_size = 4 if env == "LAPTOP" else int(config["batch_size"])
    split = [0.7, 0.15, 0.15]
    train_c, val_c, _ = get_dataloaders(clean_dataset, split, batch_size, batch_length, seed)
    train_n, val_n, _ = get_dataloaders(noise_dataset, split, batch_size, batch_length, seed)

    initial_params = None
    if config.get("initial_model"):
        ckpt = os.path.join(args.job_dir, config["initial_model"])
        try:
            initial_params = load_checkpoint(
                ckpt, like={"params_generator": gen.state_dict()})["params_generator"]
            logger.info("warm-started from %s", ckpt)
        except Exception as e:  # noqa: BLE001 - reported, then the reference's message
            # the reference's message (train_denoise.py:116), after the reason:
            # a silent random start on a long run is the worst way to fail
            logger.warning("warm-start from %s failed: %r", ckpt, e)
            print("No inital model")

    print("Start training")
    report = _report_to_tensorboard(os.path.join(args.job_dir, task_name)) if is_rank0() else None
    return train_denoise_course(config, gen, disc, (train_c, train_n), (val_c, val_n),
                                environment=env, job_dir=args.job_dir, task_name=task_name,
                                report=report, initial_params=initial_params)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s (%(module)s) %(message)s")
    main()
