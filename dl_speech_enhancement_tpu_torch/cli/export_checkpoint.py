"""Export a port checkpoint as a reference (PyTorch) pickle.

Counterpart of dl_speech_enhancement_tpu/cli/export_checkpoint.py, the
inverse of cli/import_checkpoint.py::

    python -m dl_speech_enhancement_tpu_torch.cli.export_checkpoint \\
        --checkpoint exp/denoise/<tag>/checkpoint-200000steps \\
        --out exp/exported/checkpoint-200000steps.pkl [--format framework] \\
        [--without-pqc] [--device cpu]

``--format course`` writes a bare generator state dict
(train_denoise.py:350-355); ``--format framework`` the trainer dict
(trainer/trainerGAN.py:95-121) with the generator and discriminator state
dicts and the step / epoch counts, its optimizer and scheduler entries empty
(resume on the reference side with ``load_only_params``); ``auto`` (the
default) picks framework where the checkpoint holds a discriminator. The
topology comes from the ``config.yml`` beside the checkpoint, or
``--config``. A without-PQC generator gets the seeded placeholder projector
and quantizer entries its reference module constructs (utils/
torch_export.py).
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np
import torch

from dl_speech_enhancement_tpu_torch.nn.vq import VQState
from dl_speech_enhancement_tpu_torch.train.checkpoint import load_checkpoint
from dl_speech_enhancement_tpu_torch.utils.config import load_config, load_config_beside
from dl_speech_enhancement_tpu_torch.utils.device import resolve_device
from dl_speech_enhancement_tpu_torch.utils.model_factory import (
    build_discriminator,
    build_generator,
)
from dl_speech_enhancement_tpu_torch.utils.torch_export import (
    export_audiodec_generator,
    export_hifigan_discriminator,
    export_hifigan_generator,
    export_univnet_discriminator,
)

logger = logging.getLogger(__name__)


def _tensors(sd: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def main(argv=None) -> dict:
    """Export; returns what was saved."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--checkpoint", required=True, help="port checkpoint directory")
    parser.add_argument("--config", default=None,
                        help="experiment YAML (default: config.yml beside the checkpoint)")
    parser.add_argument("--out", required=True, help="output .pkl path (torch.save)")
    parser.add_argument("--format", choices=("auto", "course", "framework"), default="auto",
                        help="'course': bare generator state dict; 'framework': trainer "
                             "dict with the discriminator; 'auto': framework iff the "
                             "checkpoint has a discriminator")
    parser.add_argument("--without-pqc", action="store_true",
                        help="the checkpoint is a without-PQC (denoiser) generator")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (the card, the default) or 'cpu'")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    config = (load_config(args.config) if args.config
              else load_config_beside(args.checkpoint))
    model_type = config.get("model_type", "symAudioDec")
    state = load_checkpoint(args.checkpoint)
    if "params_generator" not in state:
        raise SystemExit(f"checkpoint {args.checkpoint} has no params_generator "
                         f"(keys: {sorted(state)})")

    use_pqc = not args.without_pqc
    if model_type in ("symAudioDec", "symAudioDecUniv"):
        gen = build_generator(model_type, config["generator_params"], use_pqc=use_pqc,
                              device=device)
        gen.load_state_dict(state["params_generator"])
        vq = state.get("vq_state")
        if use_pqc and vq is None:
            raise SystemExit("PQC checkpoint without vq_state: pass --without-pqc for "
                             "denoiser checkpoints")
        vq = None if vq is None else VQState(**vq)
        gen_sd = export_audiodec_generator(gen, vq if use_pqc else None,
                                           config["generator_params"])
    elif model_type in ("HiFiGAN", "UnivNet"):
        gen = build_generator(model_type, config["generator_params"], device=device)
        gen.load_state_dict(state["params_generator"])
        gen_sd = export_hifigan_generator(gen)
    else:
        raise NotImplementedError(f"Model type: {model_type} is not supported!")

    fmt = args.format
    if fmt == "auto":
        fmt = "framework" if "params_discriminator" in state else "course"
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    if fmt == "course":
        out = _tensors(gen_sd)
        torch.save(out, args.out)
        logger.info("exported course-format generator state dict (%d tensors) -> %s",
                    len(gen_sd), args.out)
        return out

    out = {"model": {"generator": _tensors(gen_sd)}, "optimizer": {}, "scheduler": {},
           "steps": int(state.get("steps", 0)), "epochs": int(state.get("epochs", 0))}
    if "params_discriminator" in state:
        disc = build_discriminator(model_type, config["discriminator_params"], device=device)
        disc.load_state_dict(state["params_discriminator"])
        export_disc = (export_univnet_discriminator
                       if model_type in ("symAudioDecUniv", "UnivNet")
                       else export_hifigan_discriminator)
        out["model"]["discriminator"] = _tensors(export_disc(disc))
    torch.save(out, args.out)
    logger.info("exported framework-format checkpoint (%s) -> %s (reference side: load "
                "with load_only_params; the optimizer state is not translated)",
                sorted(out["model"]), args.out)
    return out


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    main()
