"""Import a reference (PyTorch) checkpoint pickle as a port checkpoint.

Counterpart of dl_speech_enhancement_tpu/cli/import_checkpoint.py::

    python -m dl_speech_enhancement_tpu_torch.cli.import_checkpoint \\
        --checkpoint exp/.../checkpoint-200000steps.pkl \\
        --config configs/autoencoder/symAD_vctk_48000_hop300.yaml \\
        --out exp/imported/checkpoint-200000steps [--without-pqc] [--device cpu]

Both reference pickle formats are read (utils/torch_import.py): the
framework format's generator, discriminator, VQ EMA state and step / epoch
counters (the Adam moments are not carried across: resume with fresh
optimizers, the reference's ``load_only_params``), and the course format's
bare generator state dict. The output is train/checkpoint.py's layout,
``<out>/state.pt`` with the config beside it as ``config.yml``, which
``cli.stream --checkpoint``, ``utils/audiodec.py``, ``cli.test``,
``cli.testing_denoise`` and the training CLIs' ``--resume`` load. A HiFiGAN
vocoder's input-norm statistics are saved with its weights (as the ``mean``
/ ``scale`` buffers of a generator built with them) and to
``stats_imported.npy`` beside the checkpoint directory: point
``generator_params.stats`` at it.
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np
import torch

from dl_speech_enhancement_tpu_torch.train.checkpoint import save_checkpoint
from dl_speech_enhancement_tpu_torch.utils.config import load_config
from dl_speech_enhancement_tpu_torch.utils.device import resolve_device
from dl_speech_enhancement_tpu_torch.utils.model_factory import (
    build_discriminator,
    build_generator,
)
from dl_speech_enhancement_tpu_torch.utils.torch_import import (
    import_audiodec_generator,
    import_hifigan_discriminator,
    import_hifigan_generator,
    import_univnet_discriminator,
    load_torch_pickle,
    split_checkpoint,
)

logger = logging.getLogger(__name__)

CODECS = ("symAudioDec", "symAudioDecUniv")
VOCODERS = ("HiFiGAN", "UnivNet")


def main(argv=None) -> dict:
    """Import and save; returns the saved state (the modules' state dicts)."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--checkpoint", required=True,
                        help="reference .pkl (framework or course format)")
    parser.add_argument("--config", required=True,
                        help="experiment YAML describing the model topology")
    parser.add_argument("--out", required=True, help="output checkpoint directory")
    parser.add_argument("--without-pqc", action="store_true",
                        help="the course's without-PQC generator (the pickle's unused "
                             "projector, quantizer and decoder input conv are skipped)")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (the card, the default) or 'cpu'")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    config = load_config(args.config)
    # course configs carry no model_type: the course trains the symAD generator
    model_type = config.get("model_type", "symAudioDec")
    parts = split_checkpoint(load_torch_pickle(args.checkpoint))
    logger.info("checkpoint format: %s (%d generator tensors)", parts["format"],
                len(parts["generator"]))

    state = {}
    if model_type in CODECS:
        gen = build_generator(model_type, config["generator_params"],
                              use_pqc=not args.without_pqc, device=device)
        gen, vq_state = import_audiodec_generator(parts["generator"], gen)
        state["params_generator"] = gen.state_dict()
        if vq_state is not None:
            state["vq_state"] = vq_state
    elif model_type in VOCODERS:
        gen = build_generator(model_type, dict(config["generator_params"], stats=None),
                              device=device)
        gen, stats = import_hifigan_generator(parts["generator"], gen)
        state["params_generator"] = gen.state_dict()
        if stats is not None:
            # as a generator built with statistics holds them: its first entries
            state["params_generator"] = {"mean": torch.from_numpy(stats[0].copy()),
                                         "scale": torch.from_numpy(stats[1].copy()),
                                         **state["params_generator"]}
            stats_path = os.path.join(os.path.dirname(os.path.abspath(args.out)),
                                      "stats_imported.npy")
            os.makedirs(os.path.dirname(stats_path), exist_ok=True)
            np.save(stats_path, stats)
            logger.info("input-norm stats -> %s (set generator_params.stats)", stats_path)
    else:
        raise NotImplementedError(f"Model type: {model_type} is not supported!")

    if parts["discriminator"] is not None:
        disc = build_discriminator(model_type, config["discriminator_params"], device=device)
        load = (import_hifigan_discriminator if model_type in ("symAudioDec", "HiFiGAN")
                else import_univnet_discriminator)
        state["params_discriminator"] = load(parts["discriminator"], disc).state_dict()
    if parts["format"] == "framework":
        state["steps"], state["epochs"] = parts["steps"], parts["epochs"]

    save_checkpoint(args.out, state, config=config)
    n_params = sum(p.numel() for p in gen.parameters())
    logger.info("imported %s -> %s (keys: %s; generator params: %.2fM)", args.checkpoint,
                args.out, sorted(state), n_params / 1e6)
    return state


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    main()
