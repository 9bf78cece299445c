"""Checkpoints of the port: a training state saved as a torch file.

Counterpart of dl_speech_enhancement_tpu/train/checkpoint.py. A checkpoint
is a directory ``.../checkpoint-<N>steps/`` holding ``state.pt``, the saved
state (a nested dict of tensors: generator and discriminator state dicts, a
``VQState``, step counts) written by ``torch.save``, with the run's
``config.yml`` beside the directory (bin/train.py:62-64 contract). The JAX
package writes the same layout through orbax, which needs JAX, so the two
formats differ on purpose: a JAX checkpoint is carried into the port with
``utils/jax_params.py``, not read here.

Under data parallelism (parallel/mesh.py) every rank holds the same state:
rank 0 alone writes it, in the one-process layout (the modules' own state
dicts, no wrapper prefix), and every rank reads it, on any number of ranks.
"""

from __future__ import annotations

import os
import re

import numpy as np
import torch
import torch.distributed as dist

from dl_speech_enhancement_tpu_torch.utils.config import save_config

STATE_FILE = "state.pt"


def _saveable(tree):
    """``tree`` as plain dicts, lists and CPU tensors (a named tuple such as
    ``VQState`` becomes a dict of its fields), so ``torch.load`` reads it
    back with ``weights_only=True``."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree.copy())
    if hasattr(tree, "_fields"):
        return {f: _saveable(getattr(tree, f)) for f in tree._fields}
    if isinstance(tree, dict):
        return {k: _saveable(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_saveable(v) for v in tree]
    return tree


def is_rank0() -> bool:
    """True outside a process group and on its rank 0."""
    return not dist.is_initialized() or dist.get_rank() == 0


def save_checkpoint(path: str, state: dict, config: dict | None = None):
    """Save ``state`` to the directory ``path`` (``config`` beside it). In a
    process group every rank calls it: rank 0 writes, and the others wait
    until it has."""
    if is_rank0():
        path = os.path.abspath(path)
        os.makedirs(path, exist_ok=True)
        torch.save(_saveable(state), os.path.join(path, STATE_FILE))
        if config is not None:
            save_config(os.path.join(os.path.dirname(path), "config.yml"), config)
    if dist.is_initialized():
        dist.barrier()


def restore(like, stored, where: str = "state"):
    """``stored`` (a loaded state) cut to the structure of ``like``: each
    tensor checked against its shape and moved to its dtype and device, a
    ``VQState`` rebuilt as one."""
    if isinstance(like, torch.Tensor):
        if not isinstance(stored, torch.Tensor) or stored.shape != like.shape:
            got = tuple(stored.shape) if isinstance(stored, torch.Tensor) else type(stored)
            raise ValueError(f"checkpoint entry {where}: {got} does not fit "
                             f"{tuple(like.shape)}")
        return stored.to(device=like.device, dtype=like.dtype)
    if hasattr(like, "_fields") or isinstance(like, dict):
        keys = like._fields if hasattr(like, "_fields") else list(like)
        if not isinstance(stored, dict) or not set(keys) <= set(stored):
            raise ValueError(f"checkpoint entry {where}: stored keys do not hold {keys}")
        parts = {k: restore(like[k] if isinstance(like, dict) else getattr(like, k),
                             stored[k], f"{where}.{k}") for k in keys}
        return type(like)(**parts) if hasattr(like, "_fields") else parts
    if isinstance(like, (list, tuple)):
        if not isinstance(stored, list) or len(stored) != len(like):
            raise ValueError(f"checkpoint entry {where}: not a list of {len(like)}")
        return type(like)(restore(a, b, f"{where}[{i}]")
                          for i, (a, b) in enumerate(zip(like, stored)))
    return stored


def load_checkpoint(path: str, like: dict | None = None) -> dict:
    """Load the state saved at ``path``. ``like`` (a subtree of the stored
    structure, e.g. ``{"params_generator": gen.state_dict()}``) restores
    only its keys, each tensor checked against its shape and moved to its
    dtype and device, a ``VQState`` as a ``VQState`` (the reference's
    ``load_only_params``); without it the whole state returns, on the CPU."""
    stored = torch.load(os.path.join(os.path.abspath(path), STATE_FILE), map_location="cpu",
                        weights_only=True)
    if like is None:
        return stored
    return restore(like, stored, "state")


def latest_checkpoint(outdir: str, pattern: str = r"checkpoint-(\d+)steps") -> str | None:
    """Find the newest ``checkpoint-<N>steps`` directory under ``outdir``."""
    if not os.path.isdir(outdir):
        return None
    best, best_steps = None, -1
    for name in os.listdir(outdir):
        m = re.fullmatch(pattern, name)
        if m and int(m.group(1)) > best_steps:
            best, best_steps = os.path.join(outdir, name), int(m.group(1))
    return best
