"""Device resolution for the port's entry points."""

from __future__ import annotations

import copy

import torch


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, raising when CUDA is asked for and absent.

    The port never falls back to the CPU on its own: a caller that wants the
    plain PyTorch path passes ``device="cpu"``."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is false; "
                "pass device='cpu' to run the plain PyTorch path")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def replica(model, device):
    """``model`` where it already lies on ``device`` (a resolved device),
    else a copy of it moved there: a fleet's slice or an endpoint on another
    device gets its own weights, as the JAX package replicates parameters."""
    if model is None or model.device == device:
        return model
    return copy.deepcopy(model).to(device)

