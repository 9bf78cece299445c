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


def refuse_data_parallel(config: dict, device: torch.device) -> None:
    """Raise NotImplementedError where the config asks for data parallelism
    (``parallel.data_devices`` above 1, or -1 with more than one card
    visible), which the port does not run yet (ROADMAP §1, 'Parallel')."""
    n = int((config.get("parallel") or {}).get("data_devices", 1) or 1)
    if n < 0:
        n = torch.cuda.device_count() if device.type == "cuda" else 1
    if n > 1:
        raise NotImplementedError("parallel.data_devices > 1: data parallelism is not ported "
                                  "yet (ROADMAP §1, 'Parallel')")
