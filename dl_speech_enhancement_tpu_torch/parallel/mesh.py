"""The devices a fleet runs on, the counterpart of
dl_speech_enhancement_tpu/parallel/mesh.py::make_mesh (:21-31).

The JAX package's mesh is a ``jax.sharding.Mesh`` whose ``data`` axis
shards the streams. The port's fleets (parallel/serve.py, parallel/
long_audio.py) take that axis as a plain list of ``torch.device``s: slice
``d`` of the streams runs on ``devices[d]``, with its own copy of the models.
:func:`make_mesh` picks the first N devices of a kind.

The JAX module's training helpers (``mesh_from_config``, ``shard_batch``,
``shard_train_state``, ``replicate``) belong to data-parallel training,
which ROADMAP.md §1 queues as the next slice of the port.
"""

from __future__ import annotations

import torch

__all__ = ["make_mesh"]


def make_mesh(n_devices: int | None = None, kind: str = "cuda") -> list[torch.device]:
    """The first ``n_devices`` devices of ``kind`` (all visible ones by
    default), as the JAX ``make_mesh`` takes the first N of ``jax.devices()``.

    ``kind='cuda'`` counts the visible cards and raises RuntimeError where
    fewer than ``n_devices`` are visible. ``kind='cpu'`` has one device, the
    host, which a list may name several times (the CPU tests' stand-in for
    JAX's virtual CPU devices): ``n_devices`` entries, one by default."""
    if kind == "cpu":
        n = 1 if n_devices is None else int(n_devices)
        if n < 1:
            raise ValueError(f"n_devices must be at least 1, got {n}")
        return [torch.device("cpu")] * n
    if kind != "cuda":
        raise ValueError(f"kind must be 'cuda' or 'cpu', got {kind!r}")
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = visible if n_devices is None else int(n_devices)
    if n < 1 or n > visible:
        raise RuntimeError(f"{n} CUDA devices asked for, {visible} visible; pass kind='cpu' "
                           "for the plain PyTorch path")
    return [torch.device("cuda", i) for i in range(n)]
