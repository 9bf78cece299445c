"""Devices, ranks and meshes: the counterpart of
dl_speech_enhancement_tpu/parallel/mesh.py.

The JAX package's mesh is a ``jax.sharding.Mesh`` that one process drives;
its jitted steps are SPMD programs over it, and XLA inserts the reductions.
The port has two counterparts:

- serving (parallel/serve.py, parallel/long_audio.py) takes the ``data``
  axis as a plain list of ``torch.device``s, one process driving every
  slice: :func:`make_mesh` picks the first N devices of a kind;
- training runs one process (rank) a device over ``torch.distributed``.
  :func:`launch` spawns the ranks, rank r on ``devices[r]``; inside them
  :func:`mesh_from_config` and :func:`device_mesh` give the
  ``torch.distributed.device_mesh.DeviceMesh`` (dims ``("data",)`` or
  ``("data", "time")``), :func:`shard_batch` cuts a host batch to the rank's
  rows before its upload, and :func:`replicate` / :func:`shard_train_state`
  make every rank's state equal to rank 0's.

A data-parallel step over N ranks computes what the one-process step
computes on the whole batch, up to f32 reduction order, as the JAX package's
SPMD step does. Plain gradient averaging gives that only for terms that are
means over the batch's rows; a term that couples the rows (the course's SNR
gate, spectral convergence, the codebooks' EMA statistics, perplexity,
the statistic workload's sums) reduces its sums over the ranks inside the
loss (utils/collectives.py). The rule that keeps the two kinds at one
scale: each rank's loss is its local share of every batch-mean term plus
each batch-coupled term whole, through the differentiable ``psum``; one
gradient reduction an optimizer step, after the last microbatch's backward
and before the clip, averages the gradients over the ranks
(``utils.collectives.average_gradients``). Every rank then applies the same
update, so the replicated state stays equal without a broadcast.

The backend follows one rule (:func:`backend_for`): NCCL where every rank
has a card of its own, gloo on the CPU and where several ranks share a card
(``[cuda:0, cuda:0]``).
"""

from __future__ import annotations

import logging
import os
import socket
import tempfile

import torch
import torch.distributed as dist

from dl_speech_enhancement_tpu_torch.utils.collectives import broadcast_

__all__ = ["backend_for", "data_parallel_devices", "device_mesh", "launch", "make_mesh",
           "mesh_from_config", "replicate", "shard_batch", "shard_train_state"]

logger = logging.getLogger(__name__)


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


# ---------------------------------------------------------------- training


def _requested(config: dict) -> int:
    return int((config.get("parallel") or {}).get("data_devices", 1) or 1)


def data_parallel_devices(config: dict, device) -> list[torch.device] | None:
    """The devices of the ranks ``config['parallel']['data_devices']`` asks
    for on ``device``, or None where that is one rank (0, 1, absent):

    - ``'cpu'``: the host N times (gloo ranks); -1 is the one host;
    - a card by index (``'cuda:0'``): that card N times (gloo ranks sharing
      it); -1 is that one card;
    - ``'cuda'``: the first N visible cards, -1 all of them; more than are
      visible raises ValueError, as the JAX ``mesh_from_config`` does."""
    n = _requested(config)
    device = torch.device(device)
    if device.type == "cpu" or device.index is not None:
        return [device] * n if n > 1 else None
    avail = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 0:
        n = avail
    if n <= 1:
        return None
    if n > avail:
        raise ValueError(f"parallel.data_devices={n} but only {avail} devices are visible")
    return make_mesh(n)


def backend_for(devices) -> str:
    """``'nccl'`` where every rank has a card of its own, ``'gloo'`` on the
    CPU and where ranks share a card."""
    devices = [torch.device(d) for d in devices]
    kinds = {d.type for d in devices}
    if len(kinds) != 1 or not kinds <= {"cpu", "cuda"}:
        raise ValueError(f"ranks on {devices}: every rank must be on the CPU or every rank "
                         "on a card")
    if kinds == {"cuda"} and len({d.index for d in devices}) == len(devices):
        return "nccl"
    return "gloo"


def device_mesh(shape=None, names=("data",)):
    """A ``DeviceMesh`` over the launched ranks (``shape`` defaults to all
    of them on one dim), its device type by the process group's backend."""
    from torch.distributed.device_mesh import init_device_mesh

    if shape is None:
        shape = (dist.get_world_size(),)
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(kind, tuple(shape), mesh_dim_names=tuple(names))


def mesh_from_config(config: dict):
    """The ``("data",)`` mesh ``config['parallel']['data_devices']`` asks
    for, over the ranks :func:`launch` started; None for one rank.

    ``data_devices`` -1 takes every launched rank; a count other than the
    process group's raises ValueError. More than one rank asked for outside
    a process group raises RuntimeError: start the ranks with
    :func:`launch` (the training CLIs' ``--dp N``)."""
    n = _requested(config)
    if n in (0, 1):
        return None
    if not dist.is_initialized():
        if n < 0 and (torch.cuda.device_count() if torch.cuda.is_available() else 0) <= 1:
            return None
        raise RuntimeError(f"parallel.data_devices={n} asks for several ranks: start them with "
                           "parallel.mesh.launch (the training CLIs' --dp N)")
    world = dist.get_world_size()
    if n > 0 and n != world:
        raise ValueError(f"parallel.data_devices={n} but {world} ranks were launched")
    if world == 1:
        return None
    return device_mesh((world,), ("data",))


def _data_axis(mesh) -> tuple[int, int]:
    """(ranks on the data axis, this rank's index along it)."""
    return mesh["data"].size(), mesh.get_local_rank("data")


def _rows(a, n: int, r: int, grad_accum: int):
    b = a.shape[0]
    if b % n:
        raise ValueError(f"batch size {b} is not divisible by parallel.data_devices={n}")
    if b % (n * grad_accum):
        raise ValueError(f"batch size {b} is not divisible by grad_accum={grad_accum} x "
                         f"parallel.data_devices={n}")
    k = b // (n * grad_accum)
    return a.reshape(grad_accum, n, k, *a.shape[1:])[:, r].reshape(grad_accum * k,
                                                                   *a.shape[1:])


def shard_batch(mesh, batch, grad_accum: int = 1):
    """This rank's rows of a host batch (an array, or a tuple or list of
    them), as JAX's ``shard_batch`` puts the r-th 1/N of the rows on device
    r; the whole batch without a mesh. With ``grad_accum`` microbatches the
    rank takes the r-th 1/N of each (rows ``[i * mb + r * mb / N, i * mb +
    (r + 1) * mb / N)`` of microbatch i), so that its microbatch i holds its
    part of the one-process microbatch i. A batch the ranks do not divide
    raises ValueError."""
    if mesh is None:
        return batch
    n, r = _data_axis(mesh)
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(mesh, b, grad_accum) for b in batch)
    return _rows(batch, n, r, grad_accum)


def _tensors(tree):
    if isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
        yield from tree.buffers()
    elif isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)


@torch.no_grad()
def replicate(mesh, tree):
    """Overwrite every tensor of ``tree`` (a module's parameters and buffers,
    a ``VQState``, dicts and lists of them) in place with rank 0's along the
    data axis, so that every rank holds the same state; returns ``tree``."""
    if mesh is not None:
        group = mesh.get_group("data")
        for t in _tensors(tree):
            broadcast_(t.data if isinstance(t, torch.nn.Parameter) else t, group)
    return tree


def shard_train_state(mesh, state):
    """The train state replicated over the mesh (:func:`replicate`): data
    parallelism keeps parameters, optimizer and codebook state whole on every
    rank."""
    return replicate(mesh, state)


# ---------------------------------------------------------------- launching


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, fn, devices, backend, init_method, timeout, level, out, args):
    logging.basicConfig(level=level, format=f"%(asctime)s [rank {rank}] (%(module)s) %(message)s")
    device = devices[rank]
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.cuda.init()
    kwargs = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(backend, init_method=init_method, world_size=len(devices),
                            rank=rank, **kwargs)
    try:
        result = fn(device, *args)
        torch.save(result, os.path.join(out, f"{rank}.pt"))
    finally:
        dist.destroy_process_group()


def launch(fn, devices, *args, init_method: str | None = None, timeout=None) -> list:
    """Run ``fn(device, *args)`` in ``len(devices)`` processes started with
    ``torch.multiprocessing``'s spawn (never fork: the parent may hold a CUDA
    context), rank r on ``devices[r]``, in one process group whose backend
    :func:`backend_for` picks; return the ranks' return values in rank
    order (``fn`` and ``args`` pickle; the values go through ``torch.save``).
    ``init_method`` defaults to a free localhost TCP port (tests pass a
    ``file://`` path, which no two runs share); ``timeout`` (a
    ``datetime.timedelta``) bounds each collective. A rank that raises ends
    them all, and the launch raises."""
    import torch.multiprocessing as mp

    devices = [torch.device(d) for d in devices]
    backend = backend_for(devices)
    logger.info("data parallel: %d ranks on %s, backend %s", len(devices),
                ", ".join(map(str, devices)), backend)
    if init_method is None:
        init_method = f"tcp://localhost:{_free_port()}"
    with tempfile.TemporaryDirectory() as out:
        mp.spawn(_rank_main, nprocs=len(devices), join=True,
                 args=(fn, devices, backend, init_method, timeout,
                       logging.getLogger().getEffectiveLevel(), out, args))
        return [torch.load(os.path.join(out, f"{r}.pt"), map_location="cpu",
                           weights_only=False) for r in range(len(devices))]
