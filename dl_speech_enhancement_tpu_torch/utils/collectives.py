"""Reductions across the ranks of ``torch.distributed`` process groups: the
port's counterparts of ``lax.psum`` / ``lax.pmean`` inside the JAX package's
sharded steps.

A ``group`` is a process group, a tuple of them (the 2-D ``(data, time)``
layout of parallel/time_shard.py reduces over each in turn, which is the
reduction over the whole mesh), or ``None``: local, where every function
here is the identity.

:func:`psum` is differentiable, and its backward is again a sum over the
group, as ``psum``'s transpose is in JAX: every rank seeds its own copy of a
loss built on it, so a term that reaches the loss through ``psum`` carries
N seeds back to each rank, and a term computed locally carries one. The
training steps keep both at one scale by the rule of
parallel/mesh.py: each rank's loss is its local share of every batch-mean
term plus each batch-coupled term whole, and the gradients are averaged
(:func:`average_gradients`), not summed.

Gloo moves host memory only, so a tensor on a card under a gloo group (ranks
that share a card) goes through a host copy; NCCL reduces on the card.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist


def groups_of(group) -> tuple:
    """``group`` as a tuple of process groups (empty for ``None``)."""
    if group is None:
        return ()
    return tuple(group) if isinstance(group, (tuple, list)) else (group,)


def group_size(group) -> int:
    """Ranks a reduction over ``group`` spans (1 for ``None``)."""
    return math.prod(dist.get_world_size(g) for g in groups_of(group))


def _staged(t: torch.Tensor, group) -> bool:
    return t.device.type != "cpu" and dist.get_backend(group) == "gloo"


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Reduce ``t`` in place over ``group`` (no autograd); returns ``t``."""
    for g in groups_of(group):
        if _staged(t, g):
            host = t.detach().cpu()
            dist.all_reduce(host, op=op, group=g)
            t.copy_(host)
        else:
            dist.all_reduce(t, op=op, group=g)
    return t


def broadcast_(t: torch.Tensor, group, src: int = 0) -> torch.Tensor:
    """Overwrite ``t`` in place with the tensor of the group's rank ``src``."""
    for g in groups_of(group):
        root = dist.get_global_rank(g, src)
        if _staged(t, g):
            host = t.detach().cpu()
            dist.broadcast(host, root, group=g)
            t.copy_(host)
        else:
            dist.broadcast(t, root, group=g)
    return t


def exchange(send: torch.Tensor | None, to: int | None, recv_like: torch.Tensor,
             frm: int | None, group) -> torch.Tensor:
    """Send ``send`` to the group's rank ``to`` and receive a tensor shaped as
    ``recv_like`` from its rank ``frm`` in one batch of point-to-point
    operations (either side may be None: nothing sent, or zeros received)."""
    staged = _staged(recv_like, group)
    recv = torch.zeros(recv_like.shape, dtype=recv_like.dtype,
                       device="cpu" if staged else recv_like.device)
    ops = []
    if to is not None:
        out = send.detach().contiguous()
        ops.append(dist.P2POp(dist.isend, out.cpu() if staged else out,
                              dist.get_global_rank(group, to), group))
    if frm is not None:
        ops.append(dist.P2POp(dist.irecv, recv, dist.get_global_rank(group, frm), group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return recv.to(recv_like.device) if staged else recv


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, groups):
        ctx.groups = groups
        return all_reduce_(t.detach().clone(), groups)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.contiguous().clone(), ctx.groups), None


def psum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over the ranks of ``group``; differentiable."""
    groups = groups_of(group)
    return _Psum.apply(t, groups) if groups else t


def pmean(t: torch.Tensor, group) -> torch.Tensor:
    """The mean of ``t`` over the ranks of ``group``; differentiable."""
    groups = groups_of(group)
    return psum(t, groups) / group_size(groups) if groups else t


@torch.no_grad()
def pmean_values(values: dict, group) -> dict:
    """A dict of scalar tensors averaged over ``group`` in one reduction (the
    values a step logs)."""
    if not groups_of(group) or not values:
        return values
    keys = list(values)
    stacked = torch.stack([torch.as_tensor(values[k]).detach().reshape(()) for k in keys])
    all_reduce_(stacked, group)
    stacked /= group_size(group)
    return dict(zip(keys, stacked.unbind()))


@torch.no_grad()
def average_gradients(params, group) -> None:
    """Replace each parameter's gradient by its mean over ``group`` in one
    reduction of the flattened gradients (parameters without one, frozen in
    the step on every rank alike, are left without)."""
    if not groups_of(group):
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    all_reduce_(flat, group)
    flat /= group_size(group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
