"""Optimizers, schedulers and freezes, built from the reference's config keys.

Counterpart of dl_speech_enhancement_tpu/train/optim.py, whose optax chain

    clip_by_global_norm (grad_norm > 0) -> add_decayed_weights (weight_decay > 0)
        -> adam(lr=schedule)

becomes :class:`Optimizer`: the clip with optax's formula (``g * max_norm /
norm`` once ``norm >= max_norm``; not ``clip_grad_norm_``'s ``max_norm /
(norm + 1e-6)``), then ``torch.optim.Adam``, whose ``weight_decay`` is the
same coupled L2 (added to the clipped gradient before the moments), then one
scheduler step: ``StepLR`` / ``MultiStepLR`` give, at update count k, the
optax schedule's value at count k.

A freeze (:func:`frozen`) takes parameters out of autograd for a step, as
the reference's ``requires_grad=False`` does (trainer/autoencoder.py:66-75):
they take no gradient, so the clip measures the trainable ones' norm alone
and Adam skips them. The JAX package zeroes their gradients and restores
them after the update: the parameters end the same, but optax's moments of
the frozen leaves decay and the port's do not move.
"""

from __future__ import annotations

import collections
import contextlib
from typing import Iterable, Sequence

import torch


def build_schedule(optimizer: torch.optim.Optimizer, scheduler_type: str | None,
                   params: dict | None):
    """The scheduler of ``optimizer`` for the reference's scheduler keys, or
    None for a constant learning rate."""
    params = params or {}
    if scheduler_type in (None, "none"):
        return None
    if scheduler_type == "StepLR":
        gamma = float(params.get("gamma", 1.0))
        if gamma == 1.0:
            return None
        return torch.optim.lr_scheduler.StepLR(optimizer, int(params.get("step_size", 1)), gamma)
    if scheduler_type == "MultiStepLR":
        milestones = [int(m) for m in params.get("milestones", [])]
        return torch.optim.lr_scheduler.MultiStepLR(optimizer, milestones,
                                                    float(params.get("gamma", 0.5)))
    raise NotImplementedError(f"scheduler {scheduler_type}")


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place by ``max_norm / norm`` where their global norm
    is at least ``max_norm`` (optax's ``(g / norm) * max_norm``); returns the
    norm. Stays on the device: no host synchronisation."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm) * max_norm))
    return norm


class Optimizer:
    """Adam with optional global-norm clipping and a learning-rate schedule,
    over the parameters that require a gradient. :meth:`step` clips, updates
    and advances the schedule by one update; parameters whose ``grad`` is
    None take no step."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999), weight_decay: float = 0.0,
                 scheduler_type: str | None = None, scheduler_params: dict | None = None,
                 grad_norm: float = -1):
        self.params = [p for p in params if p.requires_grad]
        self.adam = torch.optim.Adam(self.params, lr=lr, betas=tuple(betas),
                                     weight_decay=weight_decay)
        self.scheduler = build_schedule(self.adam, scheduler_type, scheduler_params)
        self.grad_norm = float(grad_norm or -1)

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    @property
    def lr(self) -> float:
        return self.adam.param_groups[0]["lr"]

    def step(self) -> None:
        if self.grad_norm > 0:
            grads = [p.grad for p in self.params if p.grad is not None]
            if grads:
                clip_by_global_norm(grads, self.grad_norm)
        self.adam.step()
        if self.scheduler is not None:
            self.scheduler.step()

    def state_dict(self) -> dict:
        """Adam's moments and counts, and the schedule's position."""
        return {"adam": self.adam.state_dict(),
                "scheduler": self.scheduler.state_dict() if self.scheduler else None}

    def load_state_dict(self, state: dict) -> None:
        self.adam.load_state_dict(state["adam"])
        if self.scheduler is not None:
            self.scheduler.load_state_dict(state["scheduler"])
            if isinstance(self.scheduler, torch.optim.lr_scheduler.MultiStepLR):
                # a checkpoint stores the milestones' Counter as a plain dict,
                # and MultiStepLR looks up every step in it
                self.scheduler.milestones = collections.Counter(self.scheduler.milestones)


def build_optimizer(params, optimizer_type: str, optimizer_params: dict,
                    scheduler_type: str | None = None, scheduler_params: dict | None = None,
                    grad_norm: float = -1) -> Optimizer:
    if optimizer_type != "Adam":
        raise NotImplementedError(f"optimizer {optimizer_type}")
    return Optimizer(params, float(optimizer_params.get("lr", 1e-4)),
                     optimizer_params.get("betas", (0.9, 0.999)),
                     float(optimizer_params.get("weight_decay", 0.0)),
                     scheduler_type, scheduler_params, grad_norm)


def build_optimizer_from_config(config: dict, role: str, params) -> Optimizer:
    """role in {'generator', 'discriminator'} with the reference's config keys."""
    return build_optimizer(
        params,
        config.get(f"{role}_optimizer_type", "Adam"),
        config.get(f"{role}_optimizer_params", {}),
        config.get(f"{role}_scheduler_type"),
        config.get(f"{role}_scheduler_params"),
        config.get(f"{role}_grad_norm", -1),
    )


def frozen_params(module: torch.nn.Module, frozen: Sequence[str]):
    """The parameters of ``module``'s top-level submodules named in ``frozen``."""
    for name in frozen:
        sub = getattr(module, name, None)
        if sub is not None:
            yield from sub.parameters()


@contextlib.contextmanager
def frozen(params: Iterable[torch.nn.Parameter]):
    """Within the block, ``params`` take no gradient (``requires_grad``
    off, restored after): autograd neither computes nor stores their
    gradients, though gradients still flow through the layers they weight,
    and the optimizer leaves them as they are (their ``grad`` stays None)."""
    held = [p for p in params if p.requires_grad]
    for p in held:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in held:
            p.requires_grad_(True)
