"""Interval-driven GAN training driver (the reference TrainerGAN core).

Counterpart of dl_speech_enhancement_tpu/train/gan_trainer.py
(trainer/trainerGAN.py:24-347), in PyTorch idiom: the networks and their
optimizers are stateful objects that a workload's step updates in place, the
codebooks a functional ``VQState`` the step hands back. The driver keeps what
stays on the host: epochs, the interval-gated eval, save and log
(trainerGAN.py:316-347), scalars to the log and, where
``torch.utils.tensorboard`` imports, to TensorBoard, and checkpoint naming.

A step's loss fragments stay on the card: they are summed there (in f64)
and read once a log interval (and once an eval pass), not once a fragment
and step, so the host does not wait for the card at every step.

``parallel.data_devices`` above 1 runs the trainer data-parallel over the
ranks parallel/mesh.py::launch started (the CLI's ``--dp N``), the
counterpart of the JAX trainer's mesh: every rank runs the same host loader
and uploads only its rows (``prefetch_to_device(rows=...)``), the workloads
reduce their batch-coupled terms and average their gradients over
``self.group``, the fragments are averaged over the ranks when they are
read, and rank 0 alone logs them, writes TensorBoard and checkpoints.
"""

from __future__ import annotations

import functools
import logging
import os
import time

import torch

from dl_speech_enhancement_tpu_torch.data.loader import prefetch_to_device
from dl_speech_enhancement_tpu_torch.parallel.mesh import (
    mesh_from_config,
    shard_batch,
    shard_train_state,
)
from dl_speech_enhancement_tpu_torch.train.checkpoint import (
    is_rank0,
    load_checkpoint,
    restore,
    save_checkpoint,
)
from dl_speech_enhancement_tpu_torch.utils.collectives import all_reduce_, group_size
from dl_speech_enhancement_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


def _summary_writer(logdir: str | None):
    """A TensorBoard writer into ``logdir``, or None without one or where
    ``torch.utils.tensorboard`` does not import."""
    if not logdir:
        return None
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(logdir)


class TrainerGAN:
    """The host-side driver. A workload subclass implements
    ``_train_step(batch)`` and ``_eval_step(batch)``, advances ``steps`` and
    fills ``modules`` (state key -> ``nn.Module``: ``params_generator``,
    ``params_discriminator``, ``params_analyzer``), ``optimizers`` (state key
    -> ``train.optim.Optimizer``: ``opt_generator``, ``opt_discriminator``)
    and ``vq_state``. Their state dicts under those keys, with ``steps`` and
    ``epochs``, are the checkpoint. ``loader_wait`` sums the seconds the
    training loop (this rank's) spent waiting for its next batch.

    ``mesh`` is ``parallel.mesh.mesh_from_config(config)`` (None for one
    process) and ``group`` its data axis, which the workloads reduce over;
    a workload calls :meth:`_shard_state` once its state is built.
    ``_train_step`` / ``_eval_step`` take this rank's rows of a batch, which
    the epoch loops cut."""

    def __init__(self, steps, epochs, data_loader, config, device="cuda"):
        self.device = resolve_device(device)
        self.mesh = mesh_from_config(config)
        self.group = None if self.mesh is None else self.mesh.get_group("data")
        self.rank0 = is_rank0()
        self.steps = int(steps)
        self.epochs = int(epochs)
        self.data_loader = data_loader
        self.config = config
        self.train_max_steps = config.get("train_max_steps", 0)
        self.writer = _summary_writer(config.get("outdir")) if self.rank0 else None
        self.total_train_loss: dict = {}
        self.total_eval_loss: dict = {}
        self.finish_train = False
        self.modules: dict = {}
        self.optimizers: dict = {}
        self.vq_state = None
        self.loader_wait = 0.0

    # ------------------------------------------------------------------
    def _shard_state(self):
        """Make every rank's modules and codebooks rank 0's (no-op in one
        process); run once the state is built and after a restore."""
        if self.mesh is not None:
            shard_train_state(self.mesh, [list(self.modules.values()), self.vq_state])

    def _batches(self, loader):
        rows = None if self.mesh is None else functools.partial(shard_batch, self.mesh)
        return prefetch_to_device(loader, device=self.device, rows=rows)

    def _device_batch(self, batch):
        """A batch (an array or a tuple of arrays) as tensors on the device."""
        if isinstance(batch, (tuple, list)):
            return tuple(self._device_batch(b) for b in batch)
        return torch.as_tensor(batch, device=self.device)

    def _train_step(self, batch):  # pragma: no cover - abstract
        raise NotImplementedError

    def _eval_step(self, batch):  # pragma: no cover - abstract
        raise NotImplementedError

    @property
    def state(self) -> dict:
        """The live state under the JAX package's keys."""
        out = {key: m.state_dict() for key, m in self.modules.items()}
        if self.vq_state is not None:
            out["vq_state"] = self.vq_state
        out.update({key: opt.state_dict() for key, opt in self.optimizers.items()})
        return out

    # ------------------------------------------------------------------
    def run(self):
        self.finish_train = False
        while not self.finish_train:
            self._train_epoch()
        logger.info("Finished training.")

    def _train_epoch(self):
        batches = self._batches(self.data_loader["train"])
        n = 0
        try:
            while True:
                t0 = time.perf_counter()
                batch = next(batches, None)
                self.loader_wait += time.perf_counter() - t0
                if batch is None:
                    break
                n += 1
                self._train_step(batch)
                self._check_log_interval()
                self._check_eval_interval()
                self._check_save_interval()
                if self.finish_train:
                    return
        finally:
            batches.close()
        if n == 0:
            # an empty epoch would spin run() forever
            raise RuntimeError("training epoch yielded no batches: check the data pipeline "
                               "(batch_length against the clips' lengths, corpus paths)")
        self.epochs += 1
        if n > 200 and self.rank0:
            logger.info("(Steps: %d) Finished %d epoch training (%d steps per epoch).",
                        self.steps, self.epochs, n)

    def _eval_epoch(self):
        if self.rank0:
            logger.info("(Steps: %d) Start evaluation.", self.steps)
        n = 0
        for n, batch in enumerate(self._batches(self.data_loader["dev"]), 1):
            self._eval_step(batch)
        self._log(self._read(self.total_eval_loss, max(n, 1)))
        self.total_eval_loss = {}

    # ------------------------------------------------------------------
    def _record_losses(self, metrics: dict, mode: str = "train"):
        """Add a step's fragments (tensors on the device) to the running sums,
        on the device."""
        store = self.total_train_loss if mode == "train" else self.total_eval_loss
        for name, value in metrics.items():
            key = f"{mode}/{name}"
            value = torch.as_tensor(value).detach().to(self.device, torch.float64)
            store[key] = store[key] + value if key in store else value

    def _read(self, store: dict, divisor: int) -> dict:
        """The running sums over ``divisor``, averaged over the ranks, as
        floats: one reduction and one read from the card."""
        if not store:
            return {}
        values = torch.stack(list(store.values()))
        all_reduce_(values, self.group)
        return dict(zip(store, (values / (divisor * group_size(self.group))).tolist()))

    def _log(self, losses: dict):
        """Rank 0's log lines and TensorBoard scalars of ``losses``."""
        if not self.rank0:
            return
        for key, value in losses.items():
            logger.info("(Steps: %d) %s = %.4f.", self.steps, key, value)
        self._write_to_tensorboard(losses)

    def _write_to_tensorboard(self, losses: dict):
        if self.writer is None:
            return
        for key, value in losses.items():
            self.writer.add_scalar(key, value, self.steps)

    def _check_save_interval(self):
        if self.steps and self.steps % self.config["save_interval_steps"] == 0:
            self.save_checkpoint(os.path.join(self.config["outdir"],
                                              f"checkpoint-{self.steps}steps"))
            if self.rank0:
                logger.info("Successfully saved checkpoint @ %d steps.", self.steps)

    def _check_eval_interval(self):
        if "dev" in self.data_loader and self.steps % self.config["eval_interval_steps"] == 0:
            self._eval_epoch()

    def _check_log_interval(self):
        interval = self.config["log_interval_steps"]
        if self.steps % interval == 0:
            self._log(self._read(self.total_train_loss, interval))
            self.total_train_loss = {}

    def _check_train_finish(self):
        if self.steps >= self.train_max_steps:
            self.finish_train = True
        return self.finish_train

    # ------------------------------------------------------------------
    def save_checkpoint(self, path: str):
        save_checkpoint(path, dict(self.state, steps=self.steps, epochs=self.epochs),
                        config=self.config)

    def load_checkpoint(self, path: str, load_only_params: bool = False,
                        load_discriminator: bool = True):
        """Restore the training state saved at ``path`` (trainerGAN.py:124-149
        contract): ``load_only_params`` loads the generator's and the
        discriminator's weights and the codebooks only, no optimizer state
        or counter; ``load_discriminator=False`` keeps the discriminator's
        optimizer state fresh (its weights still load)."""
        stored = load_checkpoint(path)
        if load_only_params:
            keys = [k for k in ("params_generator", "params_discriminator", "vq_state")
                    if k in stored]
        else:
            self.steps = int(stored.pop("steps", self.steps))
            self.epochs = int(stored.pop("epochs", self.epochs))
            if not load_discriminator:
                stored.pop("opt_discriminator", None)
            keys = list(stored)
        for key in keys:
            if key in self.modules:
                self.modules[key].load_state_dict(stored[key])
            elif key in self.optimizers:
                self.optimizers[key].load_state_dict(stored[key])
            elif key == "vq_state" and self.vq_state is not None:
                self.vq_state = restore(self.vq_state, stored[key], key)
        self._shard_state()
