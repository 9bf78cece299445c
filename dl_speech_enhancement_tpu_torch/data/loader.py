"""Host-side batching with background prefetch, and the upload to the card.

The port's own copy of dl_speech_enhancement_tpu/data/loader.py (reference
dataloader/data_utils.py:25-35): seeded shuffling, drop-last batching, a
collater, and a bounded background thread that reads and crops the next
batches while the card trains on the current one (decode is numpy, so a
thread suffices). :func:`prefetch_to_device` replaces JAX's ``device_put``
prefetch: pinned host buffers copied with ``non_blocking=True`` a few
batches ahead.
"""

from __future__ import annotations

import collections
import queue
import threading

import numpy as np
import torch

from dl_speech_enhancement_tpu_torch.data.collate import CollaterAudio, CollaterAudioPair
from dl_speech_enhancement_tpu_torch.data.dataset import random_split

PREFETCH = 2  # batches the background thread reads ahead


class DataLoader:
    def __init__(self, dataset, batch_size: int, collate_fn, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _batches(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(idx)
        for b in range(len(self)):
            sel = idx[b * self.batch_size:(b + 1) * self.batch_size]
            out = self.collate_fn([self.dataset[int(i)] for i in sel])
            if out is not None:
                yield out

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=PREFETCH)
        end = object()
        stop = threading.Event()

        def put(item) -> bool:
            # a bounded put that gives up once the consumer is gone: an
            # abandoned iterator (an epoch cut short) must not leave its
            # thread blocked on a full queue
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            # an exception in the dataset or the collater reaches the
            # consumer; a bare end marker would read as a short epoch
            try:
                for batch in self._batches():
                    if not put(batch):
                        return
            except BaseException as e:  # noqa: BLE001 - re-raised in the consumer
                put(e)
                return
            put(end)

        threading.Thread(target=worker, daemon=True).start()
        try:
            while True:
                item = q.get()
                if item is end:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # on exhaustion and on close (an abandoned iterator)
            stop.set()


def _map(fn, batch):
    if isinstance(batch, (tuple, list)):
        return type(batch)(_map(fn, b) for b in batch)
    return fn(batch)


def prefetch_to_device(iterator, size: int = 2, device="cpu", rows=None):
    """Yield the batches of ``iterator`` (numpy arrays, or tuples of them) as
    tensors on ``device``, each copied from pinned host memory with
    ``non_blocking=True`` ``size`` batches ahead of the one yielded, so the
    copies queue behind the card's work instead of waiting for it. A pinned
    buffer is released only after an event recorded behind its copy has
    completed (a pinned buffer reused while its copy is in flight would
    corrupt a batch). On the CPU the batches pass through unchanged.

    ``rows`` (a data-parallel rank's ``parallel.mesh.shard_batch``) cuts each
    host batch to the rows the rank trains on before anything is copied, so
    a rank uploads only its rows; the ranks' rows at step s are the
    one-process batch at step s."""
    device = torch.device(device)
    if rows is not None:
        iterator = map(rows, iterator)
    if device.type != "cuda":
        yield from iterator
        return

    def upload(batch):
        pinned = _map(lambda a: torch.from_numpy(np.ascontiguousarray(a)).pin_memory(), batch)
        out = _map(lambda t: t.to(device, non_blocking=True), pinned)
        copied = torch.cuda.Event()
        copied.record()
        return out, (pinned, copied)

    ahead: collections.deque = collections.deque()
    in_flight: collections.deque = collections.deque()
    try:
        for batch in iterator:
            ahead.append(upload(batch))
            if len(ahead) > size:
                out, held = ahead.popleft()
                in_flight.append(held)
                yield out
                while in_flight and in_flight[0][1].query():
                    in_flight.popleft()
        while ahead:
            out, held = ahead.popleft()
            in_flight.append(held)
            yield out
    finally:
        # on exhaustion and on close: no pinned buffer goes before its copy
        for _, copied in (*in_flight, *(held for _, held in ahead)):
            copied.synchronize()


def create_dataloader(dataset, batch_size, batch_length, seed, pair=False):
    coll_cls = CollaterAudioPair if pair else CollaterAudio
    collater = coll_cls(batch_length, rng=np.random.default_rng(seed + 1))
    return DataLoader(dataset, batch_size, collater, seed=seed)


def get_dataloaders(dataset, splits=None, batch_size=8, batch_length=2 * 48000, seed=82,
                    pair=False):
    """Seeded 70/15/15 split into three loaders (data_utils.py:38-51)."""
    if splits is None:
        splits = [0.7, 0.15, 0.15]
    return [create_dataloader(s, batch_size, batch_length, seed, pair=pair)
            for s in random_split(dataset, splits, seed)]
