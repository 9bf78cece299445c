"""Random-crop collaters that give fixed-shape (B, T, C) batches.

The port's own copy of dl_speech_enhancement_tpu/data/collate.py (reference
dataloader/collater.py:18-87): clips no longer than ``batch_length`` are
left out and the others cropped at a random offset to exactly
``batch_length`` samples; the pair variant crops both signals at the same
offsets. The crop is the native library's batched copy (data/native.py)
where it is built, else numpy slicing (its plain version, the same bits).

Layout: batches are (B, T, C), channels last, as the port's generators and
discriminators take them (the reference emits (B, C, T)).
"""

from __future__ import annotations

import numpy as np

from dl_speech_enhancement_tpu_torch.data import native


class CollaterAudio:
    def __init__(self, batch_length: int = 9600, rng: np.random.Generator | None = None):
        self.batch_length = batch_length
        self.rng = rng or np.random.default_rng()

    def __call__(self, batch):
        xs = [b for b in batch if len(b) > self.batch_length]
        if not xs:
            return None
        starts = [self.rng.integers(0, len(x) - self.batch_length) for x in xs]
        return self._cut(xs, starts)

    def _cut(self, xs, starts) -> np.ndarray:
        out = native.crop_batch(xs, np.asarray(starts, np.int64), self.batch_length)
        return self._cut_plain(xs, starts) if out is None else out

    def _cut_plain(self, xs, starts) -> np.ndarray:
        return np.stack([x[s:s + self.batch_length] for x, s in zip(xs, starts)]).astype(
            np.float32, copy=False)


class CollaterAudioPair(CollaterAudio):
    """Items are (target, input) pairs of equal length, e.g. the (clean,
    noisy) items of ``MultiDataset([clean, noisy])``; returns ``(input_batch,
    target_batch)``, e.g. (noisy, clean), both cropped at the same offsets."""

    def __call__(self, batch):
        batch = [b for b in batch
                 if len(b[0]) > self.batch_length and len(b[0]) == len(b[1])]
        if not batch:
            raise ValueError("no audio pair is longer than batch_length with equal lengths")
        xs = [b[0] for b in batch]  # targets
        ns = [b[1] for b in batch]  # inputs
        starts = [self.rng.integers(0, len(x) - self.batch_length) for x in xs]
        return self._cut(ns, starts), self._cut(xs, starts)
