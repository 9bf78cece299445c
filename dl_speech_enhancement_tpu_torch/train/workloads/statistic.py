"""Statistic workload: the analyzer's code statistics, the vocoder's input
normalisation.

Counterpart of dl_speech_enhancement_tpu/train/workloads/statistic.py. The
reference's ``codecStatistic.py`` is not in its repository; its contract
lives in config/statistic/*.yaml (the analyzer checkpoint and the ``stats``
output path) and in the consumer (models/vocoder/HiFiGAN.py:206-219, a
``(2, code_dim)`` .npy of [mean; scale]). The frozen analyzer (encoder,
projector, quantizer) runs over a clean corpus clip by clip, and the
per-dimension sums of ``zq`` and of its square accumulate in f64 on the
analyzer's device, read once at the end. Each clip is zero-padded on the
right to a power-of-two count of code frames, as the JAX package pads it:
there so that its jitted encoder compiles less often, here so that cuDNN
plans its convolutions for a few lengths rather than one per clip. The
encoder is causal, so the codes of the clip's own frames, the only ones
summed, do not see the padding. With a process group the clips are dealt
out over its ranks (rank r takes clips r, r + N, ...), and the sums and the
row count are summed over them before the division.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from dl_speech_enhancement_tpu_torch.train.workloads.vocoder import encode
from dl_speech_enhancement_tpu_torch.utils.collectives import all_reduce_, groups_of


def compute_statistics(analyzer, vq_state, dataset, batch_length: int | None = None,
                       group=None) -> np.ndarray:
    """(2, code_dim) float32 [mean; scale (std)] of the quantized codes of
    ``dataset``'s clips (arrays, or (utt_id, array) pairs), each cut to a
    multiple of ``batch_length`` where given and to whole code frames.
    ``group`` (a process group) deals the clips out over its ranks; every
    rank returns the statistics of the whole dataset."""
    dim = analyzer.quantizer.code_dim
    total = torch.zeros(dim, dtype=torch.float64, device=analyzer.device)
    total_sq = torch.zeros_like(total)
    count = 0
    n, r = 1, 0
    if groups_of(group):
        n, r = dist.get_world_size(group), dist.get_rank(group)
    for i, item in enumerate(dataset):
        if i % n != r:
            continue
        audio = item[1] if isinstance(item, tuple) else item
        x = np.asarray(audio, np.float32)
        if x.ndim == 1:
            x = x[:, None]
        if batch_length is not None:
            x = x[:(x.shape[0] // batch_length) * batch_length]
        t = (x.shape[0] // analyzer.hop) * analyzer.hop
        if t == 0:
            continue
        frames = t // analyzer.hop
        padded = np.zeros((1, (1 << (frames - 1).bit_length()) * analyzer.hop, x.shape[1]),
                          np.float32)
        padded[0, :t] = x[:t]
        zq = encode(analyzer, vq_state, torch.from_numpy(padded).to(analyzer.device))
        zq = zq[0, :frames].double()
        total += zq.sum(0)
        total_sq += (zq * zq).sum(0)
        count += zq.shape[0]
    if groups_of(group):
        sums = torch.cat([total, total_sq, total.new_tensor([count])])
        all_reduce_(sums, group)
        total, total_sq, count = sums[:dim], sums[dim:2 * dim], int(sums[-1].item())
    if count == 0:
        raise ValueError("no clip is as long as one code frame: no statistics")
    mean = total.cpu().numpy() / count
    var = total_sq.cpu().numpy() / count - mean ** 2
    scale = np.sqrt(np.maximum(var, 1e-12))
    return np.stack([mean, scale]).astype(np.float32)


def save_statistics(path: str, stats: np.ndarray):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.save(path, stats)
