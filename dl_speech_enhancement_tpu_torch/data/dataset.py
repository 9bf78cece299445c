"""Datasets: the course's recursive wav scan and AudioDec's file-list datasets.

The port's own numpy copy of dl_speech_enhancement_tpu/data/dataset.py:

- :class:`AudioDataset` (reference dataloader/AudioDataset.py:8-36): the
  ``.wav`` files one and two directories deep, loaded and resampled to the
  target rate; items are (T, C) float32.
- :class:`SingleDataset` / :class:`MultiDataset` (reference
  dataloader/dataset.py:20-152): a directory, a list or a file of paths,
  sorted, with utterance ids and an optional subset; the multi variant zips
  N parallel corpora (noisy and clean) of equal length.
- :func:`find_files` (reference dataloader/utils.py: os.walk + fnmatch).
- :func:`random_split`: torch's ``random_split`` on a numpy permutation,
  its rounding remainder dealt round-robin from the first split.
"""

from __future__ import annotations

import fnmatch
import glob
import os

import numpy as np

from dl_speech_enhancement_tpu_torch.data.audio_io import load_audio


def load_files(data_path: str, query: str = "*.wav", num_core: int = 1):
    """Sorted file scan split into ``num_core`` chunks (reference
    dataloader/utils.py, which feeds a multiprocess resampler)."""
    files = sorted(find_files(data_path, query))
    if num_core <= 1:
        return files
    return [list(chunk) for chunk in np.array_split(files, num_core) if len(chunk)]


def find_files(root_dir: str, query: str = "*.wav", include_root_dir: bool = True):
    files = []
    for root, _, filenames in os.walk(root_dir, followlinks=True):
        for filename in fnmatch.filter(filenames, query):
            files.append(os.path.join(root, filename))
    files = sorted(files)
    if not include_root_dir:
        files = [f.replace(root_dir + "/", "") for f in files]
    return files


class AudioDataset:
    """The wav files one and two levels under ``audio_dir``
    (AudioDataset.py:14-24), named relative to ``audio_root``."""

    def __init__(self, audio_dir: str, audio_root: str, sample_rate: int):
        self.audio_dir = audio_dir
        self.sample_rate = sample_rate
        names = []
        for depth in range(1, 3):
            pattern = audio_dir + "/*" * depth + ".wav"
            for filename in glob.glob(pattern):
                names.append(filename.replace("\\", "/").split(audio_root + "/")[-1])
        self.audio_file_names = names

    def __len__(self):
        return len(self.audio_file_names)

    def __getitem__(self, idx: int) -> np.ndarray:
        path = os.path.join(self.audio_dir, self.audio_file_names[idx])
        return load_audio(path, self.sample_rate)


def _resolve_files(files) -> list[str]:
    """A directory, a list or a file of paths (one a line) -> the sorted
    file list (dataset.py:30-55)."""
    if isinstance(files, (list, tuple)):
        return sorted(files)
    if os.path.isdir(files):
        return find_files(files)
    if os.path.isfile(files):
        if files.endswith(".wav"):
            return [files]
        with open(files) as f:
            return [line.strip() for line in f if line.strip()]
    raise ValueError(f"{files} is not a valid file source")


def _utt_id(path: str) -> str:
    return os.path.splitext(os.path.basename(path))[0]


class SingleDataset:
    """The ``.wav`` files of ``files`` (a directory, a list or a file of
    paths), each loaded at ``sample_rate``."""

    def __init__(self, files, return_utt_id=False, subset_num=-1, sample_rate=None):
        self.return_utt_id = return_utt_id
        self.sample_rate = sample_rate
        self.filenames = _resolve_files(files)
        if subset_num > 0:
            self.filenames = self.filenames[:subset_num]
        self.utt_ids = [_utt_id(f) for f in self.filenames]

    def __len__(self):
        return len(self.filenames)

    def __getitem__(self, idx: int):
        data = load_audio(self.filenames[idx], self.sample_rate)
        if self.return_utt_id:
            return self.utt_ids[idx], data
        return data


class MultiDataset:
    """N parallel corpora of equal length (dataset.py:99-152); an item is
    the list of the N clips."""

    def __init__(self, multi_files, return_utt_id=False, subset_num=-1, sample_rate=None):
        self.return_utt_id = return_utt_id
        self.file_lists = [_resolve_files(f) for f in multi_files]
        if subset_num > 0:
            self.file_lists = [fl[:subset_num] for fl in self.file_lists]
        lengths = sorted({len(fl) for fl in self.file_lists})
        if len(lengths) != 1:
            raise ValueError(f"file lists have mismatched lengths {lengths}")
        self.sample_rate = sample_rate
        self.utt_ids = [_utt_id(f) for f in self.file_lists[0]]

    def __len__(self):
        return len(self.file_lists[0])

    def __getitem__(self, idx: int):
        items = [load_audio(fl[idx], self.sample_rate) for fl in self.file_lists]
        if self.return_utt_id:
            return self.utt_ids[idx], items
        return items


class Subset:
    """A dataset seen through a list of indices."""

    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.dataset[self.indices[i]]


def random_split(dataset, fractions, seed: int):
    """Seeded split into ``len(fractions)`` Subsets, the leakage-free 70/15/15
    of data_utils.py:38-51: floor of each fraction, the remainder dealt one
    at a time from the first split on, as ``torch.utils.data.random_split``
    deals it."""
    n = len(dataset)
    perm = np.random.default_rng(seed).permutation(n)
    sizes = [int(np.floor(f * n)) for f in fractions]
    for i in range(n - sum(sizes)):
        sizes[i % len(sizes)] += 1
    out, ofs = [], 0
    for s in sizes:
        out.append(Subset(dataset, perm[ofs:ofs + s]))
        ofs += s
    return out
