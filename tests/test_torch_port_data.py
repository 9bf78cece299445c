"""The port's data pipeline against the JAX package's on the CPU: the same
seeded wav tree (written with the port's ``write_wav``) and seeds through
both packages' ``AudioDataset`` / ``SingleDataset`` / ``MultiDataset``,
collaters, ``DataLoader`` and ``get_dataloaders`` give bit-equal batches in
the same order (both packages' collaters crop through the native library
where it is built); ``random_split`` has the same membership;
an exception in the dataset reaches the consumer; ``prefetch_to_device`` on
the CPU hands the batches on unchanged."""

import os

import numpy as np
import pytest

from dl_speech_enhancement_tpu import data as jdata
from dl_speech_enhancement_tpu.data import loader as jloader
from dl_speech_enhancement_tpu_torch import data
from dl_speech_enhancement_tpu_torch.data import loader
from dl_speech_enhancement_tpu_torch.data.dataset import load_files

SR = 4800


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """clean/ and noisy/ of 13 clips of 0.3-1.1 s (some under a crop's
    length), a nested level under clean/, one at 8 kHz (resampled on load),
    and a stereo clip."""
    root = tmp_path_factory.mktemp("port_data")
    rng = np.random.default_rng(3)
    for sub in ("clean", "noisy", os.path.join("clean", "spk1")):
        os.makedirs(root / sub, exist_ok=True)
    for i in range(13):
        n = int(SR * rng.uniform(0.3, 1.1))
        x = (0.3 * rng.standard_normal(n)).astype(np.float32)
        data.write_wav(str(root / "clean" / f"utt{i:02d}.wav"), x, SR)
        noise = (0.05 * rng.standard_normal(n)).astype(np.float32)
        data.write_wav(str(root / "noisy" / f"utt{i:02d}.wav"), x + noise, SR)
    for i in range(3):
        data.write_wav(str(root / "clean" / "spk1" / f"deep{i}.wav"),
                       (0.2 * rng.standard_normal(SR)).astype(np.float32), SR)
    data.write_wav(str(root / "clean" / "spk1" / "rate8k.wav"),
                   (0.2 * rng.standard_normal(8000)).astype(np.float32), 8000)
    data.write_wav(str(root / "stereo.wav"),
                   (0.2 * rng.standard_normal((SR, 2))).astype(np.float32), SR)
    return root


def _equal_batches(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        if isinstance(x, tuple):
            assert isinstance(y, tuple) and len(x) == len(y)
            for u, v in zip(x, y):
                assert u.dtype == v.dtype == np.float32
                np.testing.assert_array_equal(u, v)
        else:
            assert x.dtype == y.dtype == np.float32
            np.testing.assert_array_equal(x, y)
    return len(a)


def test_find_files_and_load_files(tree):
    assert data.find_files(str(tree)) == jdata.find_files(str(tree))
    assert (data.find_files(str(tree), include_root_dir=False)
            == jdata.find_files(str(tree), include_root_dir=False))
    from dl_speech_enhancement_tpu.data.dataset import load_files as jload_files
    assert load_files(str(tree), num_core=3) == jload_files(str(tree), num_core=3)


@pytest.mark.parametrize("source", ["dir", "list", "scp", "wav"])
def test_single_dataset(tree, source, tmp_path):
    clean = str(tree / "clean")
    files = {"dir": clean, "list": data.find_files(clean)[::-1],
             "wav": str(tree / "stereo.wav")}
    if source == "scp":
        scp = tmp_path / "files.scp"
        scp.write_text("\n".join(data.find_files(clean)[:5]) + "\n\n")
        files["scp"] = str(scp)
    mine = data.SingleDataset(files[source], return_utt_id=True, subset_num=7,
                              sample_rate=SR)
    ref = jdata.SingleDataset(files[source], return_utt_id=True, subset_num=7, sample_rate=SR)
    assert len(mine) == len(ref) and mine.utt_ids == ref.utt_ids
    for i in range(len(ref)):
        (u, a), (v, b) = mine[i], ref[i]
        assert u == v
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        data.SingleDataset(str(tree / "absent"))


def test_multi_dataset_and_audio_dataset(tree):
    dirs = [str(tree / "noisy"), str(tree / "clean" / "..")]
    mine = data.MultiDataset([str(tree / "noisy"), data.find_files(str(tree / "noisy"))],
                             return_utt_id=True, sample_rate=SR)
    ref = jdata.MultiDataset([str(tree / "noisy"), jdata.find_files(str(tree / "noisy"))],
                             return_utt_id=True, sample_rate=SR)
    assert len(mine) == len(ref) == 13
    for i in range(len(ref)):
        (u, a), (v, b) = mine[i], ref[i]
        assert u == v
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError, match="mismatched"):
        data.MultiDataset(dirs)
    a = data.AudioDataset(str(tree / "clean"), "clean", SR)
    b = jdata.AudioDataset(str(tree / "clean"), "clean", SR)
    assert a.audio_file_names == b.audio_file_names and len(a) == 17
    for i in range(len(b)):
        np.testing.assert_array_equal(a[i], b[i])


def test_random_split_membership():
    for n, fractions, seed in ((17, [0.7, 0.15, 0.15], 82), (10, [0.5, 0.5], 1),
                               (7, [0.3, 0.3, 0.3], 5)):
        mine = data.random_split(list(range(n)), fractions, seed)
        ref = jdata.random_split(list(range(n)), fractions, seed)
        assert [s.indices for s in mine] == [list(s.indices) for s in ref]
        assert sum(len(s) for s in mine) == n
    # torch's rule: the remainder goes round-robin from the first split
    assert [len(s) for s in data.random_split(list(range(7)), [0.3, 0.3, 0.3], 0)] == [3, 2, 2]


@pytest.mark.parametrize("pair", [False, True], ids=["single", "pair"])
def test_collaters_crop_the_same_bits(tree, pair):
    clips = [data.load_audio(f, SR) for f in data.find_files(str(tree / "clean"))]
    if pair:
        noisy = [c + 0.01 for c in clips]
        items = list(zip(clips, noisy))
        mine = data.CollaterAudioPair(2400, rng=np.random.default_rng(4))
        ref = jdata.CollaterAudioPair(2400, rng=np.random.default_rng(4))
        (a_n, a_x), (b_n, b_x) = mine(items), ref(items)
        np.testing.assert_array_equal(a_n, b_n)
        np.testing.assert_array_equal(a_x, b_x)
        np.testing.assert_allclose(a_n, a_x + 0.01, atol=1e-6)  # (second, first) of an item
        return
    mine = data.CollaterAudio(2400, rng=np.random.default_rng(4))
    ref = jdata.CollaterAudio(2400, rng=np.random.default_rng(4))
    for _ in range(3):
        a, b = mine(clips), ref(clips)
        assert a.shape[1:] == (2400, 1)
        np.testing.assert_array_equal(a, b)
    assert mine([clips[0][:100]]) is None


@pytest.mark.parametrize("pair", [False, True], ids=["single", "pair"])
def test_data_loader_batches_bit_equal(tree, pair):
    def loader_of(pkg):
        if pair:
            clean = [f for f in data.find_files(str(tree / "clean")) if "spk1" not in f]
            ds = pkg.MultiDataset([clean, str(tree / "noisy")], sample_rate=SR)
            coll = pkg.CollaterAudioPair(1800, rng=np.random.default_rng(9))
            return pkg.DataLoader(ds, 4, lambda items: coll([tuple(i) for i in items]), seed=2)
        ds = pkg.SingleDataset(str(tree / "clean"), sample_rate=SR)
        return pkg.DataLoader(ds, 3, pkg.CollaterAudio(1800, rng=np.random.default_rng(9)),
                              seed=2)

    mine, ref = loader_of(data), loader_of(jdata)
    assert len(mine) == len(ref)
    for _ in range(2):  # two epochs: the shuffle and the crops carry on
        _equal_batches(mine, ref)


def test_get_dataloaders_bit_equal(tree):
    ds_mine = data.AudioDataset(str(tree / "clean"), "clean", SR)
    ds_ref = jdata.AudioDataset(str(tree / "clean"), "clean", SR)
    mine = data.get_dataloaders(ds_mine, None, batch_size=2, batch_length=1200, seed=82)
    ref = jdata.get_dataloaders(ds_ref, None, batch_size=2, batch_length=1200, seed=82)
    assert [len(m) for m in mine] == [len(r) for r in ref] == [6, 1, 1]
    for m, r in zip(mine, ref):
        assert m.dataset.indices == list(r.dataset.indices)
        _equal_batches(m, r)
    pairs = data.create_dataloader(data.MultiDataset([str(tree / "clean")] * 2), 2, 1200, 3,
                                   pair=True)
    ref_pairs = jloader.create_dataloader(jdata.MultiDataset([str(tree / "clean")] * 2), 2,
                                          1200, 3, pair=True)
    assert _equal_batches(pairs, ref_pairs) == 8


def test_a_worker_exception_reaches_the_consumer():
    class Broken:
        def __len__(self):
            return 8

        def __getitem__(self, i):
            if i == 5:
                raise OSError("unreadable clip 5")
            return np.zeros((3000, 1), np.float32)

    dl = data.DataLoader(Broken(), 2, data.CollaterAudio(1200), shuffle=False)
    got = []
    with pytest.raises(OSError, match="unreadable clip 5"):
        for batch in dl:
            got.append(batch)
    assert len(got) == 2


def test_an_abandoned_iterator_stops_its_thread():
    import threading

    before = threading.active_count()
    dl = data.DataLoader([np.zeros((3000, 1), np.float32)] * 40, 2, data.CollaterAudio(1200))
    it = iter(dl)
    next(it)
    it.close()
    for _ in range(50):
        if threading.active_count() <= before:
            break
        threading.Event().wait(0.1)
    assert threading.active_count() <= before


def test_prefetch_to_device_on_the_cpu_is_the_identity():
    batches = [np.ones((2, 8, 1), np.float32), (np.zeros((2, 8, 1), np.float32),) * 2]
    out = list(loader.prefetch_to_device(iter(batches), size=2, device="cpu"))
    assert len(out) == 2 and out[0] is batches[0] and out[1] is batches[1]
