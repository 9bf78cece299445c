"""The port's AudioDec training recipe through its CLIs, on the CPU
(``--device cpu``), on a tiny seeded wav corpus written with the port's
``write_wav``: the codec (``cli.train``, autoencoder, with the adversarial
phase 2), its statistics (``cli.statistic``), a vocoder on the frozen
analyzer with those statistics, the denoise fine-tune from the codec
(``initial``), a bare ``--resume`` (and one with nothing to resume), the
course CLI (``cli.train_denoise -e LAPTOP``) with and without
``initial_model``, the course loop's warm start, and both training CLIs'
``--dp 2`` over two gloo ranks against ``--dp 1``. The topology is
tests/test_cli.py's (``TINY_GEN``, ``TINY_DISC``, ``MEL_TINY``, 4.8 kHz).
Without a card, every entry point refuses ``--device cuda`` (the default).
"""

import os

import numpy as np
import pytest
import torch
import yaml

from dl_speech_enhancement_tpu_torch.cli import statistic as stat_cli
from dl_speech_enhancement_tpu_torch.cli import train as train_cli
from dl_speech_enhancement_tpu_torch.cli import train_denoise as course_cli
from dl_speech_enhancement_tpu_torch.data import load_audio, write_wav
from dl_speech_enhancement_tpu_torch.models import AudioDecGenerator
from dl_speech_enhancement_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from dl_speech_enhancement_tpu_torch.train.denoise_course import train_denoise_course
from test_cli import MEL_TINY, SR, TINY_DISC, TINY_GEN, _base_config
from torch_port_threads import one_thread  # noqa: F401

CPU = ["--device", "cpu"]
LR = 1e-3  # _base_config's learning rates
VOC_GEN = {"in_channels": 16, "out_channels": 1, "channels": 32, "kernel_size": 7,
           "upsample_scales": [4, 3], "upsample_kernel_sizes": [8, 6],
           "resblock_kernel_sizes": [3], "resblock_dilations": [[1, 3]], "groups": 1,
           "bias": True, "use_additional_convs": True, "use_weight_norm": True,
           "nonlinear_activation": "LeakyReLU",
           "nonlinear_activation_params": {"negative_slope": 0.1}}
COURSE = {"sample_rate": SR, "initial_model": "", "step": 0, "experiment_name": "tiny-course",
          "epochs": 1, "epoch_to_enable_discriminator": 0, "noise_dropout_rate": 0.5,
          "noise_dropout_rate_decay": 0.1, "epoch_to_enable_noise_dropout_decay": 0,
          "seed": 9, "lambda_snr_loss": 1.0, "generator_params": TINY_GEN,
          "discriminator_params": TINY_DISC, "mel_loss_params": MEL_TINY, "lambda_adv": 1.0,
          "lambda_feat_match": 2.0, "lambda_mel_loss": 45.0,
          "generator_adv_loss_params": {"average_by_discriminators": False},
          "discriminator_adv_loss_params": {"average_by_discriminators": False},
          "generator_optimizer_params": {"lr": 1e-3, "betas": [0.5, 0.9]},
          "discriminator_optimizer_params": {"lr": 1e-3, "betas": [0.5, 0.9]},
          "generator_grad_norm": -1, "discriminator_grad_norm": -1, "batch_size": 2}


def write_corpus(root, n=6, seconds=1.2):
    """tests/test_cli.py's corpus, written by the port: tones, and the noisy
    sets the same tones with seeded noise."""
    rng = np.random.default_rng(11)
    t = np.arange(int(SR * seconds)) / SR
    for sub in ("clean_train", "clean_valid", "noisy_train", "noisy_valid"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        for i in range(n):
            x = 0.4 * np.sin(2 * np.pi * (200 + 50 * i) * t)
            if sub.startswith("noisy"):
                x = x + 0.1 * rng.standard_normal(len(t))
            write_wav(os.path.join(root, sub, f"utt{i}.wav"), x.astype(np.float32), SR)


def _write_config(path, cfg) -> str:
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(path)


def _exp(root, mode, tag):
    return os.path.join(str(root), "exp", mode, tag)


def _stored(path, key):
    return load_checkpoint(path)[key]


def _same(a: dict, b: dict, prefix=""):
    return all(torch.equal(a[k], b[k]) for k in a if k.startswith(prefix))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_cli")
    write_corpus(os.path.join(root, "corpus"))
    return root


@pytest.fixture(scope="module")
def codec(corpus):
    """The codec trained by ``cli.train``: 2 metric steps at 2400 samples,
    then the adversarial phase on loaders rebuilt at 1200 to step 4, one
    eval pass at step 4."""
    cfg = dict(_base_config(corpus, "autoencoder"), train_max_steps=2, adv_train_max_steps=4,
               adv_batch_length=1200, start_steps={"generator": 0, "discriminator": 2},
               eval_interval_steps=4, log_interval_steps=2)
    cwd = os.getcwd()
    os.chdir(corpus)
    try:
        trainer = train_cli.main(["-c", _write_config(corpus / "ae.yaml", cfg), "--tag", "tiny",
                                  *CPU])
    finally:
        os.chdir(cwd)
    return trainer, os.path.join(_exp(corpus, "autoencoder", "tiny"), "checkpoint-4steps")


def test_autoencoder_cli_runs_both_phases(codec, corpus):
    trainer, ckpt = codec
    assert trainer.steps == 4 and os.path.isdir(ckpt)
    saved = yaml.safe_load(open(os.path.join(_exp(corpus, "autoencoder", "tiny"),
                                             "config.yml")))
    assert saved["outdir"] == os.path.join("exp", "autoencoder", "tiny")
    assert trainer.data_loader["train"].collate_fn.batch_length == 1200
    state = load_checkpoint(ckpt)
    # 3 batches an epoch: both phases end inside their first epoch
    assert state["steps"] == 4 and state["epochs"] == 0
    assert set(state) == {"params_generator", "params_discriminator", "vq_state",
                          "opt_generator", "opt_discriminator", "steps", "epochs"}
    # the discriminator took 2 updates (steps 2 and 3); the decoder 4, the
    # encoder and the projector 2, frozen in phase 2
    adam = state["opt_discriminator"]["adam"]["state"]
    assert {int(v["step"]) for v in adam.values()} == {2}
    adam = state["opt_generator"]["adam"]["state"]
    for i, (name, _) in enumerate(trainer.gen.named_parameters()):
        assert int(adam[i]["step"]) == (4 if name.startswith("decoder.") else 2), name


def test_statistic_then_vocoder_then_denoise(codec, corpus, monkeypatch):
    monkeypatch.chdir(corpus)
    _, ckpt = codec
    stat_cfg = {"sampling_rate": SR, "data": _base_config(corpus, "autoencoder")["data"],
                "analyzer": ckpt, "stats": str(corpus / "stats" / "tiny.npy")}
    stats = stat_cli.main(["-c", _write_config(corpus / "stat.yaml", stat_cfg), *CPU])
    assert stats.shape == (2, 16) and np.all(np.isfinite(stats)) and np.all(stats[1] > 0)
    np.testing.assert_array_equal(np.load(stat_cfg["stats"]), stats)

    cfg = dict(_base_config(corpus, "vocoder"), model_type="HiFiGAN", analyzer=ckpt,
               generator_params=dict(VOC_GEN, stats=stat_cfg["stats"]),
               generator_train_start_steps=1, discriminator_train_start_steps=0,
               train_max_steps=3)
    voc = train_cli.main(["-c", _write_config(corpus / "voc.yaml", cfg), "--tag", "tiny_voc",
                          *CPU])
    voc_ckpt = os.path.join(_exp(corpus, "vocoder", "tiny_voc"), "checkpoint-3steps")
    state = load_checkpoint(voc_ckpt)
    assert state["steps"] == 3
    np.testing.assert_array_equal(state["params_generator"]["mean"].numpy(), stats[0])
    # the analyzer is the codec's, bit for bit; the strict gates: the
    # generator updated at step 2, the discriminator at steps 1 and 2
    assert _same(_stored(ckpt, "params_generator"), state["params_analyzer"])
    assert {int(v["step"]) for v in state["opt_generator"]["adam"]["state"].values()} == {1}
    assert {int(v["step"]) for v in state["opt_discriminator"]["adam"]["state"].values()} == {2}
    assert torch.equal(voc.vq_state.embed.cpu(), _stored(ckpt, "vq_state")["embed"])

    cfg = dict(_base_config(corpus, "denoise"), initial=ckpt, train_max_steps=3)
    dn = train_cli.main(["-c", _write_config(corpus / "dn.yaml", cfg), "--tag", "tiny_dn", *CPU])
    batch = next(iter(dn.data_loader["train"]))
    noisy, clean = batch
    assert noisy.shape == clean.shape == (2, 2400, 1)
    # (noisy, clean): the noisy crop is the clean one plus noise
    assert np.abs(noisy - clean).max() > 1e-2
    clean_energy = [np.sum(c ** 2) for c in clean]
    assert all(np.sum(n ** 2) > e for n, e in zip(noisy, clean_energy))
    state = load_checkpoint(os.path.join(_exp(corpus, "denoise", "tiny_dn"),
                                         "checkpoint-3steps"))
    initial = _stored(ckpt, "params_generator")
    assert _same(initial, state["params_generator"], "decoder.")
    assert not _same(initial, state["params_generator"], "encoder.")
    for f in ("embed", "cluster_size", "embed_avg"):
        assert torch.equal(state["vq_state"][f], _stored(ckpt, "vq_state")[f])


def test_bare_resume_picks_the_newest_checkpoint(codec, corpus, monkeypatch):
    monkeypatch.chdir(corpus)
    cfg = dict(_base_config(corpus, "autoencoder"), train_max_steps=6, adv_train_max_steps=4,
               adv_batch_length=1200, start_steps={"generator": 0, "discriminator": 2})
    loaded = []
    original = train_cli.build_trainer

    def spy(*args, **kwargs):
        trainer = original(*args, **kwargs)
        load = trainer.load_checkpoint
        trainer.load_checkpoint = lambda path: (load(path), loaded.append((path, trainer.steps)))
        return trainer

    monkeypatch.setattr(train_cli, "build_trainer", spy)
    trainer = train_cli.main(["-c", _write_config(corpus / "ae_resume.yaml", cfg), "--tag",
                              "tiny", "--resume", *CPU])
    assert loaded == [(os.path.join("exp", "autoencoder", "tiny", "checkpoint-4steps"), 4)]
    assert trainer.steps == 6
    assert load_checkpoint(os.path.join(_exp(corpus, "autoencoder", "tiny"),
                                        "checkpoint-6steps"))["steps"] == 6


def test_bare_resume_without_a_checkpoint_exits(corpus, monkeypatch):
    monkeypatch.chdir(corpus)
    cfg = _base_config(corpus, "autoencoder")
    with pytest.raises(SystemExit, match="no checkpoint found"):
        train_cli.main(["-c", _write_config(corpus / "ae_none.yaml", cfg), "--tag", "none",
                        "--resume", *CPU])


def _course_tree(corpus, job_dir, initial_model=""):
    cfg_dir = corpus / "configs" / "denoise"
    os.makedirs(cfg_dir, exist_ok=True)
    _write_config(cfg_dir / "tiny.yaml", dict(COURSE, initial_model=initial_model))
    return ["-e", "LAPTOP", "-c", "tiny.yaml", "--config-dir", str(cfg_dir),
            "--clean-path", str(corpus / "corpus" / "clean_train"),
            "--noise-path", str(corpus / "corpus" / "noisy_train"), "--job-dir", str(job_dir),
            *CPU]


def test_course_cli_laptop_with_and_without_initial_model(corpus, tmp_path, capsys):
    _, history = course_cli.main(_course_tree(corpus, tmp_path))
    assert len(history) == 1 and np.isfinite(history[0]["val_gen"])
    assert history[0]["train_dis"] != 0.0  # the discriminator from epoch 0

    warm = AudioDecGenerator(**TINY_GEN, use_pqc=False, seed=123, device="cpu")
    save_checkpoint(str(tmp_path / "warm"), {"params_generator": warm.state_dict()})
    seen = []
    original = course_cli.train_denoise_course

    def spy(config, gen, *args, **kwargs):
        seen.append(kwargs["initial_params"])
        return original(config, gen, *args, **kwargs)

    course_cli.train_denoise_course = spy
    try:
        state, _ = course_cli.main(_course_tree(corpus, tmp_path, initial_model="warm"))
        course_cli.main(_course_tree(corpus, tmp_path, initial_model="missing"))
    finally:
        course_cli.train_denoise_course = original
    assert _same(seen[0], warm.state_dict())
    assert state["steps"] == 1  # 5 of 6 clips in the train split: one batch of 4
    assert seen[1] is None and "No inital model" in capsys.readouterr().out


def test_course_loop_warm_starts_from_initial_params(rng):
    warm = AudioDecGenerator(**TINY_GEN, use_pqc=False, seed=7, device="cpu")
    gen = AudioDecGenerator(**TINY_GEN, use_pqc=False, seed=8, device="cpu")
    first = []
    gen.register_forward_pre_hook(
        lambda m, _: first.append({k: v.clone() for k, v in m.state_dict().items()})
        if not first else None)
    batches = ([rng.standard_normal((2, 2400, 1)).astype(np.float32) * 0.3],
               [rng.standard_normal((2, 2400, 1)).astype(np.float32) * 0.1])
    cfg = dict(COURSE, epoch_to_enable_discriminator=10)
    state, _ = train_denoise_course(cfg, gen, None, batches, batches, environment="LAPTOP",
                                    initial_params=warm.state_dict())
    assert state["steps"] == 1
    assert _same(first[0], warm.state_dict())


@pytest.mark.parametrize("entry", ["train", "statistic", "train_denoise"])
def test_entry_points_refuse_a_missing_card(entry, corpus, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(corpus)
    argv = {"train": ["-c", _write_config(corpus / "ae_card.yaml",
                                          _base_config(corpus, "autoencoder"))],
            "statistic": ["-c", str(corpus / "stat_card.yaml")],
            "train_denoise": _course_tree(corpus, corpus / "job_card")[:-2]}[entry]
    if entry == "statistic":
        _write_config(corpus / "stat_card.yaml", {"analyzer": "x", "stats": "x.npy"})
    main = {"train": train_cli, "statistic": stat_cli, "train_denoise": course_cli}[entry].main
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        main(argv)


def _spread_codec(corpus, cfg) -> str:
    """A step-0 checkpoint of the config's codec whose codebooks are scaled
    to its projector's output on a corpus clip. At the init's N(0, 1) books
    every frame of the tiny codec takes one codeword, its output repeats
    every hop, and the mel loss's gradient into the encoder is at f32's
    rounding floor, where two summation orders differ in sign and Adam moves
    either by lr (tests/test_torch_port_workloads.py::_codebooks)."""
    gen = AudioDecGenerator(**TINY_GEN, use_pqc=True, seed=cfg["seed"], device="cpu")
    vq = gen.quantizer.init(seed=cfg["seed"], device="cpu")
    clip = load_audio(str(corpus / "corpus" / "clean_train" / "utt0.wav")).reshape(1, -1, 1)
    with torch.no_grad():
        s = gen.projector(gen.encoder(torch.from_numpy(clip.astype(np.float32)))).std()
    path = str(corpus / "spread" / "checkpoint-0steps")
    save_checkpoint(path, {"params_generator": gen.state_dict(),
                           "vq_state": type(vq)(vq.embed * s, vq.cluster_size, vq.embed_avg * s),
                           "steps": 0, "epochs": 0})
    return path


def test_data_parallel_cli_equals_one_process(corpus, monkeypatch):
    """``cli.train --dp 2 --device cpu`` spawns two gloo ranks on the host and
    takes the ``--dp 1`` run's steps (a stage-1 step with its EMA codebooks,
    then a stage-2 and discriminator step) from the same resumed codec; rank
    0 writes the checkpoint, in the one-process layout. The codebooks atol
    1e-5; the parameters atol 5e-5 (JAX's for its data parallelism,
    tests/test_parallel.py:91-95) but for at most one in a thousand elements
    a tensor, each within 2 lr an update: a gradient at f32's rounding floor
    takes either sign in two summation orders, and Adam's step moves it by
    lr either way."""
    monkeypatch.chdir(corpus)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    cfg = dict(_base_config(corpus, "autoencoder"), train_max_steps=2,
               start_steps={"generator": 0, "discriminator": 1})
    argv = ["-c", _write_config(corpus / "ae_dp.yaml", cfg), "--resume",
            _spread_codec(corpus, cfg), *CPU]
    one = train_cli.main([*argv, "--tag", "dp1", "--dp", "1"])
    ranks = train_cli.main([*argv, "--tag", "dp2", "--dp", "2"])
    assert one.steps == 2 and [r["steps"] for r in ranks] == [2, 2]
    got = load_checkpoint(os.path.join(_exp(corpus, "autoencoder", "dp2"), "checkpoint-2steps"))
    ref = load_checkpoint(os.path.join(_exp(corpus, "autoencoder", "dp1"), "checkpoint-2steps"))
    assert sorted(got) == sorted(ref) and got["steps"] == 2
    for key in ("params_generator", "params_discriminator"):
        assert sorted(got[key]) == sorted(ref[key])
        for k in ref[key]:
            diff = (got[key][k] - ref[key][k]).abs()
            assert diff.max() <= 2 * LR * 2, f"{key}.{k}"  # 2 updates at most
            assert (diff > 5e-5).float().mean() <= 1e-3, f"{key}.{k}"
    for k in ref["vq_state"]:
        np.testing.assert_allclose(got["vq_state"][k].numpy(), ref["vq_state"][k].numpy(),
                                   atol=1e-5, err_msg=k)


def test_data_parallel_course_cli_equals_one_process(corpus, tmp_path, monkeypatch):
    """``cli.train_denoise --dp 2 --device cpu``: the LAPTOP epoch of the
    course CLI over two ranks, its history the ``--dp 1`` run's."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    _, ref = course_cli.main([*_course_tree(corpus, tmp_path / "one"), "--dp", "1"])
    ranks = course_cli.main([*_course_tree(corpus, tmp_path / "two"), "--dp", "2"])
    assert [r["steps"] for r in ranks] == [1, 1]
    for got in (r["history"] for r in ranks):
        assert len(got) == len(ref) == 1 and got[0]["train_dis"] != 0.0
        for key in ("train_gen", "train_dis", "val_gen", "val_dis"):
            np.testing.assert_allclose(got[0][key], ref[0][key], rtol=2e-4, err_msg=key)
        for k in ref[0]["frags"]:
            np.testing.assert_allclose(got[0]["frags"][k], ref[0]["frags"][k], rtol=2e-4,
                                       err_msg=k)
