"""The port's scoring CLIs against the JAX package's (CPU):
cli/testing_denoise.py, cli/test.py, cli/analyze.py and cli/dnsmos.py.

Small models (the symAD codec and the denoiser cut to 8 channels, a paired
MGC vocoder), seeded params numpy-drawn in the JAX init's tree and carried
across with utils/jax_params.py, a seeded 4.8 kHz corpus written with the
port's ``write_wav``; the port's CLIs run through ``main`` with ``--device
cpu`` from port checkpoints, the JAX package's through the same functions
its ``main`` calls. Tolerances: the wavs have the same names, and samples
within 2e-5 plus one PCM16 step (both sides write PCM16); the metric battery
as tests/test_torch_port_eval.py holds it (STOI / ESTOI / SDR 1e-10, SNR /
SI-SDR 1e-4 dB, Mel-L1 rtol 1e-5), and its printed (rounded) values equal;
DNSMOS rows within 1e-4, on the stand-in graphs.
"""

import csv
import glob
import os

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from dl_speech_enhancement_tpu import data as jdata
from dl_speech_enhancement_tpu.cli import analyze as jax_analyze
from dl_speech_enhancement_tpu.cli import dnsmos as jax_dnsmos
from dl_speech_enhancement_tpu.cli import test as jax_test
from dl_speech_enhancement_tpu.cli import testing_denoise as jax_testing
from dl_speech_enhancement_tpu.eval import metrics as jmetrics
from dl_speech_enhancement_tpu.models import AudioDecGenerator as JaxCodec
from dl_speech_enhancement_tpu.train.checkpoint import save_checkpoint as jax_save
from dl_speech_enhancement_tpu_torch.cli import analyze, dnsmos, test, testing_denoise
from dl_speech_enhancement_tpu_torch.data import read_wav, write_wav
from dl_speech_enhancement_tpu_torch.models import AudioDecGenerator
from dl_speech_enhancement_tpu_torch.train.checkpoint import save_checkpoint
from dl_speech_enhancement_tpu_torch.utils.jax_params import from_jax_params
from chip_smoke import dnsmos_standins
from test_torch_port_hifigan import seeded_init
from test_torch_port_vocoder import CODEC_SMALL, VOC_PAIRED, _codecs, _vocoders

from conftest import SMALL_TOPOLOGY as SMALL
from torch_port_threads import one_thread  # noqa: F401

SR = 4800
ATOL = 2e-5
PCM16_STEP = 1.0 / 32768
N_CLIPS = 27  # the seeded 70/15/15 split leaves 4 test clips: one LAPTOP batch


def _yaml(d: dict) -> dict:
    return yaml.safe_load(yaml.safe_dump(
        {k: [list(v) if isinstance(v, tuple) else v for v in val]
         if isinstance(val, tuple) and val and isinstance(val[0], tuple)
         else list(val) if isinstance(val, tuple) else val for k, val in d.items()}))


@pytest.fixture(scope="module")
def zoo(tmp_path_factory):
    """The corpus, the models in both packages and the port's checkpoints."""
    root = tmp_path_factory.mktemp("cli_eval")
    rng = np.random.default_rng(21)
    for kind in ("clean", "noise"):
        os.makedirs(root / kind)
        for i in range(N_CLIPS):
            x = 0.3 * rng.standard_normal(int(SR * rng.uniform(1.1, 1.6)))
            write_wav(str(root / kind / f"{kind}{i:02d}.wav"), x.astype(np.float32), SR)

    jflag = JaxCodec(use_pqc=False, **SMALL)
    fparams, _ = seeded_init(jflag, 5)
    tflag = from_jax_params(AudioDecGenerator(use_pqc=False, device="cpu", **SMALL), fparams)
    jc, cparams, vq, tc, tvq = _codecs(CODEC_SMALL, 6)
    jv, vparams, tv = _vocoders(VOC_PAIRED, 7)

    course = {"sample_rate": SR, "seed": 0, "batch_size": 16,
              "generator_params": _yaml(SMALL)}
    os.makedirs(root / "configs")
    (root / "configs" / "tiny.yaml").write_text(yaml.safe_dump(course))
    codec_cfg = {"sampling_rate": SR, "model_type": "symAudioDec",
                 "generator_params": _yaml(CODEC_SMALL)}
    voc_cfg = {"sampling_rate": SR, "model_type": "HiFiGAN", "train_mode": "vocoder",
               "generator_params": _yaml(VOC_PAIRED)}
    ckpts = {"flag": str(root / "flag" / "checkpoint-1"),
             "codec": str(root / "codec" / "checkpoint-1"),
             "voc": str(root / "voc" / "checkpoint-1"),
             "jax_codec": str(root / "jax_codec" / "checkpoint-1")}
    save_checkpoint(ckpts["flag"], {"params_generator": tflag.state_dict()}, course)
    save_checkpoint(ckpts["codec"], {"params_generator": tc.state_dict(), "vq_state": tvq},
                    codec_cfg)
    save_checkpoint(ckpts["voc"], {"params_generator": tv.state_dict()}, voc_cfg)
    jax_save(ckpts["jax_codec"], {"params_generator": cparams, "vq_state": vq}, codec_cfg)
    with open(os.path.join(os.path.dirname(ckpts["jax_codec"]), "config.yml"), "w") as f:
        yaml.safe_dump(codec_cfg, f)

    @jax.jit
    def flag_infer(x):
        return jflag(fparams, None, x, train=False)[0]

    @jax.jit
    def ad_infer(x):
        z = jc.projector(cparams["projector"], jc.encoder(cparams["encoder"], x))
        return jv(vparams, jc.quantizer.inference(vq, z)[0])

    return {"root": root, "ckpts": ckpts,
            "jax_models": {"flag": (flag_infer, jflag.hop), "AD": (ad_infer, jc.hop)}}


def _wavs(d) -> dict:
    return {os.path.relpath(p, d): read_wav(p)[0]
            for p in sorted(glob.glob(os.path.join(d, "**", "*.wav"), recursive=True))}


def _same_wavs(got_dir, want_dir, atol=ATOL + PCM16_STEP):
    got, want = _wavs(got_dir), _wavs(want_dir)
    assert list(got) == list(want) and got
    for name in want:
        assert got[name].shape == want[name].shape, name
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=atol, err_msg=name)
    return list(got)


@pytest.fixture(scope="module")
def split_dump(zoo):
    """The port's cli.testing_denoise main and the JAX infer_split on the
    JAX loaders of the same corpus, split and seed."""
    root, ckpts = zoo["root"], zoo["ckpts"]
    port_out, jax_out = str(root / "port_out"), str(root / "jax_out")
    counters = testing_denoise.main([
        "-e", "LAPTOP", "-c", "tiny.yaml", "--config-dir", str(root / "configs"),
        "--clean-path", str(root / "clean"), "--noise-path", str(root / "noise"),
        "--flagship", f"flag={ckpts['flag']}", "--vocoder", f"{ckpts['voc']}:{ckpts['codec']}",
        "--out-dir", port_out, "--device", "cpu"])
    loaders = []
    for kind in ("clean", "noise"):
        ds = jdata.AudioDataset(str(root / kind), kind, SR)
        loaders.append(jdata.get_dataloaders(ds, [0.7, 0.15, 0.15], 4, SR, 0)[2])
    jax_counters = jax_testing.infer_split(zoo["jax_models"], *loaders, jax_out, SR,
                                           np.random.default_rng(0), laptop=True)
    return counters, jax_counters, port_out, jax_out


def test_testing_denoise_matches_jax(split_dump):
    counters, jax_counters, port_out, jax_out = split_dump
    assert counters == jax_counters == {"flag": 4, "AD": 4}
    names = _same_wavs(port_out, jax_out)
    assert {n.split(os.sep)[0] for n in names} == {"flag", "AD", "noisy", "clean"}


def test_codec_test_matches_jax(zoo, tmp_path):
    rng = np.random.default_rng(22)
    wav_dir = tmp_path / "in"
    for i, n in enumerate((1000, 1501, 7)):  # the last under one hop: skipped
        write_wav(str(wav_dir / f"utt{i}.wav"), (0.3 * rng.standard_normal(n)).astype(
            np.float32), SR)
    result = test.main(["--encoder", zoo["ckpts"]["codec"], "--input", str(wav_dir),
                        "--output", str(tmp_path / "port"), "--device", "cpu"])
    assert set(result["rtf"]) == {"utt0", "utt1"}
    assert result["mean_rtf"] == pytest.approx(np.mean(list(result["rtf"].values())))
    jax_test.run_codec_test(zoo["ckpts"]["jax_codec"], str(wav_dir), str(tmp_path / "jax"))
    assert _same_wavs(str(tmp_path / "port"), str(tmp_path / "jax")) == [
        "utt0_output.wav", "utt1_output.wav"]


def test_codec_forward_is_the_offline_codec(zoo, rng):
    """cli.test's forward: the projector's output, the codes and the audio
    of the JAX codec's encode, project, quantize and decode."""
    jc, cparams, vq, tc, tvq = _codecs(CODEC_SMALL, 6)
    x = (0.3 * rng.standard_normal((1, 240, 1))).astype(np.float32)
    y, z, codes = test.codec_forward(tc, tvq, torch.from_numpy(x))
    jz = jc.projector(cparams["projector"], jc.encoder(cparams["encoder"], jnp.asarray(x)))
    jzq, jcodes = jc.quantizer.inference(vq, jz)
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), rtol=0, atol=ATOL)
    assert np.array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_allclose(y.numpy(), np.asarray(jc.decoder(cparams["decoder"], jzq)),
                               rtol=0, atol=ATOL)


def _same_printed(got: dict, want: dict):
    """Printed (rounded) batteries: the same keys, each value within one unit
    of its last printed decimal (the unrounded values are held to the metric
    tolerances; a value at a rounding boundary may round either way)."""
    assert list(got) == list(want)
    for name, battery in want.items():
        assert list(got[name]) == list(battery), name
        for k, v in battery.items():
            assert abs(got[name][k] - v) <= 10.0 ** -analyze.DIGITS[k] + 1e-12, (name, k)


def test_analyze_eval_wavs_matches_jax(split_dump, capsys):
    _, _, port_out, _ = split_dump
    clean = os.path.join(port_out, "clean", "test-0.wav")
    wavs = [os.path.join(port_out, m, "test-0.wav") for m in ("flag", "AD", "noisy")]
    got = analyze.main(["--clean", clean, "--eval-wavs", *wavs, "--device", "cpu"])
    assert '"STOI"' in capsys.readouterr().out
    _same_printed(got, jax_analyze.eval_wavs(clean, wavs))
    unrounded = analyze.eval_wavs(clean, wavs, device="cpu")
    ref = read_wav(clean)[0][:, 0]
    for path in wavs:
        x = read_wav(path)[0][:, 0]
        t = min(len(x), len(ref))
        x, c = x[:t], ref[:t]
        b = unrounded[path]
        assert abs(b["STOI"] - jmetrics.stoi(c, x, SR)) <= 1e-10
        assert abs(b["ESTOI"] - jmetrics.stoi(c, x, SR, extended=True)) <= 1e-10
        assert abs(b["SDR"] - jmetrics.sdr(x, c)) <= 1e-10
        jx, jc = jnp.asarray(x[None]), jnp.asarray(c[None])
        assert abs(b["SI-SDR"] - float(jmetrics.scale_invariant_sdr(jx, jc))) <= 1e-4
        assert abs(b["SNR"] - float(jmetrics.signal_noise_ratio(jx, jc))) <= 1e-4
        assert b["Mel-L1"] == pytest.approx(jmetrics.mel_l1(x, c, SR), rel=1e-5)


def test_analyze_model_mode(zoo, tmp_path):
    """Mix, denoise with the flagship checkpoint, score: the denoised wav
    and the battery of the JAX forward on the same mix."""
    root = zoo["root"]
    clean, noise = str(root / "clean" / "clean00.wav"), str(root / "noise" / "noise00.wav")
    out = tmp_path / "analysis"
    got = analyze.main(["--checkpoint", zoo["ckpts"]["flag"], "--without-pqc", "--clean", clean,
                        "--noise", noise, "--snr", "12", "--out-dir", str(out),
                        "--device", "cpu"])
    c, n = read_wav(clean)[0][:, :1], read_wav(noise)[0][:, :1]
    t = (min(len(c), len(n)) // 12) * 12
    mixed = jdata.add_noise(c[:t], n[:t], 12.0)
    pred = np.asarray(zoo["jax_models"]["flag"][0](jnp.asarray(mixed[None], jnp.float32)))[0]
    np.testing.assert_allclose(read_wav(str(out / "denoised.wav"))[0], pred, rtol=0,
                               atol=ATOL + PCM16_STEP)
    battery = jax_analyze.metric_battery
    _same_printed(got, {"mixed_vs_clean": battery(mixed[:, 0], c[:t, 0], SR),
                        "denoised_vs_clean": battery(pred[:, 0], c[:t, 0], SR)})


def test_scoring_defaults_to_the_card(tmp_path, monkeypatch):
    """The battery and ``eval_wavs`` run on the card unless told ``"cpu"``;
    ``cli.test`` takes one checkpoint and refuses a separate ``--decoder``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.zeros(SR, np.float32)
    with pytest.raises(RuntimeError, match="device 'cuda'"):
        analyze.metric_battery(x, x, SR)
    with pytest.raises(RuntimeError, match="device 'cuda'"):
        analyze.eval_wavs(str(tmp_path / "clean.wav"), [str(tmp_path / "a.wav")])
    with pytest.raises(SystemExit):
        test.main(["--encoder", "enc", "--decoder", "dec", "--input", str(tmp_path)])


def test_save_plots_needs_matplotlib(tmp_path, monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_matplotlib(name, *args, **kwargs):
        if name.startswith("matplotlib"):
            raise ImportError("No module named 'matplotlib'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    with pytest.raises(ImportError, match="needs matplotlib"):
        analyze.save_plots(str(tmp_path), SR, {"x": np.zeros(SR, np.float32)})


def test_dnsmos_cli_matches_jax(split_dump, tmp_path, capsys):
    _, _, port_out, _ = split_dump
    dnsmos_standins(str(tmp_path))
    rows = dnsmos.main(["-t", port_out, "-o", str(tmp_path / "port.csv"), "--model-dir",
                        str(tmp_path), "--device", "cpu"])
    printed = capsys.readouterr().out
    df = jax_dnsmos.main(["-t", port_out, "-o", str(tmp_path / "jax.csv"), "--model-dir",
                          str(tmp_path)])
    want = df.to_dict("records")
    assert len(rows) == len(want) == 16
    for got, ref in zip(rows, want):
        assert list(got) == list(ref)
        for k, v in ref.items():
            if isinstance(v, float):
                assert abs(got[k] - v) <= 1e-4, k
            else:
                assert got[k] == v, k
    for model, means in dnsmos.model_means(rows).items():
        assert f"== {model} (n=4)" in printed
        ref = df[df["model"] == model][list(dnsmos.MEAN_KEYS)].mean()
        for k in dnsmos.MEAN_KEYS:
            assert abs(means[k] - ref[k]) <= 1e-4
    with open(tmp_path / "port.csv") as f, open(tmp_path / "jax.csv") as g:
        port_csv, jax_csv = list(csv.reader(f)), list(csv.reader(g))
    assert port_csv[0] == jax_csv[0] and len(port_csv) == len(jax_csv)
    assert [r[1] for r in port_csv] == [r[1] for r in jax_csv]  # the filenames


def test_dnsmos_cli_skips_a_clip_that_fails(tmp_path, capsys):
    d = tmp_path / "set" / "m"
    os.makedirs(d)
    write_wav(str(d / "good.wav"), np.zeros(16000, np.float32) + 0.01, 16000)
    (d / "bad.wav").write_bytes(b"not a wav")
    dnsmos_standins(str(tmp_path))
    rows = dnsmos.main(["-t", str(tmp_path / "set"), "--model-dir", str(tmp_path),
                        "--device", "cpu"])
    assert [os.path.basename(r["filename"]) for r in rows] == ["good.wav"]
    assert "bad.wav' generated an exception" in capsys.readouterr().out
