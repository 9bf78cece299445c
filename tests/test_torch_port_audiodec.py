"""The port's named-preset path on the CPU against the JAX package: the
preset table, checkpoints, ``load_pair``, ``AudioCodecStreamer``,
``cli.stream`` and the wav I/O.

Small topologies: the symAD codec cut to 8 channels (hop 12), an MRF
receiver (the v0 / v3 family: blocks of kernel 3 and 5) and an MGC one (v1)
with seeded statistics, params numpy-drawn in the JAX init's tree with
weight-norm ``g`` at about unit gain (tests/test_torch_port_vocoder.py).
Experiment trees are laid out as ``assign_model`` expects, one written by
the JAX package's ``save_checkpoint`` (orbax) and one by the port's (torch),
from the same params. Streaming compares the frames a streamer produced,
in order (underflow zeros fall where the threads' timing puts them), with a
``--max-latency`` no frame reaches. Tolerances: atol 2e-5 (f32, the JAX
package's own at small sizes), plus one PCM16 step where both sides wrote a
wav; the wav readers exactly.
"""

import os
import struct

import numpy as np
import pytest

import torch

from dl_speech_enhancement_tpu.cli import stream as jax_cli
from dl_speech_enhancement_tpu.data import audio_io as jax_io
from dl_speech_enhancement_tpu.stream import runtime as jrt
from dl_speech_enhancement_tpu.train.checkpoint import save_checkpoint as jax_save
from dl_speech_enhancement_tpu.utils.audiodec import assign_model as jax_assign_model
from dl_speech_enhancement_tpu_torch.cli import stream as port_cli
from dl_speech_enhancement_tpu_torch.data import audio_io
from dl_speech_enhancement_tpu_torch.models.hifigan import (
    MultiGroupConv1d,
    MultiReceptiveField,
)
from dl_speech_enhancement_tpu_torch.stream import runtime
from dl_speech_enhancement_tpu_torch.stream.runtime import (
    AudioCodecStreamer,
    StreamingReceiver,
    StreamingTransmitter,
    VocoderReceiver,
)
from dl_speech_enhancement_tpu_torch.train.checkpoint import (
    latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from dl_speech_enhancement_tpu_torch.utils import audiodec
from test_torch_port_hifigan import MRF
from test_torch_port_vocoder import CODEC_SMALL, VOC_PAIRED, _codecs, _jnp, _vocoders
from torch_port_threads import one_thread  # noqa: F401

ATOL = 2e-5
PCM16_STEP = 1.0 / 32768
SR = 48000
FRAME = 24  # two hops of the small codec
VOC_MRF = dict(MRF, in_channels=16, upsample_scales=(4, 3), upsample_kernel_sizes=(8, 6))
PRESETS = ["libritts_v1", "libritts_sym", "vctk_v0", "vctk_v1", "vctk_v2", "vctk_sym",
           "vctk_univ", "vctk_univ_sym", "vctk_denoise", "vctk_v3"]


def _yaml_params(p):
    return {k: [list(v) for v in val] if k == "resblock_dilations" else
            list(val) if isinstance(val, tuple) else val for k, val in p.items()}


def _vocoder_config(topology, model_type):
    gp = _yaml_params(topology)
    gp.update(nonlinear_activation="LeakyReLU",
              nonlinear_activation_params={"negative_slope": 0.1}, use_weight_norm=True,
              stats="stats/small.npy")
    return {"sampling_rate": SR, "model_type": model_type, "train_mode": "vocoder",
            "generator_params": gp}


@pytest.fixture(scope="module")
def models():
    """The small codec and the two receivers, in both packages."""
    stats = np.stack([np.random.default_rng(70).standard_normal(16),
                      np.random.default_rng(71).uniform(0.5, 2.0, 16)]).astype(np.float32)
    jc, cparams, cvq, tc, tvq = _codecs(CODEC_SMALL, seed=72)
    mrf = _vocoders(VOC_MRF, seed=73, stats=stats)
    mgc = _vocoders(VOC_PAIRED, seed=74, stats=stats)
    return {"stats": stats, "codec": (jc, cparams, cvq, tc, tvq), "mrf": mrf, "mgc": mgc}


def _write_tree(root, models, save, codec_state, voc_state):
    """An exp/ tree under ``root`` for the vctk_v0 / v1 / univ / sym presets
    (and the statistics file the vocoder configs name), written by ``save``."""
    os.makedirs(os.path.join(root, "stats"), exist_ok=True)
    np.save(os.path.join(root, "stats", "small.npy"), models["stats"])
    exp = os.path.join(root, "exp")
    for tag, model_type, steps in (("symAD_vctk_48000_hop300", "symAudioDec", 200000),
                                   ("symAD_vctk_48000_hop300", "symAudioDec", 500000),
                                   ("symADuniv_vctk_48000_hop300", "symAudioDecUniv", 500000)):
        config = {"sampling_rate": SR, "model_type": model_type, "train_mode": "autoencoder",
                  "generator_params": _yaml_params(CODEC_SMALL)}
        save(os.path.join(exp, "autoencoder", tag, f"checkpoint-{steps}steps"), codec_state,
             config)
    for tag, kind, model_type in (
            ("AudioDec_v0_symAD_vctk_48000_hop300_clean", "mrf", "HiFiGAN"),
            ("AudioDec_v1_symAD_vctk_48000_hop300_clean", "mgc", "HiFiGAN"),
            ("AudioDec_v3_symADuniv_vctk_48000_hop300_clean", "mrf", "UnivNet")):
        topology = VOC_MRF if kind == "mrf" else VOC_PAIRED
        save(os.path.join(exp, "vocoder", tag, "checkpoint-500000steps"), voc_state(kind),
             _vocoder_config(topology, model_type))
    return root


@pytest.fixture(scope="module")
def port_tree(tmp_path_factory, models):
    _, _, _, tc, tvq = models["codec"]
    return _write_tree(str(tmp_path_factory.mktemp("port")), models, save_checkpoint,
                       {"params_generator": tc.state_dict(), "vq_state": tvq},
                       lambda kind: {"params_generator": models[kind][2].state_dict()})


@pytest.fixture(scope="module")
def jax_tree(tmp_path_factory, models):
    _, cparams, cvq, _, _ = models["codec"]
    return _write_tree(str(tmp_path_factory.mktemp("jax")), models, jax_save,
                       {"params_generator": cparams, "vq_state": cvq},
                       lambda kind: {"params_generator": models[kind][1]})


def _produced(out, n_frames):
    """The frames a streamer produced, in order: its (B, T, 1) output cut in
    frames, the all-zero frames (underflow) left out; there must be
    ``n_frames`` of them."""
    frames = [out[:, i * FRAME:(i + 1) * FRAME] for i in range(out.shape[1] // FRAME)]
    got = [f for f in frames if np.abs(f).max() > 0]
    assert len(got) == n_frames, f"{len(got)} frames produced of {n_frames}"
    return np.concatenate(got, axis=1)


# ---------------------------------------------------------------- presets


@pytest.mark.parametrize("model", PRESETS)
def test_assign_model_matches_jax(model):
    assert audiodec.assign_model(model, "root") == jax_assign_model(model, "root")


def test_assign_model_refuses_an_unknown_name():
    with pytest.raises(NotImplementedError):
        jax_assign_model("vctk_v9")
    with pytest.raises(NotImplementedError):
        audiodec.assign_model("vctk_v9")


def test_checkpoint_round_trip(tmp_path, models):
    _, _, _, tc, tvq = models["codec"]
    out = tmp_path / "exp" / "run"
    state = {"params_generator": tc.state_dict(), "vq_state": tvq, "steps": 7}
    for steps in (3, 12):
        save_checkpoint(str(out / f"checkpoint-{steps}steps"), state, {"model_type": "x"})
    assert latest_checkpoint(str(out)) == str(out / "checkpoint-12steps")
    assert (out / "config.yml").exists()
    like = {"params_generator": tc.state_dict(), "vq_state": tvq}
    got = load_checkpoint(str(out / "checkpoint-12steps"), like=like)
    assert set(got) == {"params_generator", "vq_state"}  # a subtree: no "steps"
    assert type(got["vq_state"]) is type(tvq)
    for name, t in tc.state_dict().items():
        assert torch.equal(got["params_generator"][name], t), name
    for a, b in zip(got["vq_state"], tvq):
        assert torch.equal(a, b)
    assert load_checkpoint(str(out / "checkpoint-3steps"))["steps"] == 7
    bad = {"params_generator": {k: torch.zeros(1) for k in tc.state_dict()}}
    with pytest.raises(ValueError, match="does not fit"):
        load_checkpoint(str(out / "checkpoint-12steps"), like=bad)


@pytest.mark.parametrize("model,receiver,block", [
    ("vctk_v0", VocoderReceiver, MultiReceptiveField),
    ("vctk_univ", VocoderReceiver, MultiReceptiveField),
    ("vctk_v1", VocoderReceiver, MultiGroupConv1d),
    ("vctk_sym", StreamingReceiver, None),
])
def test_load_pair_builds_the_preset_endpoints(monkeypatch, port_tree, models, model,
                                               receiver, block):
    _, _, _, tc, tvq = models["codec"]
    monkeypatch.chdir(port_tree)  # the vocoder configs name their statistics from there
    tx, rx, sr = audiodec.load_pair(model, batch=2, device="cpu")
    assert sr == SR and isinstance(tx, StreamingTransmitter) and type(rx) is receiver
    for name, t in tc.state_dict().items():
        assert torch.equal(tx.gen.state_dict()[name], t), name
    assert all(torch.equal(a, b) for a, b in zip(tx.vq_state, tvq))
    if block is not None:
        want = models["mrf" if block is MultiReceptiveField else "mgc"][2]
        assert isinstance(rx.vocoder.blocks[0], block)
        assert rx.backend == "eager"  # 'auto' on the CPU
        for name, t in want.state_dict().items():
            assert torch.equal(rx.vocoder.state_dict()[name], t), name
    chunk = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 2 * tc.hop, 1)).astype(np.float32))
    assert tuple(rx.decode(tx.encode(chunk)).shape) == (2, 2 * tc.hop, 1)


@pytest.mark.parametrize("endpoint", [StreamingTransmitter, StreamingReceiver])
def test_codec_endpoint_routes(models, endpoint):
    """'auto' takes the plain modules on the CPU; 'cuda' raises there, and
    'cuda_chain' (the denoiser's stream) anywhere."""
    _, _, _, tc, tvq = models["codec"]
    assert endpoint(tc, tvq, device="cpu").backend == "eager"
    for backend in ("cuda", "cuda_chain"):
        with pytest.raises(ValueError, match=backend):
            endpoint(tc, tvq, backend=backend, device="cpu")


@pytest.mark.parametrize("batch", [1, 2])
def test_codec_endpoints_kernel_route_matches_jax(monkeypatch, rng, models, batch):
    """The endpoints' kernel route (the whole-model stream's encoder and
    decoder halves), let through on the CPU, where each kernel's wrapper
    runs its plain version: priming and three chunks with carried caches
    give JAX's codes and, at f32 weights, its audio within ATOL."""
    jc, cparams, cvq, tc, tvq = models["codec"]
    monkeypatch.setattr(runtime, "_endpoint_route", lambda backend, *_: backend)
    ttx = StreamingTransmitter(tc, tvq, batch, backend="cuda", device="cpu")
    trx = StreamingReceiver(tc, tvq, batch, backend="cuda", weight_dtype=torch.float32,
                            device="cpu")
    jtx = jrt.StreamingTransmitter(jc, _jnp(cparams), _jnp(cvq), batch=batch)
    jrx = jrt.StreamingReceiver(jc, _jnp(cparams), _jnp(cvq), batch=batch)
    jidx = jtx.initial_encoder(jc.receptive_length)
    tidx = ttx.initial_encoder(tc.receptive_length)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(trx.initial_decoder(tidx).numpy(),
                               np.asarray(jrx.initial_decoder(jidx)), atol=ATOL)
    for chunk in rng.standard_normal((3, batch, FRAME, 1)).astype(np.float32) * 0.3:
        jidx = jtx.encode(_jnp(chunk))
        tidx = ttx.encode(torch.from_numpy(chunk))
        assert tidx.dtype == torch.int32 and tuple(tidx.shape) == (3, batch, FRAME // tc.hop)
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
        np.testing.assert_allclose(trx.decode(tidx).numpy(), np.asarray(jrx.decode(jidx)),
                                   atol=ATOL)


# ---------------------------------------------------------------- streaming


@pytest.mark.parametrize("mode,batch", [("pair", 1), ("pair", 2), ("fused", 1),
                                        ("fused", 2)])
def test_streamer_run_array_matches_jax(rng, models, mode, batch):
    """AudioCodecStreamer on 8 frames of B streams: the v0-family pairing
    (tx thread, the MRF receiver in the rx thread; JAX 'xla', the port's
    'eager' on the CPU) or the fused codec (one worker)."""
    jc, cparams, cvq, tc, tvq = models["codec"]
    jv, vparams, tv = models["mrf"]
    audio = rng.standard_normal((batch, 8 * FRAME, 1)).astype(np.float32) * 0.3
    kw = dict(frame_size=FRAME, sample_rate=SR, max_latency=1e9, batch=batch)
    if mode == "pair":
        jtx = jrt.StreamingTransmitter(jc, _jnp(cparams), _jnp(cvq), batch=batch)
        jrx = jrt.VocoderReceiver(jc, jv, vparams, _jnp(cvq), batch=batch, backend="xla")
        jstreamer = jrt.AudioCodecStreamer(jc, _jnp(cparams), _jnp(cvq), tx=jtx, rx=jrx, **kw)
        tx = StreamingTransmitter(tc, tvq, batch=batch, device="cpu")
        rx = VocoderReceiver(tc, tv, tvq, batch=batch, device="cpu")
        streamer = AudioCodecStreamer(tc, tvq, tx=tx, rx=rx, device="cpu", **kw)
    else:
        jstreamer = jrt.AudioCodecStreamer(jc, _jnp(cparams), _jnp(cvq), **kw)
        streamer = AudioCodecStreamer(tc, tvq, device="cpu", **kw)
    assert streamer.fused == (mode == "fused")
    jstreamer.load()
    streamer.load()
    want = _produced(jstreamer.run_array(audio), 8)
    got = _produced(streamer.run_array(audio), 8)
    np.testing.assert_allclose(got, want, atol=ATOL)
    stats = streamer.stats()
    assert stats["frames"] == 8 and stats["frame_drops"] == 0
    assert stats["timing_mode"] == ("fused-estimated-split" if mode == "fused"
                                    else "per-side")


def _cli(main, tree, monkeypatch, args, inputs):
    monkeypatch.chdir(tree)
    out = os.path.join(tree, "out.wav")
    stats = main([*args, *sum((["-i", p] for p in inputs), []), "-o", out,
                  "--frame-size", str(FRAME), "--max-latency", "1000"])
    assert stats["frames"] == 10 and stats["frame_drops"] == 0
    if len(inputs) == 1:
        return [audio_io.read_wav(out)[0]]
    return [audio_io.read_wav(os.path.join(tree, f"out-{b}.wav"))[0]
            for b in range(len(inputs))]


@pytest.mark.parametrize("args,n_inputs", [
    (["--model", "vctk_v0"], 1),
    (["--model", "vctk_v0"], 2),
    (["--checkpoint", "exp/autoencoder/symAD_vctk_48000_hop300/checkpoint-200000steps"], 1),
], ids=["vctk_v0", "vctk_v0_two_streams", "checkpoint_fused"])
def test_cli_stream_writes_what_jax_writes(tmp_path, monkeypatch, port_tree, jax_tree,
                                           args, n_inputs):
    """``cli.stream.main`` of both packages, each from its own exp/ tree,
    on the same wavs of 10 frames (48 kHz PCM16)."""
    rng = np.random.default_rng(8)
    inputs = []
    for b in range(n_inputs):
        path = str(tmp_path / f"in{b}.wav")
        jax_io.write_wav(path, (0.3 * rng.standard_normal(10 * FRAME)).astype(np.float32), SR)
        inputs.append(path)
    want = _cli(jax_cli.main, jax_tree, monkeypatch, [*args, "--rx-backend", "xla"], inputs)
    got = _cli(port_cli.main, port_tree, monkeypatch, [*args, "--device", "cpu"], inputs)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_produced(g[None], 10), _produced(w[None], 10),
                                   atol=ATOL + PCM16_STEP)


# ---------------------------------------------------------------- wav I/O


def _riff(path, samples, sr, fmt_tag, bits, extensible=False):
    """A RIFF/WAVE file written by hand: ``samples`` (T, C) raw values of
    ``bits`` bits (PCM ints or IEEE floats), optionally as
    WAVE_FORMAT_EXTENSIBLE, with an odd-sized chunk before the data."""
    t, ch = samples.shape
    if bits == 24:
        ints = samples.astype(np.int32).reshape(-1)
        data = b"".join(int(v & 0xFFFFFF).to_bytes(3, "little") for v in ints)
    else:
        data = samples.astype("<f4" if fmt_tag == 3 else "<i2").tobytes()
    block = ch * bits // 8
    if extensible:
        fmt = struct.pack("<HHIIHHHHI", 0xFFFE, ch, sr, sr * block, block, bits, 22, bits, 0)
        fmt += struct.pack("<H", fmt_tag) + bytes(14)
    else:
        fmt = struct.pack("<HHIIHH", fmt_tag, ch, sr, sr * block, block, bits)
    chunks = (b"fmt " + struct.pack("<I", len(fmt)) + fmt + b"LIST" + struct.pack("<I", 3)
              + b"abc\0" + b"data" + struct.pack("<I", len(data)) + data)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WAVE" + chunks)


@pytest.mark.parametrize("kind", ["pcm16", "pcm24", "float", "float_extensible"])
def test_read_wav_matches_jax(tmp_path, rng, kind):
    path = str(tmp_path / f"{kind}.wav")
    x = rng.uniform(-0.9, 0.9, (300, 2))
    if kind == "pcm16":
        _riff(path, np.round(x * 32767), 16000, 1, 16)
    elif kind == "pcm24":
        _riff(path, np.round(x * 8388607), 24000, 1, 24)
    else:
        _riff(path, x, 48000, 3, 32, extensible=kind == "float_extensible")
    got, sr = audio_io.read_wav(path)
    want, want_sr = jax_io.read_wav(path)
    assert sr == want_sr and got.dtype == np.float32 and got.shape == (300, 2)
    np.testing.assert_array_equal(got, want)
    assert np.abs(got - x).max() < 1e-4


def test_write_wav_and_resample_match_jax(tmp_path, rng):
    x = (0.5 * rng.standard_normal(4801)).astype(np.float32)
    ours, theirs = str(tmp_path / "ours.wav"), str(tmp_path / "theirs.wav")
    audio_io.write_wav(ours, x, SR)
    jax_io.write_wav(theirs, x, SR)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    for orig, target in ((SR, 16000), (24000, SR), (SR, SR)):
        np.testing.assert_array_equal(audio_io.resample(x[:, None], orig, target),
                                      jax_io.resample(x[:, None], orig, target))
    np.testing.assert_array_equal(audio_io.load_audio(ours, 16000),
                                  jax_io.load_audio(theirs, 16000))
