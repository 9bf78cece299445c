"""The port's fleet over a device list, its devices and ``cli.serve``, on the
CPU against the one-device fleet and the JAX package.

``make_sharded_stream(..., device=["cpu", "cpu"])`` splits the streams over
two slices (the CPU tests' stand-in for two cards, each slice with its own
copy of the models) and is held bit for bit to the one-device fleet on the
same frames: symmetric without and with PQC, the vocoder receiver and the
asymmetric codec receiver, as tests/test_parallel.py:242, :296 and :350 hold
the JAX mesh fleet to one chip. Every stream's bits are its own on the
plain route too (each conv is one matmul over the batch's rows, summed
per row). Against the JAX fleet on a two-device mesh (the virtual CPU
devices of tests/conftest.py): atol 2e-5, the JAX package's own at small
sizes. ``cli.serve`` runs from a seeded exp/ tree written as
tests/test_torch_port_audiodec.py writes it, with ``--device cpu``, after
JAX tests/test_cli_eval.py:175 and :202; its per-stream outputs are the
one-device fleet's on the same wav, to one PCM16 step.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dl_speech_enhancement_tpu.parallel import make_mesh as jax_mesh
from dl_speech_enhancement_tpu.parallel import make_sharded_stream as jax_sharded
from dl_speech_enhancement_tpu_torch.cli import serve as serve_cli
from dl_speech_enhancement_tpu_torch.data import audio_io
from dl_speech_enhancement_tpu_torch.parallel import make_mesh, make_sharded_stream
from dl_speech_enhancement_tpu_torch.utils.audiodec import load_generator_from_checkpoint
from test_torch_port_audiodec import FRAME, PCM16_STEP, SR, models, port_tree  # noqa: F401
from test_torch_port_vocoder import CODEC_SMALL, VOC_PAIRED, _codecs, _vocoders
from torch_port_threads import one_thread  # noqa: F401

ATOL = 2e-5
DENOISER = {k: v for k, v in CODEC_SMALL.items() if k not in ("codebook_num", "codebook_size")}


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def fleet_models():
    """The small codec, a second codec (an asymmetric receiver), the v1-family
    receiver and a small denoiser, in both packages."""
    from dl_speech_enhancement_tpu.models import AudioDecGenerator as JaxCodec
    from dl_speech_enhancement_tpu_torch.models import AudioDecGenerator
    from dl_speech_enhancement_tpu_torch.utils.jax_params import from_jax_params
    from test_torch_port_hifigan import seeded_init

    jd = JaxCodec(use_pqc=False, **DENOISER)
    dparams = seeded_init(jd, 43)[0]
    td = from_jax_params(AudioDecGenerator(use_pqc=False, device="cpu", **DENOISER), dparams)
    return {"codec": _codecs(CODEC_SMALL, seed=40), "rx": _codecs(CODEC_SMALL, seed=41),
            "voc": _vocoders(VOC_PAIRED, seed=42), "denoiser": (jd, dparams, td)}


def _fleet_frames(rng, batch, n):
    x = rng.standard_normal((batch, FRAME * n, 1)).astype(np.float32) * 0.3
    return x.reshape(batch, n, FRAME, 1).transpose(1, 0, 2, 3).copy()


def _fleet_args(fleet_models, kind):
    """(gen, vq_state, receiver kwargs) of a fleet kind."""
    _, _, _, tc, tvq = fleet_models["codec"]
    if kind == "denoiser":
        return fleet_models["denoiser"][2], None, {}
    if kind == "vocoder":
        return tc, tvq, {"vocoder": fleet_models["voc"][2]}
    if kind == "codec_rx":
        _, _, _, rx, rx_vq = fleet_models["rx"]
        return tc, tvq, {"rx_gen": rx, "rx_vq_state": rx_vq}
    return tc, tvq, {}


@pytest.mark.parametrize("kind", ["denoiser", "codec", "vocoder", "codec_rx"])
def test_split_fleet_is_the_one_device_fleet(rng, fleet_models, kind):
    gen, vq, rx = _fleet_args(fleet_models, kind)
    batch = 4
    frames = _fleet_frames(rng, batch, 4)
    one = make_sharded_stream(gen, vq, batch=batch, device="cpu", **rx)
    split = make_sharded_stream(gen, vq, batch=batch, device=["cpu", "cpu"], **rx)
    assert split.batch == batch and split.devices == [torch.device("cpu")] * 2
    shards = split.shard_frames(frames[:2])
    assert [tuple(s.shape) for s in shards] == [(2, 2, FRAME, 1)] * 2
    assert all(s.dtype == torch.float32 for s in shards)
    want, cache1 = one(one.init_cache(), one.shard_frames(frames[:2]))
    got, cache = split(split.init_cache(), shards)
    assert isinstance(cache, list) and len(cache) == 2
    assert torch.equal(got, want)
    # the cache continues; a whole (N, B, F, C) tensor is split by run itself
    want2, _ = one(cache1, one.shard_frames(frames[2:]))
    got2, _ = split(cache, torch.from_numpy(frames[2:]))
    assert torch.equal(got2, want2)
    for d in range(2):  # each slice's caches are those of its streams
        for name, t in cache[d].items():
            assert torch.equal(t, cache1[name][2 * d:2 * d + 2]), name


@pytest.mark.parametrize("kind", ["codec", "vocoder"])
def test_split_fleet_matches_the_jax_mesh_fleet(rng, fleet_models, kind):
    jc, cparams, cvq, tc, tvq = fleet_models["codec"]
    batch = 4
    frames = _fleet_frames(rng, batch, 3)
    kw, rx = {}, {}
    if kind == "vocoder":
        jv, vparams, tv = fleet_models["voc"]
        kw, rx = {"vocoder": jv, "vocoder_params": vparams}, {"vocoder": tv}
    jrun = jax_sharded(jc, _jnp(cparams), _jnp(cvq), mesh=jax_mesh(2), batch=batch, **kw)
    ref, _ = jrun(jrun.init_cache(), jrun.shard_frames(frames))
    run = make_sharded_stream(tc, tvq, batch=batch, device=make_mesh(2, "cpu"), **rx)
    got, _ = run(run.init_cache(), run.shard_frames(frames))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_split_fleet_refuses_what_the_jax_fleet_refuses(fleet_models):
    gen, vq, _ = _fleet_args(fleet_models, "codec")
    _, _, _, rx, rx_vq = fleet_models["rx"]
    with pytest.raises(ValueError, match="divide over 2 devices"):
        make_sharded_stream(gen, vq, batch=3, device=["cpu", "cpu"])
    with pytest.raises(ValueError, match="not both"):
        make_sharded_stream(gen, vq, batch=4, device=["cpu", "cpu"],
                            vocoder=fleet_models["voc"][2], rx_gen=rx, rx_vq_state=rx_vq)
    with pytest.raises(ValueError, match="at least one device"):
        make_sharded_stream(gen, vq, batch=4, device=[])
    run = make_sharded_stream(gen, vq, batch=4, device=["cpu", "cpu"])
    with pytest.raises(ValueError, match=r"\(N, 4, F, C\)"):
        run.shard_frames(np.zeros((1, 3, FRAME, 1), np.float32))
    with pytest.raises(ValueError, match="2 frame slices"):
        run(run.init_cache(), run.shard_frames(np.zeros((1, 4, FRAME, 1), np.float32))[:1])


def test_make_mesh_takes_the_first_devices():
    assert make_mesh(kind="cpu") == [torch.device("cpu")]
    assert make_mesh(3, "cpu") == [torch.device("cpu")] * 3
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match=f"{visible + 1} CUDA devices asked for"):
        make_mesh(visible + 1)
    with pytest.raises(ValueError, match="kind"):
        make_mesh(1, "tpu")


def _wavs(tmp_path, rng, n, samples):
    paths = []
    for i in range(n):
        path = str(tmp_path / f"in{i}.wav")
        audio_io.write_wav(path, (0.3 * rng.standard_normal(samples)).astype(np.float32), SR)
        paths.append(path)
    return paths


CODEC_CKPT = "exp/autoencoder/symAD_vctk_48000_hop300/checkpoint-200000steps"


def test_serve_cli_fleet(tmp_path, monkeypatch, rng, port_tree):
    """JAX tests/test_cli_eval.py:175: 8 streams of the denoiser variant
    (``--without-pqc``: the small codec's N(0, 1) books would give every
    frame the same codes) over two devices, inputs tiled round-robin,
    per-stream outputs written and paired, each the one-device fleet's on
    the wav it played."""
    monkeypatch.chdir(port_tree)
    ins = _wavs(tmp_path, rng, 2, FRAME * 10)
    out = str(tmp_path / "fleet.wav")
    stats = serve_cli.main(["--checkpoint", CODEC_CKPT, "--without-pqc", "--streams", "8",
                            "--devices", "2", "--device", "cpu", "-i", ins[0], "-i", ins[1],
                            "-o", out,
                            "--frame-size", str(FRAME), "--block-frames", "4",
                            "--max-outputs", "4"])
    assert set(stats) == {"streams", "devices", "frames", "fleet_frame_ms",
                          "us_per_stream_frame", "realtime_stream_equivalents"}
    assert stats["streams"] == 8 and stats["devices"] == 2 and stats["frames"] == 10
    assert stats["realtime_stream_equivalents"] > 0
    y = [audio_io.read_wav(str(tmp_path / f"fleet-{b}.wav"))[0][:, 0] for b in range(4)]
    assert not os.path.exists(str(tmp_path / "fleet-4.wav"))
    # stream b plays input b % 2: 0 == 2, 1 == 3, 0 != 1
    assert np.array_equal(y[0], y[2]) and np.array_equal(y[1], y[3])
    assert not np.array_equal(y[0], y[1])
    gen, vq, _ = load_generator_from_checkpoint(CODEC_CKPT, use_pqc=False, device="cpu")
    clips = np.stack([audio_io.load_audio(p, SR)[:, :1] for p in ins])
    run = make_sharded_stream(gen, vq, batch=2, device="cpu")
    frames = clips.reshape(2, 10, FRAME, 1).transpose(1, 0, 2, 3)
    want = run(run.init_cache(), run.shard_frames(frames))[0].numpy()
    for b in range(2):
        np.testing.assert_allclose(y[b], want[:, b].reshape(-1), atol=PCM16_STEP)


def test_serve_cli_presets_and_refusals(tmp_path, monkeypatch, rng, port_tree):
    """JAX tests/test_cli_eval.py:202 and cli/serve.py:81-90: the stream
    count must divide over the devices; exactly one of --checkpoint or
    --model; no --without-pqc with a preset. A paired preset (vctk_v1, the
    v1-family receiver) serves its vocoder in the fleet."""
    monkeypatch.chdir(port_tree)
    ins = _wavs(tmp_path, rng, 1, FRAME * 6)
    base = ["-i", ins[0], "--frame-size", str(FRAME), "--device", "cpu"]
    with pytest.raises(ValueError, match="divide"):
        serve_cli.main(["--checkpoint", CODEC_CKPT, "--streams", "3", "--devices", "2", *base])
    with pytest.raises(SystemExit, match="exactly one"):
        serve_cli.main(base)
    with pytest.raises(SystemExit, match="exactly one"):
        serve_cli.main(["--checkpoint", CODEC_CKPT, "--model", "vctk_v1", *base])
    with pytest.raises(SystemExit, match="--without-pqc"):
        serve_cli.main(["--model", "vctk_v1", "--without-pqc", *base])
    stats = serve_cli.main(["--model", "vctk_v1", "--streams", "2", *base])
    assert stats["streams"] == 2 and stats["devices"] == 1 and stats["frames"] == 6
