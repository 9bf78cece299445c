"""The port's reference-checkpoint reader and writer against the JAX
package's (CPU): utils/torch_import.py, utils/torch_export.py and
cli/{import,export}_checkpoint.py.

No reference ``.pkl`` is in the repository, so the JAX package's exporter
writes them, from seeded JAX params (numpy-drawn in the JAX init's tree,
``seeded_init``; weight-norm gains and biases rescaled so a wrong axis
shows). Tolerances:

- import: the port modules' tensors, statistics and ``VQState`` equal, bit
  for bit, what ``utils/jax_params.py`` makes of the same params;
- export: the same key set as the JAX export and every array equal bit for
  bit, the without-PQC placeholders included;
- the CLIs: both pickle formats (``torch.save``) through
  ``cli.import_checkpoint``, then ``load_generator_from_checkpoint``: the
  offline forward within 2e-5 of JAX's (f32, the JAX package's own at small
  topologies).
"""

import numpy as np
import pytest
import torch
import yaml

import jax.numpy as jnp

from dl_speech_enhancement_tpu.models import AudioDecGenerator as JaxCodec
from dl_speech_enhancement_tpu.models import HiFiGANDiscriminator as JaxHiFiDisc
from dl_speech_enhancement_tpu.models import UnivNetDiscriminator as JaxUnivDisc
from dl_speech_enhancement_tpu.utils import torch_export as jexport
from dl_speech_enhancement_tpu.utils import torch_import as jimport
from dl_speech_enhancement_tpu_torch.cli import export_checkpoint as export_cli
from dl_speech_enhancement_tpu_torch.cli import import_checkpoint as import_cli
from dl_speech_enhancement_tpu_torch.models import (
    AudioDecGenerator,
    HiFiGANDiscriminator,
    HiFiGANGenerator,
    UnivNetDiscriminator,
)
from dl_speech_enhancement_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from dl_speech_enhancement_tpu_torch.utils import torch_export, torch_import
from dl_speech_enhancement_tpu_torch.utils.audiodec import load_generator_from_checkpoint
from dl_speech_enhancement_tpu_torch.utils.jax_params import (
    discriminator_from_jax_params,
    from_jax_params,
    vq_state_from_jax,
)
from test_torch_port_discriminator import TINY_UNIV, disc_params
from test_torch_port_hifigan import MGC, MRF, seeded_init
from test_torch_port_train import TINY_DISC
from test_torch_port_vocoder import _codecs, _seeded_stats, _vocoders

from conftest import SMALL_TOPOLOGY as SMALL
from torch_port_threads import one_thread  # noqa: F401

ATOL = 2e-5
GEN_CONFIG = dict(SMALL, input_channels=1, output_channels=1)


def _same_state(a: dict, b: dict):
    assert list(a) == list(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _same_sd(port: dict, jax_sd: dict):
    assert set(port) == set(jax_sd)
    for k, v in jax_sd.items():
        want = np.asarray(v)
        assert port[k].dtype == want.dtype and port[k].shape == want.shape, k
        assert np.array_equal(port[k], want), k


def _tensors(sd: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def _without_pqc(seed):
    jc = JaxCodec(use_pqc=False, **SMALL)
    params, _ = seeded_init(jc, seed)
    tc = from_jax_params(AudioDecGenerator(use_pqc=False, device="cpu", **SMALL), params)
    return jc, params, tc


def _discriminators(kind, seed):
    jcls, tcls, kw = {"hifigan": (JaxHiFiDisc, HiFiGANDiscriminator, TINY_DISC),
                      "univnet": (JaxUnivDisc, UnivNetDiscriminator, TINY_UNIV)}[kind]
    jd = jcls(**kw)
    params = disc_params(jd, seed)
    return jd, params, discriminator_from_jax_params(tcls(**kw, device="cpu"), params), \
        lambda: tcls(**kw, seed=seed + 1, device="cpu")


# ---------------------------------------------------------------- generators


def test_codec_import_and_export_match_jax():
    jc, params, vq, tc, tvq = _codecs(SMALL, 3)
    sd = jexport.export_audiodec_generator(params, vq, jc)
    got, got_vq = torch_import.import_audiodec_generator(
        _tensors(sd), AudioDecGenerator(use_pqc=True, seed=9, device="cpu", **SMALL))
    _same_state(got.state_dict(), tc.state_dict())
    assert all(torch.equal(a, b) for a, b in zip(got_vq, tvq))
    _same_sd(torch_export.export_audiodec_generator(tc, tvq), sd)


def test_denoiser_import_and_export_match_jax():
    """Without PQC the pickle's placeholder projector, quantizer and decoder
    input conv are skipped on import and drawn as JAX draws them on export."""
    jc, params, tc = _without_pqc(4)
    sd = jexport.export_audiodec_generator(params, None, jc, generator_config=GEN_CONFIG)
    got, vq = torch_import.import_audiodec_generator(
        _tensors(sd), AudioDecGenerator(use_pqc=False, seed=9, device="cpu", **SMALL))
    assert vq is None
    _same_state(got.state_dict(), tc.state_dict())
    _same_sd(torch_export.export_audiodec_generator(tc, None, GEN_CONFIG), sd)


@pytest.mark.parametrize("topology", [MRF, MGC], ids=["mrf", "mgc"])
def test_vocoder_import_and_export_match_jax(topology):
    """Both fusion forms, with the analyzer statistics as buffers."""
    topology = dict(topology, in_channels=16)
    stats = _seeded_stats(np.random.default_rng(5), 16)
    jv, p, tv = _vocoders(topology, 6, stats=stats)
    sd = jexport.export_hifigan_generator(p, jv)
    got, got_stats = torch_import.import_hifigan_generator(
        _tensors(sd), HiFiGANGenerator(**topology, stats=np.ones((2, 16)), seed=9,
                                       device="cpu"))
    assert np.array_equal(got_stats, stats)
    _same_state(got.state_dict(), tv.state_dict())
    _same_sd(torch_export.export_hifigan_generator(tv), sd)


@pytest.mark.parametrize("kind", ["hifigan", "univnet"])
def test_discriminator_import_and_export_match_jax(kind):
    jd, params, td, fresh = _discriminators(kind, 7)
    export = {"hifigan": (jexport.export_hifigan_discriminator,
                          torch_export.export_hifigan_discriminator,
                          torch_import.import_hifigan_discriminator),
              "univnet": (jexport.export_univnet_discriminator,
                          torch_export.export_univnet_discriminator,
                          torch_import.import_univnet_discriminator)}[kind]
    sd = export[0](params, jd)
    _same_state(export[2](_tensors(sd), fresh()).state_dict(), td.state_dict())
    _same_sd(export[1](td), sd)


def test_weight_normed_msd_is_refused_by_both():
    kw = dict(TINY_DISC, scale_discriminator_params=dict(
        TINY_DISC["scale_discriminator_params"], use_weight_norm=True))
    jd = JaxHiFiDisc(**kw)
    params = disc_params(jd, 8)
    with pytest.raises(ValueError, match="no-op"):
        jexport.export_hifigan_discriminator(params, jd)
    td = discriminator_from_jax_params(HiFiGANDiscriminator(**kw, device="cpu"), params)
    with pytest.raises(ValueError, match="no-op"):
        torch_export.export_hifigan_discriminator(td)


def test_topology_mismatches_raise_in_both():
    jc, params, vq, _, _ = _codecs(SMALL, 3)
    sd = jexport.export_audiodec_generator(params, vq, jc)
    wide = dict(SMALL, encode_channels=16)
    with pytest.raises(ValueError, match="shape mismatch"):
        jimport.import_audiodec_generator(sd, JaxCodec(use_pqc=True, **wide))
    with pytest.raises(ValueError, match="shape mismatch at encoder.conv.conv.weight"):
        torch_import.import_audiodec_generator(
            _tensors(sd), AudioDecGenerator(use_pqc=True, device="cpu", **wide))
    extra = dict(sd, **{"encoder.conv_blocks.2.conv.conv.weight":
                        sd["encoder.conv_blocks.1.conv.conv.weight"]})
    with pytest.raises(ValueError):
        jimport.import_audiodec_generator(extra, jc)
    with pytest.raises(ValueError, match="encoder.conv_blocks.2.conv.conv.weight fits no"):
        torch_import.import_audiodec_generator(
            _tensors(extra), AudioDecGenerator(use_pqc=True, device="cpu", **SMALL))
    books = dict(SMALL, codebook_size=64)
    with pytest.raises(ValueError, match="residual VQ state"):
        torch_import.import_audiodec_generator(
            _tensors(sd), AudioDecGenerator(use_pqc=True, device="cpu", **books))
    jv, p, _ = _vocoders(MRF, 6)
    plain = {k.replace("weight_v", "weight"): v
             for k, v in jexport.export_hifigan_generator(p, jv).items()
             if not k.endswith("weight_g")}
    with pytest.raises(ValueError, match="weight-normed in the model"):
        torch_import.import_hifigan_generator(_tensors(plain),
                                              HiFiGANGenerator(**MRF, device="cpu"))


# ---------------------------------------------------------------- the CLIs


def _config(tmp_path, model_type="symAudioDec"):
    cfg = {"model_type": model_type, "train_mode": "autoencoder", "sampling_rate": 48000,
           "generator_params": {k: list(v) if isinstance(v, tuple) else v
                                for k, v in GEN_CONFIG.items()},
           "discriminator_params": yaml.safe_load(yaml.safe_dump(
               {k: list(v) if isinstance(v, tuple) else v for k, v in TINY_DISC.items()}))}
    path = tmp_path / "config.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _reference_optimizer_state():
    """A torch Adam's and MultiStepLR's state dicts, as the reference
    trainer pickles them (a Counter among them)."""
    w = torch.nn.Parameter(torch.ones(3))
    opt = torch.optim.Adam([w], lr=1e-3)
    w.sum().backward()
    opt.step()
    sched = torch.optim.lr_scheduler.MultiStepLR(opt, milestones=[2, 4], gamma=0.5)
    return {"generator": opt.state_dict()}, {"generator": sched.state_dict()}


def test_import_cli_framework_format(tmp_path, rng):
    jc, params, vq, tc, tvq = _codecs(SMALL, 3)
    jd, dparams, td, _ = _discriminators("hifigan", 7)
    optimizer, scheduler = _reference_optimizer_state()
    pkl = str(tmp_path / "checkpoint-123steps.pkl")
    torch.save({"model": {"generator": _tensors(jexport.export_audiodec_generator(
                              params, vq, jc)),
                          "discriminator": _tensors(jexport.export_hifigan_discriminator(
                              dparams, jd))},
                "optimizer": optimizer, "scheduler": scheduler, "steps": 123, "epochs": 4},
               pkl)
    out = str(tmp_path / "imported" / "checkpoint-123steps")
    import_cli.main(["--checkpoint", pkl, "--config", _config(tmp_path), "--out", out,
                     "--device", "cpu"])
    state = load_checkpoint(out)
    assert state["steps"] == 123 and state["epochs"] == 4
    assert set(state) == {"params_generator", "vq_state", "params_discriminator", "steps",
                          "epochs"}
    _same_state(state["params_discriminator"], td.state_dict())

    gen, vq_state, _ = load_generator_from_checkpoint(out, device="cpu")
    _same_state(gen.state_dict(), tc.state_dict())
    x = rng.standard_normal((1, 240, 1)).astype(np.float32) * 0.3
    with torch.no_grad():
        y = gen(torch.from_numpy(x), vq_state, train=False)[0].numpy()
    want = jc(params, vq, jnp.asarray(x), train=False)[0]
    np.testing.assert_allclose(y, np.asarray(want), atol=ATOL)


def test_import_cli_course_format(tmp_path, rng):
    jc, params, _ = _without_pqc(4)
    pkl = str(tmp_path / "TESTcheckpoint-7.pkl")
    torch.save(_tensors(jexport.export_audiodec_generator(params, None, jc,
                                                          generator_config=GEN_CONFIG)), pkl)
    out = str(tmp_path / "imported" / "checkpoint-7")
    import_cli.main(["--checkpoint", pkl, "--config", _config(tmp_path), "--out", out,
                     "--without-pqc", "--device", "cpu"])
    assert set(load_checkpoint(out)) == {"params_generator"}
    gen, vq_state, _ = load_generator_from_checkpoint(out, use_pqc=False, device="cpu")
    assert vq_state is None
    x = rng.standard_normal((1, 240, 1)).astype(np.float32) * 0.3
    with torch.no_grad():
        y = gen(torch.from_numpy(x), None, train=False)[0].numpy()
    want = jc(params, None, jnp.asarray(x), train=False)[0]
    np.testing.assert_allclose(y, np.asarray(want), atol=ATOL)


def test_import_cli_vocoder_writes_its_statistics(tmp_path):
    topology = dict(MGC, in_channels=16)
    stats = _seeded_stats(np.random.default_rng(5), 16)
    jv, p, tv = _vocoders(topology, 6, stats=stats)
    pkl = str(tmp_path / "voc.pkl")
    torch.save(_tensors(jexport.export_hifigan_generator(p, jv)), pkl)
    gp = {k: [list(d) for d in v] if k == "resblock_dilations" else
          list(v) if isinstance(v, tuple) else v for k, v in topology.items()}
    cfg = tmp_path / "voc.yaml"
    cfg.write_text(yaml.safe_dump({"model_type": "HiFiGAN", "generator_params": gp}))
    out = tmp_path / "imported" / "checkpoint-1"
    import_cli.main(["--checkpoint", pkl, "--config", str(cfg), "--out", str(out),
                     "--device", "cpu"])
    assert np.array_equal(np.load(tmp_path / "imported" / "stats_imported.npy"), stats)
    _same_state(load_checkpoint(str(out))["params_generator"], tv.state_dict())
    cfg.write_text(yaml.safe_dump({"model_type": "HiFiGAN", "generator_params": dict(
        gp, stats=str(tmp_path / "imported" / "stats_imported.npy"))}))
    export_cli.main(["--checkpoint", str(out), "--config", str(cfg), "--out",
                     str(tmp_path / "back.pkl"), "--device", "cpu"])
    _same_sd({k: v.numpy() for k, v in torch.load(str(tmp_path / "back.pkl")).items()},
             jexport.export_hifigan_generator(p, jv))


@pytest.mark.parametrize("fmt", ["framework", "course"])
def test_export_cli_matches_the_jax_export(tmp_path, fmt):
    """A port checkpoint out through cli.export_checkpoint: the JAX export
    of the same params, bit for bit; then back in through the import CLI:
    the same state."""
    jc, params, vq, tc, tvq = _codecs(SMALL, 3)
    jd, dparams, td, _ = _discriminators("hifigan", 7)
    ckpt = str(tmp_path / "run" / "checkpoint-5steps")
    cfg_path = _config(tmp_path)
    with open(cfg_path) as f:
        cfg = yaml.safe_load(f)
    save_checkpoint(ckpt, {"params_generator": tc.state_dict(), "vq_state": tvq,
                           "params_discriminator": td.state_dict(), "steps": 5,
                           "epochs": 1}, cfg)
    pkl = str(tmp_path / "out.pkl")
    export_cli.main(["--checkpoint", ckpt, "--out", pkl, "--format", fmt, "--device", "cpu"])
    saved = torch.load(pkl, weights_only=True)
    gen_sd = saved["model"]["generator"] if fmt == "framework" else saved
    _same_sd({k: v.numpy() for k, v in gen_sd.items()},
             jexport.export_audiodec_generator(params, vq, jc))
    if fmt == "framework":
        assert saved["steps"] == 5 and saved["epochs"] == 1
        _same_sd({k: v.numpy() for k, v in saved["model"]["discriminator"].items()},
                 jexport.export_hifigan_discriminator(dparams, jd))
    back = str(tmp_path / "back" / "checkpoint-5steps")
    import_cli.main(["--checkpoint", pkl, "--config", cfg_path, "--out", back,
                     "--device", "cpu"])
    state = load_checkpoint(back)
    _same_state(state["params_generator"], tc.state_dict())
    assert all(torch.equal(state["vq_state"][f], getattr(tvq, f)) for f in tvq._fields)


def test_cli_devices_default_to_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device 'cuda'"):
        import_cli.main(["--checkpoint", "x.pkl", "--config", _config(tmp_path), "--out",
                         str(tmp_path / "o")])
    with pytest.raises(RuntimeError, match="device 'cuda'"):
        export_cli.main(["--checkpoint", str(tmp_path / "c"), "--out", "x.pkl"])


def test_vq_state_of_an_import_is_the_jax_conversion():
    jc, params, vq, tc, _ = _codecs(SMALL, 11)
    sd = _tensors(jexport.export_audiodec_generator(params, vq, jc))
    _, got = torch_import.import_audiodec_generator(
        sd, AudioDecGenerator(use_pqc=True, device="cpu", **SMALL))
    want = vq_state_from_jax(jimport.import_audiodec_generator(
        {k: v for k, v in sd.items()}, jc)[1], tc)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
