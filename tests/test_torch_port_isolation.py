"""The PyTorch port stands alone: it imports neither JAX nor anything of the
JAX package, and neither does chip_smoke.py."""

import ast
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "dl_speech_enhancement_tpu_torch"
PORT_FILES = sorted(PORT.rglob("*.py"))
CHECKED = PORT_FILES + [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "dl_speech_enhancement_tpu")


def _modules():
    return [".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
            for p in PORT_FILES]


def test_port_has_the_slice_modules():
    names = set(_modules())
    for mod in ("nn.conv", "nn.vq", "models.autoencoder", "models.hifigan", "ops.stream_kernel",
                "ops.mega_kernel", "ops.mega_stacked", "ops.vocoder_kernel", "ops.vocoder_stacked",
                "ops._cuda", "parallel.serve", "stream.runtime", "utils.config",
                "utils.jax_params", "dsp.stft", "dsp.mel", "ops.mel_kernel", "losses.metrics",
                "losses.mel_loss", "losses.stft_loss", "losses.waveform_loss",
                "losses.adversarial_loss", "losses.feat_match_loss", "train.optim",
                "train.criterion", "train.denoise_course", "data.mixing", "utils.audiodec",
                "utils.audiodec_without_pqc", "utils.model_factory", "train.checkpoint",
                "data.audio_io", "cli.stream", "tools.reshape_probe", "tools.conv_timing",
                "tools.rvq_timing", "models.discriminator", "models.univnet", "data",
                "data.dataset", "data.collate", "data.loader", "train.gan_trainer",
                "train.workloads", "train.workloads.autoencoder", "train.workloads.denoise",
                "train.workloads.vocoder", "train.workloads.statistic", "cli.train",
                "cli.statistic", "cli.train_denoise", "utils.torch_import",
                "utils.torch_export", "cli.import_checkpoint", "cli.export_checkpoint", "eval",
                "eval.metrics", "eval.onnx_graph", "eval.onnx_torch", "eval.dnsmos",
                "cli.testing_denoise", "cli.test", "cli.analyze", "cli.dnsmos", "data.native",
                "parallel.mesh", "parallel.long_audio", "cli.serve", "eval.dnsmos_web",
                "parallel.time_shard", "utils.collectives"):
        assert f"dl_speech_enhancement_tpu_torch.{mod}" in names


def test_imports_without_jax_or_the_jax_package():
    """Every port module and chip_smoke.py import with ``jax`` made
    unimportable, and load no module of the JAX package."""
    code = "\n".join([
        "import importlib, sys",
        f"sys.path.insert(0, {str(REPO)!r})",
        "sys.modules['jax'] = None",
        "sys.modules['jaxlib'] = None",
        *[f"importlib.import_module({m!r})" for m in _modules()],
        "import chip_smoke",
        "bad = sorted(m for m in sys.modules if m == 'dl_speech_enhancement_tpu'",
        "             or m.startswith('dl_speech_enhancement_tpu.'))",
        "assert not bad, bad",
        "print('ok')",
    ])
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=str(REPO))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def _imported(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", CHECKED, ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_no_jax(path):
    for name in _imported(path):
        top = name.split(".")[0]
        assert top not in FORBIDDEN, f"{path.relative_to(REPO)} imports {name}"
