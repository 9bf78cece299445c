"""Write the port's modules as the reference's (PyTorch) state dicts.

Counterpart of dl_speech_enhancement_tpu/utils/torch_export.py, the inverse
of utils/torch_import.py: the port's modules become the exact key and value
layout the reference's modules load with ``strict=True``. The port holds its
weights in PyTorch's layouts, so each tensor is written as it is (a
weight-normed conv's ``v`` / ``g`` as ``weight_v`` / ``weight_g``), by the
key maps of utils/torch_import.py. Besides:

- every causal (transposed) conv's streaming ``pad_buffer`` is written as
  zeros of the reference shape, ``(1, in, (k - 1) * dilation)`` or ``(1, in,
  1)`` (layers/conv_layer.py:134-137, 176-180);
- the stacked ``VQState`` unstacks into per-layer ``embed`` /
  ``cluster_size`` / ``embed_avg`` buffers;
- **without PQC** the reference generator still constructs the projector,
  the quantizer and the decoder input conv, so its state dict demands them:
  they are drawn as placeholders from ``np.random.default_rng(0)``, in the
  JAX package's order and shapes, so the two exports are equal bit for bit.

Values are float32 numpy arrays; cli/export_checkpoint.py wraps them in
tensors for ``torch.save``.
"""

from __future__ import annotations

import numpy as np
import torch

from dl_speech_enhancement_tpu_torch.nn.conv import ConvTranspose1d
from dl_speech_enhancement_tpu_torch.utils.torch_import import (
    audiodec_convs,
    hifigan_convs,
    hifigan_discriminator_convs,
    univnet_discriminator_convs,
)

__all__ = [
    "export_audiodec_generator",
    "export_hifigan_generator",
    "export_hifigan_discriminator",
    "export_univnet_discriminator",
]


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.array(t, np.float32)


def _emit(sd: dict, convs) -> None:
    for conv in convs:
        layer = conv.layer
        if conv.pad is not None:
            taps = (1 if isinstance(layer, ConvTranspose1d)
                    else (layer.kernel_size - 1) * layer.dilation)
            sd[f"{conv.pad}.pad_buffer"] = np.zeros((1, layer.in_channels, taps), np.float32)
        if layer.weight_norm:
            sd[f"{conv.key}.weight_g"] = _np(layer.g)
            sd[f"{conv.key}.weight_v"] = _np(layer.v)
        else:
            sd[f"{conv.key}.weight"] = _np(layer._parameters["weight"])
        if layer.bias is not None:
            sd[f"{conv.key}.bias"] = _np(layer.bias)


def _placeholders(sd: dict, gen, generator_config: dict | None) -> None:
    """The unused PQC entries of a without-PQC reference generator, seeded
    random as in an untrained reference module (the JAX package's draws)."""
    cfg = dict(generator_config or {})
    code_dim = int(cfg.get("code_dim", 64))
    enc_out = int(cfg.get("decode_channels", 32)) * list(cfg.get("dec_ratios", (16, 8, 4, 2)))[0]
    k = gen.decoder.conv2.kernel_size
    rng = np.random.default_rng(0)
    sd["decoder.conv1.pad_buffer"] = np.zeros((1, code_dim, k - 1), np.float32)
    sd["decoder.conv1.conv.weight"] = (
        rng.standard_normal((enc_out, code_dim, k)).astype(np.float32) * 0.01)
    # the reference projector's input is the ENCODER's output width
    enc_width = gen.encoder.out_channels
    sd["projector.project.pad_buffer"] = np.zeros((1, enc_width, 2), np.float32)
    sd["projector.project.conv.weight"] = (
        rng.standard_normal((code_dim, enc_width, 3)).astype(np.float32) * 0.01)
    book = int(cfg.get("codebook_size", 1024))
    for i in range(int(cfg.get("codebook_num", 8))):
        base = f"quantizer.codebook.layers.{i}"
        embed = rng.standard_normal((code_dim, book)).astype(np.float32)
        sd[f"{base}.embed"] = embed
        sd[f"{base}.cluster_size"] = np.zeros((book,), np.float32)
        sd[f"{base}.embed_avg"] = embed.copy()


def export_audiodec_generator(gen, vq_state=None, generator_config: dict | None = None) -> dict:
    """The port's ``AudioDecGenerator`` ``gen`` (with its ``VQState`` for
    PQC) as a reference state dict. Without PQC, ``generator_config`` (the
    config's ``generator_params``) gives ``code_dim`` / ``codebook_num`` /
    ``codebook_size`` / ``decode_channels`` / ``dec_ratios`` of the
    placeholder entries."""
    gen.check_vq_state(vq_state)
    sd: dict = {}
    _emit(sd, audiodec_convs(gen))
    if gen.use_pqc:
        embed, cluster, avg = (_np(t) for t in vq_state)
        for i in range(embed.shape[0]):
            base = f"quantizer.codebook.layers.{i}"
            sd[f"{base}.embed"] = embed[i]
            sd[f"{base}.cluster_size"] = cluster[i]
            sd[f"{base}.embed_avg"] = avg[i]
    else:
        _placeholders(sd, gen, generator_config)
    return sd


def export_hifigan_generator(voc, stats=None) -> dict:
    """The port's ``HiFiGANGenerator`` as a reference state dict; ``stats``
    (a ``(2, C)`` [mean; scale] array, by default the generator's own where
    it normalises its input) become the ``mean`` / ``scale`` buffers."""
    sd: dict = {}
    if stats is None and getattr(voc, "norm", False):
        stats = np.stack([_np(voc.mean), _np(voc.scale)])
    if stats is not None:
        sd["mean"] = _np(stats[0]).reshape(-1)
        sd["scale"] = _np(stats[1]).reshape(-1)
    _emit(sd, hifigan_convs(voc))
    return sd


def export_hifigan_discriminator(disc) -> dict:
    """The port's MSD + MPD as a reference state dict. The reference's scale
    discriminator carries plain weights (its norm application is a no-op,
    discriminator.py:354-372), so a weight-normed MSD raises ValueError."""
    if any(layer.weight_norm for d in disc.msd.discriminators for layer in d.layers):
        raise ValueError("MSD layers trained with explicit weight norm cannot be exported: "
                         "the reference's scale discriminator carries plain weights (its norm "
                         "application is a no-op, discriminator.py:354-372)")
    sd: dict = {}
    _emit(sd, hifigan_discriminator_convs(disc))
    return sd


def export_univnet_discriminator(disc) -> dict:
    """The port's MRSD + MPD as a reference state dict, with each resolution's
    Hann ``window`` buffer."""
    sd: dict = {}
    for i, d in enumerate(disc.mrsd.discriminators):
        sd[f"mrsd.discriminators.{i}.window"] = _np(d.window)
    _emit(sd, univnet_discriminator_convs(disc))
    return sd
