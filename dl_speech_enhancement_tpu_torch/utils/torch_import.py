"""Read the reference's (PyTorch) checkpoints into the port's modules.

Counterpart of dl_speech_enhancement_tpu/utils/torch_import.py, whose key
maps are the spec. The reference ships two pickle formats (both
``torch.save``):

1. **framework format** (trainer/trainerGAN.py:95-121): a dict with
   ``model.generator`` / ``model.discriminator`` state dicts plus optimizer,
   scheduler, steps and epochs entries;
2. **course format** (train_denoise.py:350-355): a bare generator
   ``state_dict``.

The port keeps its conv weights in PyTorch's own layouts (nn/conv.py):
Conv1d ``(out, in, k)``, ConvTranspose1d ``(in, out, k)`` (not tap-flipped:
only the JAX package flips it, utils/jax_params.py::_dw_out), Conv2d ``(out,
in, kh, kw)``, and a weight-normed conv's ``v`` and ``g`` with ``g`` shaped
as torch's ``weight_g`` (dim 0). So a reference tensor is copied as it is,
``weight_g`` / ``weight_v`` onto ``g`` / ``v``; the EMA residual-VQ buffers
(``embed`` / ``cluster_size`` / ``embed_avg`` per layer) stack into a
``VQState``, and a HiFiGAN's ``mean`` / ``scale`` buffers into a ``(2, C)``
stats array.

Each map walks the port module and names the reference key of each of its
convs. A key the module needs and the state dict lacks, a tensor whose shape
differs from the module's, a weight-normed tensor for a plain layer (or the
reverse), and a weight or bias of the state dict that no layer takes raise
ValueError naming the key, as the JAX package's ``_check_like`` raises for a
topology mismatch. The streaming ``pad_buffer``s carry no weights and are
not read.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dl_speech_enhancement_tpu_torch.models.hifigan import MultiGroupConv1d
from dl_speech_enhancement_tpu_torch.nn.vq import VQState
from dl_speech_enhancement_tpu_torch.utils.jax_params import vq_state_from_jax

__all__ = [
    "load_torch_pickle",
    "split_checkpoint",
    "import_audiodec_generator",
    "import_hifigan_generator",
    "import_hifigan_discriminator",
    "import_univnet_discriminator",
]


class RefConv(NamedTuple):
    """One conv of a port module and where the reference keeps it."""

    key: str  # the prefix of its weight / bias in the reference state dict
    layer: torch.nn.Module
    pad: str | None = None  # the prefix of its streaming pad_buffer
    nested: bool = False  # a discriminator conv: the reference may nest it as .0 / .conv


def load_torch_pickle(path: str):
    """``torch.load`` of a reference checkpoint on the CPU. ``weights_only``:
    both formats hold only state dicts, tensors, numbers and the optimizer's
    and scheduler's state (dicts, lists, tuples, a ``Counter``)."""
    return torch.load(path, map_location="cpu", weights_only=True)


def split_checkpoint(ckpt) -> dict:
    """A loaded pickle as ``{format, generator, discriminator, steps,
    epochs}``: the framework format's parts, or a course-format generator
    state dict with no discriminator and zero counts."""
    if isinstance(ckpt, dict) and "model" in ckpt:
        return {"format": "framework", "generator": ckpt["model"]["generator"],
                "discriminator": ckpt["model"].get("discriminator"),
                "steps": int(ckpt.get("steps", 0)), "epochs": int(ckpt.get("epochs", 0))}
    return {"format": "course", "generator": ckpt, "discriminator": None, "steps": 0,
            "epochs": 0}


# ------------------------------------------------------------- the key maps

def _res_units(base: str, units) -> list:
    # CausalResidualUnit: conv1 a CausalConv1d (inner .conv), conv2 a bare 1x1
    out = []
    for j, u in enumerate(units):
        out.append(RefConv(f"{base}.res_units.{j}.conv1.conv", u.conv1,
                           f"{base}.res_units.{j}.conv1"))
        out.append(RefConv(f"{base}.res_units.{j}.conv2", u.conv2))
    return out


def audiodec_convs(gen) -> list:
    """The convs of an ``AudioDecGenerator`` with their reference keys
    (models/autoencoder/AudioDec.py); without PQC no projector and no decoder
    input conv."""
    convs = [RefConv("encoder.conv.conv", gen.encoder.conv, "encoder.conv")]
    for i, blk in enumerate(gen.encoder.blocks):
        b = f"encoder.conv_blocks.{i}"
        convs += _res_units(b, blk.res_units)
        convs.append(RefConv(f"{b}.conv.conv", blk.conv, f"{b}.conv"))
    if gen.use_pqc:
        convs.append(RefConv("decoder.conv1.conv", gen.decoder.conv1, "decoder.conv1"))
    for i, blk in enumerate(gen.decoder.blocks):
        b = f"decoder.conv_blocks.{i}"
        convs.append(RefConv(f"{b}.conv.deconv", blk.conv, f"{b}.conv"))
        convs += _res_units(b, blk.res_units)
    convs.append(RefConv("decoder.conv2.conv", gen.decoder.conv2, "decoder.conv2"))
    if gen.use_pqc:
        convs.append(RefConv("projector.project.conv", gen.projector.conv, "projector.project"))
    return convs


def _resblock(base: str, blk) -> list:
    return [RefConv(f"{base}.{name}.{k}.conv", c, f"{base}.{name}.{k}")
            for name in ("convs1", "convs2") for k, c in enumerate(getattr(blk, name))]


def hifigan_convs(voc) -> list:
    """The convs of a ``HiFiGANGenerator`` with their reference keys
    (models/vocoder/HiFiGAN.py): MultiReceptiveField blocks
    (``blocks.i.blocks.j``) or the AudioDec-v1 grouped fast decoder
    (``blocks.i`` plus its 1x1 ``conv_out``)."""
    convs = [RefConv("input_conv.conv", voc.input_conv, "input_conv")]
    convs += [RefConv(f"upsamples.{i}.deconv", u, f"upsamples.{i}")
              for i, u in enumerate(voc.upsamples)]
    for i, blk in enumerate(voc.blocks):
        if isinstance(blk, MultiGroupConv1d):
            convs += _resblock(f"blocks.{i}", blk.block)
            convs.append(RefConv(f"blocks.{i}.conv_out", blk.conv_out))
        else:
            for j, rb in enumerate(blk.blocks):
                convs += _resblock(f"blocks.{i}.blocks.{j}", rb)
    convs.append(RefConv("output_conv.conv", voc.output_conv, "output_conv"))
    return convs


def _mpd_convs(mpd) -> list:
    convs = []
    for i, d in enumerate(mpd.discriminators):
        b = f"mpd.discriminators.{i}"
        convs += [RefConv(f"{b}.convs.{j}.0", c, nested=True) for j, c in enumerate(d.convs)]
        convs.append(RefConv(f"{b}.output_conv", d.output_conv, nested=True))
    return convs


def _sequential(root: str, subs) -> list:
    """Layers in Sequential(conv, activation) but the bare last conv."""
    convs = []
    for i, d in enumerate(subs):
        n = len(d.layers)
        convs += [RefConv(f"{root}.{i}.layers.{j}" + (".0" if j < n - 1 else ""), c,
                          nested=True) for j, c in enumerate(d.layers)]
    return convs


def hifigan_discriminator_convs(disc) -> list:
    """MSD + MPD (models/vocoder/HiFiGAN.py:308-395)."""
    return _sequential("msd.discriminators", disc.msd.discriminators) + _mpd_convs(disc.mpd)


def univnet_discriminator_convs(disc) -> list:
    """MRSD + MPD (models/vocoder/UnivNet.py:23-103)."""
    return _sequential("mrsd.discriminators", disc.mrsd.discriminators) + _mpd_convs(disc.mpd)


# ---------------------------------------------------------------- loading

def _resolve(sd: dict, conv: RefConv) -> str:
    if not conv.nested:
        return conv.key
    base = conv.key.removesuffix(".0")
    for cand in (f"{base}.0", f"{base}.conv", base):
        if f"{cand}.weight" in sd or f"{cand}.weight_v" in sd:
            return cand
    return conv.key


def _copy(param, sd: dict, key: str, what: str, used: set) -> None:
    value = torch.as_tensor(sd[key]).detach()
    if tuple(value.shape) != tuple(param.shape):
        raise ValueError(f"{what}: shape mismatch at {key}: the checkpoint has "
                         f"{tuple(value.shape)}, the model expects {tuple(param.shape)}")
    with torch.no_grad():
        param.copy_(value.to(device=param.device, dtype=param.dtype))
    used.add(key)


def _load_conv(sd: dict, conv: RefConv, what: str, used: set) -> None:
    prefix, layer = _resolve(sd, conv), conv.layer
    if f"{prefix}.weight_v" in sd:
        if not layer.weight_norm:
            raise ValueError(f"{what}: {prefix} is weight-normed in the checkpoint, "
                             "not in the model")
        _copy(layer.v, sd, f"{prefix}.weight_v", what, used)
        _copy(layer.g, sd, f"{prefix}.weight_g", what, used)
    elif f"{prefix}.weight" in sd:
        if layer.weight_norm:
            raise ValueError(f"{what}: {prefix} is weight-normed in the model, "
                             "not in the checkpoint")
        # the parameter, not a spectral-normed layer's ``weight``
        _copy(layer._parameters["weight"], sd, f"{prefix}.weight", what, used)
    else:
        raise ValueError(f"{what}: no conv weight at '{prefix}.weight[_v]' in the checkpoint")
    if layer.bias is not None:
        if f"{prefix}.bias" not in sd:
            raise ValueError(f"{what}: the model's conv at {prefix} has a bias, the "
                             "checkpoint none")
        _copy(layer.bias, sd, f"{prefix}.bias", what, used)


def _load_all(sd: dict, convs: list, what: str, skip=()) -> set:
    """Load every conv; raise ValueError at a weight or bias of ``sd`` that
    no conv took, unless under one of the ``skip`` prefixes."""
    used: set = set()
    for conv in convs:
        _load_conv(sd, conv, what, used)
    for key in sd:
        if key in used or key.endswith("pad_buffer") or key.startswith(tuple(skip)):
            continue
        raise ValueError(f"{what}: the checkpoint's {key} fits no layer of the model")
    return used


def _stack_books(sd: dict, gen) -> VQState:
    layers = []
    while f"quantizer.codebook.layers.{len(layers)}.embed" in sd:
        layers.append(f"quantizer.codebook.layers.{len(layers)}")
    if not layers:
        raise ValueError("residual VQ state: no quantizer.codebook.layers.0.embed")
    parts = [np.stack([np.asarray(torch.as_tensor(sd[f"{b}.{name}"]).detach().cpu())
                       for b in layers])
             for name in ("embed", "cluster_size", "embed_avg")]
    try:
        return vq_state_from_jax(parts, gen)
    except ValueError as e:
        raise ValueError(f"residual VQ state: shape mismatch: {e}") from None


def import_audiodec_generator(sd: dict, gen):
    """A reference AudioDec generator state dict into ``gen`` (the port's
    ``AudioDecGenerator``, whose ``use_pqc`` decides whether the projector,
    the quantizer and the decoder input conv are read: the reference's
    without-PQC generator still constructs them, so its state dict carries
    them unused). Returns ``(gen, vq_state)``, ``vq_state`` a ``VQState`` on
    ``gen.device`` (None without PQC)."""
    skip = ("quantizer.",) if gen.use_pqc else ("quantizer.", "projector.", "decoder.conv1.")
    _load_all(sd, audiodec_convs(gen), "AudioDec generator", skip)
    return gen, (_stack_books(sd, gen) if gen.use_pqc else None)


def import_hifigan_generator(sd: dict, voc):
    """A reference HiFiGAN vocoder state dict into ``voc`` (either fusion
    form). Returns ``(voc, stats)``: ``stats`` the ``(2, C)`` [mean; scale]
    array of its input-norm buffers (HiFiGAN.py:206-219), else None; a
    ``voc`` built with statistics takes them into its buffers too."""
    _load_all(sd, hifigan_convs(voc), "HiFiGAN generator", ("mean", "scale"))
    stats = None
    if "mean" in sd and "scale" in sd:
        stats = np.stack([np.asarray(torch.as_tensor(sd[k]).detach().cpu(),
                                     np.float32).reshape(-1) for k in ("mean", "scale")])
    if getattr(voc, "norm", False) and stats is not None:
        used: set = set()
        for i, name in enumerate(("mean", "scale")):
            _copy(getattr(voc, name), {name: stats[i]}, name, "HiFiGAN generator", used)
    return voc, stats


def import_hifigan_discriminator(sd: dict, disc):
    """A reference HiFiGAN MSD + MPD state dict into ``disc``; returns it."""
    _load_all(sd, hifigan_discriminator_convs(disc), "HiFiGAN discriminator")
    return disc


def import_univnet_discriminator(sd: dict, disc):
    """A reference UnivNet MRSD + MPD state dict into ``disc`` (the MRSD's
    Hann ``window`` buffers are not weights); returns it."""
    skip = tuple(f"mrsd.discriminators.{i}.window"
                 for i in range(len(disc.mrsd.discriminators)))
    _load_all(sd, univnet_discriminator_convs(disc), "UnivNet discriminator", skip)
    return disc
