"""Carry a JAX param tree of the reference package into the port's modules.

The JAX package keeps params as nested dicts of arrays with conv weights
``(k, in, out)`` and transposed-conv weights conv-ready and tap-flipped
``(k, in, out)``. The port's layers hold PyTorch layouts. The two maps below
are the port's own copies of dl_speech_enhancement_tpu/utils/torch_export.py::
_w_out and ::_dw_out (the port imports nothing of the JAX package); inputs are
numpy arrays (``np.asarray`` of the JAX leaves). The JAX ``VQState`` (``embed
(L, D, K)``, ``cluster_size (L, K)``, ``embed_avg (L, D, K)``) keeps its layout
in the port; :func:`vq_state_from_jax` only checks and converts it.

Weight-normed convs (the vocoder's) carry ``{v, g[, b]}``: ``v`` maps as
``w`` does, and ``g`` from JAX's ``(1, 1, out)`` (conv) or ``(1, in, 1)``
(transposed conv) to the port's ``(out, 1, 1)`` or ``(in, 1, 1)``. A grouped
conv's JAX weight is ``(k, in / groups, out)``, with group g owning output
columns ``[g * out / groups, (g + 1) * out / groups)``, which maps onto
PyTorch's grouped ``(out, in / groups, k)`` as it is. A 2-D conv's JAX
weight is HWIO ``(kh, kw, in, out)``, PyTorch's ``(out, in, kh, kw)``
(:func:`discriminator_from_jax_params`); its weight-norm ``g`` goes from
``(1, 1, 1, out)`` to ``(out, 1, 1, 1)``.
"""

from __future__ import annotations

import numpy as np
import torch

from dl_speech_enhancement_tpu_torch.models.hifigan import HiFiGANDiscriminator, MultiGroupConv1d
from dl_speech_enhancement_tpu_torch.nn.conv import Conv2d
from dl_speech_enhancement_tpu_torch.nn.vq import VQState


def _w_out(w) -> np.ndarray:
    """JAX (k, in, out) -> torch Conv1d (out, in, k)."""
    return np.asarray(w).transpose(2, 1, 0)


def _dw_out(w) -> np.ndarray:
    """JAX flipped (k, in, out) -> torch ConvTranspose1d (in, out, k)."""
    return np.asarray(w).transpose(1, 2, 0)[:, :, ::-1].copy()


def _copy(param, value, what) -> None:
    value = np.asarray(value, np.float32)
    if tuple(value.shape) != tuple(param.shape):
        raise ValueError(f"{what} shape {value.shape} does not fit {tuple(param.shape)}")
    with torch.no_grad():
        param.copy_(torch.from_numpy(value.copy()))


def _w2d_out(w) -> np.ndarray:
    """JAX HWIO (kh, kw, in, out) -> torch Conv2d (out, in, kh, kw)."""
    return np.asarray(w).transpose(3, 2, 0, 1)


def load_conv(layer, p: dict, transposed: bool = False) -> None:
    """Copy one JAX conv param dict, ``{w[, b]}`` or with weight norm ``{v,
    g[, b]}``, into a port conv layer (1-D, transposed 1-D or 2-D)."""
    if ("v" in p) != layer.weight_norm:
        raise ValueError(f"params {sorted(p)} do not fit a layer with "
                         f"weight_norm={layer.weight_norm}")
    if ("b" in p) != (layer.bias is not None):
        raise ValueError("bias presence differs between the params and the layer")
    w_map = _dw_out if transposed else _w2d_out if isinstance(layer, Conv2d) else _w_out
    if layer.weight_norm:
        _copy(layer.v, w_map(p["v"]), "weight")
        _copy(layer.g, np.asarray(p["g"]).reshape(-1, *(1,) * (layer.v.ndim - 1)),
              "weight norm g")
    else:  # the parameter, not the spectral-normed ``layer.weight``
        _copy(layer._parameters["weight"], w_map(p["w"]), "weight")
    if layer.bias is not None:
        _copy(layer.bias, p["b"], "bias")


def _load_res_units(units, ps) -> None:
    for u, up in zip(units, ps, strict=True):
        load_conv(u.conv1, up["conv1"])
        load_conv(u.conv2, up["conv2"])


def from_jax_params(gen, params: dict):
    """Copy ``params`` (the ``params`` half of the JAX ``gen.init(key)``) into
    the port's ``AudioDecGenerator`` ``gen``; returns ``gen``. With PQC the
    params carry ``projector`` and ``decoder.conv1``, without they must not."""
    pqc = ("projector" in params, "conv1" in params["decoder"])
    if pqc != (gen.use_pqc, gen.use_pqc):
        raise ValueError(f"params with projector/decoder.conv1 {pqc} do not fit a "
                         f"generator with use_pqc={gen.use_pqc}")
    enc = params["encoder"]
    load_conv(gen.encoder.conv, enc["conv"])
    for blk, bp in zip(gen.encoder.blocks, enc["blocks"], strict=True):
        _load_res_units(blk.res_units, bp["res"])
        load_conv(blk.conv, bp["conv"])
    if gen.use_pqc:
        load_conv(gen.projector.conv, params["projector"]["conv"])
    dec = params["decoder"]
    if gen.use_pqc:
        load_conv(gen.decoder.conv1, dec["conv1"])
    for blk, bp in zip(gen.decoder.blocks, dec["blocks"], strict=True):
        load_conv(blk.conv, bp["conv"], transposed=True)
        _load_res_units(blk.res_units, bp["res"])
    load_conv(gen.decoder.conv2, dec["conv2"])
    return gen


def _load_resblock(blk, p) -> None:
    for conv, cp in zip(blk.convs1, p["convs1"], strict=True):
        load_conv(conv, cp)
    if ("convs2" in p) != blk.use_additional_convs:
        raise ValueError("convs2 presence differs between the params and the block")
    for conv, cp in zip(blk.convs2, p.get("convs2", []), strict=True):
        load_conv(conv, cp)


def vocoder_from_jax_params(voc, params: dict):
    """Copy ``params`` (the JAX ``HiFiGANGenerator.init(key)``) into the
    port's ``HiFiGANGenerator`` ``voc``; returns ``voc``. The analyzer
    statistics are not params: both generators take them as ``stats``."""
    load_conv(voc.input_conv, params["input_conv"])
    for up, up_p in zip(voc.upsamples, params["upsamples"], strict=True):
        load_conv(up, up_p, transposed=True)
    for blk, bp in zip(voc.blocks, params["blocks"], strict=True):
        if isinstance(blk, MultiGroupConv1d):
            _load_resblock(blk.block, bp["block"])
            load_conv(blk.conv_out, bp["conv_out"])
        else:
            for sub, sp in zip(blk.blocks, bp["blocks"], strict=True):
                _load_resblock(sub, sp)
    load_conv(voc.output_conv, params["output_conv"])
    return voc


def _load_subs(subs, ps, layers: str) -> None:
    for d, dp in zip(subs, ps["discriminators"], strict=True):
        for layer, lp in zip(getattr(d, layers), dp[layers], strict=True):
            load_conv(layer, lp)


def _load_mpd(mpd, p) -> None:
    for d, dp in zip(mpd.discriminators, p["discriminators"], strict=True):
        for conv, cp in zip(d.convs, dp["convs"], strict=True):
            load_conv(conv, cp)
        load_conv(d.output_conv, dp["output_conv"])


def discriminator_from_jax_params(disc, params: dict):
    """Copy ``params`` (the JAX discriminator's ``init(key)``, numpy leaves)
    into the port's ``HiFiGANDiscriminator`` (``{msd, mpd}``) or
    ``UnivNetDiscriminator`` (``{mrsd, mpd}``) ``disc``; returns ``disc``.
    Raises ValueError where a shape, a norm's parameters or a bias do not
    fit."""
    if isinstance(disc, HiFiGANDiscriminator):
        _load_subs(disc.msd.discriminators, params["msd"], "layers")
    else:
        _load_subs(disc.mrsd.discriminators, params["mrsd"], "layers")
    _load_mpd(disc.mpd, params["mpd"])
    return disc


def vq_state_from_jax(vq_state, gen=None) -> VQState:
    """The JAX ``VQState`` (``embed``, ``cluster_size``, ``embed_avg`` as
    numpy arrays) as the port's, in f32. Raises ValueError unless the shapes
    are (L, D, K), (L, K), (L, D, K) and, with ``gen``, fit its quantizer;
    with ``gen`` the tensors land on ``gen.device``, else on the CPU."""
    embed, cluster_size, embed_avg = (np.asarray(x, np.float32) for x in vq_state)
    if embed.ndim != 3:
        raise ValueError(f"embed must be (L, D, K), got {embed.shape}")
    n_books, _, book_k = embed.shape
    if cluster_size.shape != (n_books, book_k) or embed_avg.shape != embed.shape:
        raise ValueError(f"VQState shapes {embed.shape}, {cluster_size.shape}, "
                         f"{embed_avg.shape} do not fit one another")
    device = "cpu"
    if gen is not None:
        q = gen.quantizer if gen.use_pqc else None
        want = None if q is None else (q.codebook_num, q.code_dim, q.codebook_size)
        if embed.shape != want:
            raise ValueError(f"embed {embed.shape} does not fit the generator's "
                             f"quantizer {want}")
        device = gen.device
    return VQState(*(torch.from_numpy(x.copy()).to(device)
                     for x in (embed, cluster_size, embed_avg)))
