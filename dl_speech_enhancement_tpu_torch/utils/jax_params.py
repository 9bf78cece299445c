"""Carry a JAX param tree of the reference package into the port's modules.

The JAX package keeps params as nested dicts of arrays with conv weights
``(k, in, out)`` and transposed-conv weights conv-ready and tap-flipped
``(k, in, out)``. The port's layers hold PyTorch layouts. The two maps below
are the port's own copies of dl_speech_enhancement_tpu/utils/torch_export.py::
_w_out and ::_dw_out (the port imports nothing of the JAX package); inputs are
numpy arrays (``np.asarray`` of the JAX leaves). The JAX ``VQState`` (``embed
(L, D, K)``, ``cluster_size (L, K)``, ``embed_avg (L, D, K)``) keeps its layout
in the port; :func:`vq_state_from_jax` only checks and converts it.
"""

from __future__ import annotations

import numpy as np
import torch

from dl_speech_enhancement_tpu_torch.nn.vq import VQState


def _w_out(w) -> np.ndarray:
    """JAX (k, in, out) -> torch Conv1d (out, in, k)."""
    return np.asarray(w).transpose(2, 1, 0)


def _dw_out(w) -> np.ndarray:
    """JAX flipped (k, in, out) -> torch ConvTranspose1d (in, out, k)."""
    return np.asarray(w).transpose(1, 2, 0)[:, :, ::-1].copy()


def load_conv(layer, p: dict, transposed: bool = False) -> None:
    """Copy one JAX conv param dict ``{w[, b]}`` into a port conv layer."""
    if "v" in p:
        raise ValueError("weight-norm params {v, g} are not used by this generator")
    w = (_dw_out if transposed else _w_out)(p["w"])
    if tuple(w.shape) != tuple(layer.weight.shape):
        raise ValueError(f"weight shape {w.shape} does not fit {tuple(layer.weight.shape)}")
    if ("b" in p) != (layer.bias is not None):
        raise ValueError("bias presence differs between the params and the layer")
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(np.array(w, np.float32)))
        if layer.bias is not None:
            layer.bias.copy_(torch.from_numpy(np.array(p["b"], np.float32)))


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
