"""Plain PyTorch AudioDec generators in f32: the without-PQC denoiser and the
symAD codec's transmitter (encoder, projector, residual-VQ distances), for
the benchmark's checks.

Written from the model's equations (AudioDec, facebookresearch/AudioDec,
``models/autoencoder/AudioDec.py`` and its modules), on one state dict of
PyTorch-layout tensors: conv weights ``(out, in, k)``, transposed-conv
weights ``(in, out, k)``, keys as the benchmark names them (the port's
module paths). Imports nothing of the program and takes nothing it made.

The streams the benchmark serves start from a fresh cache, so every layer
here sees zeros before a stream's first sample: a causal conv pads
``(k - 1) * dilation`` zeros on the left, a causal transposed conv of stride
s (kernel 2 s) prepends one zero row and trims s samples at each end. A whole
stream's history through these functions is what a streaming run that
carries its caches from the start computes. Activations are ``(B, C, T)``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

DILATIONS = (1, 3, 9)


def causal_conv(x, w, b=None, stride: int = 1, dilation: int = 1, groups: int = 1):
    pad = (w.shape[-1] - 1) * dilation
    return F.conv1d(F.pad(x, (pad, 0)), w, b, stride, 0, dilation, groups)


def causal_upsample(x, w, b, stride: int):
    """Stride-s transposed conv of kernel 2s after one zero row: output row t
    reads input rows t // s - 1 and t // s."""
    return F.conv_transpose1d(F.pad(x, (1, 0)), w, b, stride, padding=stride)


def residual_units(state, prefix: str, x):
    for j, d in enumerate(DILATIONS):
        p = f"{prefix}.res_units.{j}"
        h = causal_conv(F.elu(x), state[f"{p}.conv1.weight"], state.get(f"{p}.conv1.bias"),
                        dilation=d)
        x = x + F.conv1d(F.elu(h), state[f"{p}.conv2.weight"], state.get(f"{p}.conv2.bias"))
    return x


def encode(state, gp: dict, x):
    """(B, 1, T) audio -> (B, C, T / hop) encoder features."""
    h = causal_conv(x, state["encoder.conv.weight"], state.get("encoder.conv.bias"))
    for i, s in enumerate(gp["enc_strides"]):
        p = f"encoder.blocks.{i}"
        h = residual_units(state, p, h)
        h = causal_conv(h, state[f"{p}.conv.weight"], state.get(f"{p}.conv.bias"), stride=s)
    return h


def project(state, e):
    """Encoder features -> projector output z (B, code_dim, rows)."""
    return causal_conv(e, state["projector.conv.weight"], state.get("projector.conv.bias"))


def decode(state, gp: dict, e):
    """Encoder features (without PQC) -> (B, 1, T) audio."""
    h = e
    for i, s in enumerate(gp["dec_strides"]):
        p = f"decoder.blocks.{i}"
        h = causal_upsample(h, state[f"{p}.conv.weight"], state.get(f"{p}.conv.bias"), s)
        h = residual_units(state, p, h)
    return causal_conv(h, state["decoder.conv2.weight"], state.get("decoder.conv2.bias"))


def denoise(state, gp: dict, x):
    return decode(state, gp, encode(state, gp, x))


def code_gaps(z, books, codes):
    """How far the given residual-VQ codes lie from the nearest codewords.

    ``z`` (rows, D) projector rows, ``books`` (L, D, K), ``codes`` (rows, L)
    int, flattened as the wire carries them (book l's code + l * K). Book by
    book, on the residual the given codes leave: the squared distance of the
    given codeword minus the least squared distance, over the row's squared
    norm. Returns the gap of every (row, book), (rows, L); 0 where the code
    is the nearest."""
    n_books, _, k = books.shape
    r = z.double()
    scale = (r * r).sum(1).clamp_min(1e-30)
    gaps = []
    for l in range(n_books):
        e = books[l].double()
        dist = (r * r).sum(1, keepdim=True) - 2.0 * (r @ e) + (e * e).sum(0)
        ind = codes[:, l].long() - l * k
        if bool(((ind < 0) | (ind >= k)).any()):
            raise ValueError(f"book {l}: a code outside [0, {k})")
        chosen = dist.gather(1, ind[:, None])[:, 0]
        gaps.append((chosen - dist.min(1).values) / scale)
        r = r - e.t()[ind]
    return torch.stack(gaps, 1)


def lookup(books, codes):
    """Flattened codes (rows, L) -> summed codewords (rows, D)."""
    n_books, _, k = books.shape
    out = 0.0
    for l in range(n_books):
        out = out + books[l].t()[codes[:, l].long() - l * k]
    return out
