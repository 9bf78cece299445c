"""Plain PyTorch causal HiFiGAN receiver in f32 (AudioDec v1: a
MultiGroupConv1d fusion block a stage), for the benchmark's checks.

Written from the model's equations (AudioDec ``models/vocoder/HiFiGAN.py``
and ``modules/multi_fusion.py``) on one state dict of PyTorch-layout tensors
keyed as the benchmark names them. Every conv is weight-normed: the
effective weight is ``v * g / ||v||``, the norm over every dim but 0, worked
out here from ``v`` and ``g``. Inputs are normalised ``(c - mean) / scale``
by the statistics in the state. Causal layers start from zeros, as a fresh
stream does (see reference/audiodec.py). Activations are ``(B, C, T)``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from port_bench.reference.audiodec import causal_conv, causal_upsample


def weight(state, prefix: str):
    v, g = state[f"{prefix}.v"], state[f"{prefix}.g"]
    norm = torch.sqrt((v * v).sum(dim=tuple(range(1, v.dim())), keepdim=True))
    return v * (g / norm.clamp_min(1e-12))


def receive(state, vp: dict, c):
    """(B, in_channels, rows) features -> (B, 1, rows * prod(scales)) audio."""
    slope, groups = vp["negative_slope"], vp["groups"]
    c = (c - state["mean"][:, None]) / state["scale"][:, None]
    c = causal_conv(c, weight(state, "input_conv"), state.get("input_conv.bias"))
    for i, s in enumerate(vp["upsample_scales"]):
        c = causal_upsample(F.leaky_relu(c, slope), weight(state, f"upsamples.{i}"),
                            state.get(f"upsamples.{i}.bias"), s)
        p = f"blocks.{i}.block"
        x = c.repeat(1, groups, 1)
        for j, d in enumerate(vp["resblock_dilations"][0]):
            h = causal_conv(F.leaky_relu(x, slope), weight(state, f"{p}.convs1.{j}"),
                            state.get(f"{p}.convs1.{j}.bias"), dilation=d, groups=groups)
            h = causal_conv(F.leaky_relu(h, slope), weight(state, f"{p}.convs2.{j}"),
                            state.get(f"{p}.convs2.{j}.bias"), groups=groups)
            x = x + h
        c = F.conv1d(x, weight(state, f"blocks.{i}.conv_out"))
    # HiFiGAN's output conv follows LeakyReLU's default slope, 0.01
    return torch.tanh(causal_conv(F.leaky_relu(c, 0.01), weight(state, "output_conv"),
                                  state.get("output_conv.bias")))
