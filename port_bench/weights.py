"""Seeded weights, made on the device from ``--seed`` in a few large draws.

A model's state dict is laid out from its configuration alone, under the
keys the port's modules use (``AudioDecGenerator``, ``HiFiGANGenerator``),
in PyTorch layouts. The same tensors are loaded into the port's modules and
handed to the plain reference, which works everything else out again.

- AudioDec convs: torch's default init, U(-1/sqrt(fan_in), 1/sqrt(fan_in))
  for weights and biases (fan_in = k * in / groups; k * out for a
  transposed conv).
- HiFiGAN convs are weight-normed: ``v`` ~ N(0, 0.01), and each gain ``g``
  the conv's unit gain times U(0.8, 1.25), as the port's ``chip_smoke.py``
  sets them so that no layer fades to its bias at random weights: 1 a
  conv's output channel, sqrt(k * out / (2 * in)) a transposed conv's input
  channel (each output sums 2 taps of every input), half of 1 at the output
  conv, whose input the residual sums have grown. Biases as above.
- The receiver's input statistics: mean N(0, 1), scale U(0.5, 2).
"""

from __future__ import annotations

import math

import torch

from port_bench.flops import CHAIN_DILATIONS, CHAIN_KERNEL, levels, mpd_layers, msd_layers, stages


def audiodec_layout(gp: dict, use_pqc: bool) -> list:
    """``(key, shape, fan_in)`` of every tensor of an AudioDec generator."""
    enc, dec = levels(gp)
    out = [("encoder.conv.weight", (gp["encode_channels"], 1, 7), 7)]

    def units(prefix, c):
        for j in range(len(CHAIN_DILATIONS)):
            out.append((f"{prefix}.res_units.{j}.conv1.weight", (c, c, CHAIN_KERNEL),
                        CHAIN_KERNEL * c))
            out.append((f"{prefix}.res_units.{j}.conv2.weight", (c, c, 1), c))

    for i, (cin, cout, s) in enumerate(enc):
        units(f"encoder.blocks.{i}", cin)
        out.append((f"encoder.blocks.{i}.conv.weight", (cout, cin, 2 * s), 2 * s * cin))
        if gp["bias"]:
            out.append((f"encoder.blocks.{i}.conv.bias", (cout,), 2 * s * cin))
    if use_pqc:
        c, d = enc[-1][1], gp["code_dim"]
        out.append(("decoder.conv1.weight", (dec[0][0], d, 7), 7 * d))
    for i, (cin, cout, s) in enumerate(dec):
        out.append((f"decoder.blocks.{i}.conv.weight", (cin, cout, 2 * s), 2 * s * cout))
        if gp["bias"]:
            out.append((f"decoder.blocks.{i}.conv.bias", (cout,), 2 * s * cout))
        units(f"decoder.blocks.{i}", cout)
    out.append(("decoder.conv2.weight", (1, dec[-1][1], 7), 7 * dec[-1][1]))
    if use_pqc:
        out.append(("projector.conv.weight", (gp["code_dim"], enc[-1][1], 3), 3 * enc[-1][1]))
    return out


def audiodec_state(gp: dict, use_pqc: bool, seed: int, device) -> dict:
    """The generator's state dict, every tensor from one uniform draw."""
    layout = audiodec_layout(gp, use_pqc)
    rng = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(sum(math.prod(s) for _, s, _ in layout), generator=rng, device=device)
    state, at = {}, 0
    for key, shape, fan_in in layout:
        n = math.prod(shape)
        state[key] = (flat[at:at + n].view(shape) * 2.0 - 1.0) / math.sqrt(fan_in)
        at += n
    return state


def hifigan_layout(vp: dict) -> list:
    """``(prefix, v shape, fan_in, gain, bias)`` of every weight-normed conv
    of a MultiGroupConv1d HiFiGAN receiver (AudioDec v1)."""
    d, ch, k = vp["in_channels"], vp["channels"], vp["kernel_size"]
    out = [("input_conv", (ch, d, k), k * d, 1.0, True)]
    groups, kr = vp["groups"], vp["resblock_kernel_sizes"][0]
    for i, (cin, cout, s) in enumerate(stages(vp)):
        out.append((f"upsamples.{i}", (cin, cout, 2 * s), 2 * s * cout,
                    math.sqrt(2 * s * cout / (2.0 * cin)), True))
        gc = cout * groups
        for conv in ("convs1", "convs2"):
            for j in range(len(vp["resblock_dilations"][0])):
                out.append((f"blocks.{i}.block.{conv}.{j}", (gc, cout, kr), kr * cout, 1.0,
                            True))
        out.append((f"blocks.{i}.conv_out", (cout, gc, 1), gc, 1.0, False))
    c = stages(vp)[-1][1]
    out.append(("output_conv", (vp["out_channels"], c, k), k * c, 0.5, True))
    return out


def hifigan_state(vp: dict, seed: int, device) -> dict:
    """The receiver's state dict (``v``, ``g``, ``bias`` a conv, and the
    ``mean`` / ``scale`` statistics) from three draws: normal ``v``s, uniform
    gains and biases, the statistics."""
    layout = hifigan_layout(vp)
    rng = torch.Generator(device=device).manual_seed(seed)
    n_v = sum(math.prod(shape) for _, shape, _, _, _ in layout)
    n_u = sum(shape[0] + (shape[1] if p.startswith("upsamples") else shape[0]) * b
              for p, shape, _, _, b in layout)
    normal = torch.randn(n_v, generator=rng, device=device) * 0.01
    uniform = torch.rand(n_u, generator=rng, device=device)
    d = vp["in_channels"]
    stats = torch.randn(d, generator=rng, device=device), torch.rand(d, generator=rng,
                                                                       device=device)
    state, at_v, at_u = {}, 0, 0
    for prefix, shape, fan_in, gain, has_bias in layout:
        n = math.prod(shape)
        state[f"{prefix}.v"] = normal[at_v:at_v + n].view(shape)
        at_v += n
        g_shape = (shape[0],) + (1,) * (len(shape) - 1)
        state[f"{prefix}.g"] = gain * (0.8 + 0.45 * uniform[at_u:at_u + shape[0]]).view(g_shape)
        at_u += shape[0]
        if has_bias:
            n_out = shape[1] if prefix.startswith("upsamples") else shape[0]
            state[f"{prefix}.bias"] = (uniform[at_u:at_u + n_out] * 2.0 - 1.0) / math.sqrt(fan_in)
            at_u += n_out
    state["mean"], state["scale"] = stats[0], 0.5 + 1.5 * stats[1]
    return state


def discriminator_state(dp: dict, seed: int, device) -> dict:
    """The course discriminator's (MSD + MPD) state dict from one uniform
    draw: torch's default init; the MPD's convs weight-normed with ``g`` the
    norm of ``v``, so each starts at its drawn weight."""
    layout = []
    for s in range(dp["scales"]):
        for i, (cin, cout, k, _, _, g) in enumerate(msd_layers(dp["scale_discriminator_params"])):
            layout.append((f"msd.discriminators.{s}.layers.{i}", (cout, cin // g, k),
                           k * cin // g, False))
    pp = dp["period_discriminator_params"]
    norm = pp.get("use_weight_norm", True)
    for j, _ in enumerate(dp["periods"]):
        convs = mpd_layers(pp)
        for i, (cin, cout, kh, _, _) in enumerate(convs):
            name = "output_conv" if i == len(convs) - 1 else f"convs.{i}"
            layout.append((f"mpd.discriminators.{j}.{name}", (cout, cin, kh, 1), kh * cin, norm))
    rng = torch.Generator(device=device).manual_seed(seed)
    total = sum(math.prod(shape) + shape[0] for _, shape, _, _ in layout)
    flat = torch.rand(total, generator=rng, device=device) * 2.0 - 1.0
    state, at = {}, 0
    for prefix, shape, fan_in, weight_norm in layout:
        n = math.prod(shape)
        w = flat[at:at + n].view(shape) / math.sqrt(fan_in)
        at += n
        if weight_norm:
            state[f"{prefix}.v"] = w
            state[f"{prefix}.g"] = torch.sqrt((w * w).sum(dim=(1, 2, 3), keepdim=True))
        else:
            state[f"{prefix}.weight"] = w
        state[f"{prefix}.bias"] = flat[at:at + shape[0]] / math.sqrt(fan_in)
        at += shape[0]
    return state
