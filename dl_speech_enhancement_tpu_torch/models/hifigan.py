"""Causal HiFiGAN vocoder generator (the receiver of the AudioDec v0-v3
presets), as ``nn.Module``s.

Counterpart of the generator half of dl_speech_enhancement_tpu/models/
hifigan.py: input causal conv -> per stage (LeakyReLU -> causal transposed
conv upsample -> fusion block) -> LeakyReLU(0.01) -> output conv -> tanh.
Every conv is weight-normed with HiFiGAN's official N(0, 0.01) init. The
fusion block is a ``MultiGroupConv1d`` (one grouped residual block over the
input tiled ``groups`` times, then a 1x1 fuse; AudioDec v1) when there is
one resblock kernel size and ``groups > 1``, else a ``MultiReceptiveField``
(the average of several residual blocks; v0, v3).

Streaming: every module exposes ``init_cache(batch)`` and ``step(cache, x)
-> (y, new cache)`` with the JAX package's cache structure and convention
(each conv caches its own activated input rows). Activations are ``(B, T,
C)``. :class:`HiFiGANDiscriminator` pairs the MSD and the MPD of
models/discriminator.py for adversarial training.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dl_speech_enhancement_tpu_torch.models.discriminator import (
    HiFiGANMultiPeriodDiscriminator,
    HiFiGANMultiScaleDiscriminator,
    fold_channels,
)
from dl_speech_enhancement_tpu_torch.nn.conv import (
    CausalConv1d,
    CausalConvTranspose1d,
    Conv1d1x1,
)
from dl_speech_enhancement_tpu_torch.utils.device import resolve_device


def _wn(generator):
    """The keyword arguments of every HiFiGAN conv: weight norm, N(0, 0.01)
    init, built on the CPU from ``generator``."""
    return {"weight_norm": True, "w_init": "normal", "generator": generator, "device": "cpu"}


class HiFiGANResidualBlock(nn.Module):
    """Dilation units ``x <- x + conv2(leaky(conv1(leaky(x))))`` (conv2 only
    with ``use_additional_convs``). Reference modules/residual_block.py."""

    def __init__(self, kernel_size=3, channels=512, dilations=(1, 3, 5), groups=1,
                 bias=True, use_additional_convs=True, negative_slope=0.1, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        if kernel_size % 2 != 1:
            raise ValueError(f"kernel_size must be odd, got {kernel_size}")
        kw = dict(groups=groups, bias=bias, **_wn(generator))
        self.use_additional_convs = use_additional_convs
        self.negative_slope = negative_slope
        self.convs1 = nn.ModuleList(
            CausalConv1d(channels, channels, kernel_size, dilation=d, **kw) for d in dilations)
        self.convs2 = nn.ModuleList(
            CausalConv1d(channels, channels, kernel_size, dilation=1, **kw)
            for _ in (dilations if use_additional_convs else ()))

    def _leaky(self, x):
        return F.leaky_relu(x, self.negative_slope)

    def forward(self, x):
        for i, conv1 in enumerate(self.convs1):
            xt = conv1(self._leaky(x))
            if self.use_additional_convs:
                xt = self.convs2[i](self._leaky(xt))
            x = xt + x
        return x

    def init_cache(self, batch):
        cache = {"convs1": [c.init_cache(batch) for c in self.convs1]}
        if self.use_additional_convs:
            cache["convs2"] = [c.init_cache(batch) for c in self.convs2]
        return cache

    def step(self, cache, x):
        new1, new2 = [], []
        for i, conv1 in enumerate(self.convs1):
            xt, c1 = conv1.step(cache["convs1"][i], self._leaky(x))
            new1.append(c1)
            if self.use_additional_convs:
                xt, c2 = self.convs2[i].step(cache["convs2"][i], self._leaky(xt))
                new2.append(c2)
            x = xt + x
        new = {"convs1": new1}
        if self.use_additional_convs:
            new["convs2"] = new2
        return x, new


class MultiReceptiveField(nn.Module):
    """Average of residual blocks of different kernel sizes over the same
    input. Reference modules/multi_fusion.py:23-79."""

    def __init__(self, channels=512, resblock_kernel_sizes=(3, 7, 11),
                 resblock_dilations=((1, 3, 5),) * 3, groups=1, bias=True,
                 use_additional_convs=True, negative_slope=0.1, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        if len(resblock_kernel_sizes) != len(resblock_dilations):
            raise ValueError("resblock_kernel_sizes and resblock_dilations differ in length")
        self.blocks = nn.ModuleList(
            HiFiGANResidualBlock(k, channels, d, groups, bias, use_additional_convs,
                                 negative_slope, generator=generator)
            for k, d in zip(resblock_kernel_sizes, resblock_dilations))

    def forward(self, x):
        return sum(b(x) for b in self.blocks) / len(self.blocks)

    def init_cache(self, batch):
        return {"blocks": [b.init_cache(batch) for b in self.blocks]}

    def step(self, cache, x):
        ys, new = [], []
        for b, bc in zip(self.blocks, cache["blocks"]):
            y, c = b.step(bc, x)
            ys.append(y)
            new.append(c)
        return sum(ys) / len(self.blocks), {"blocks": new}


class MultiGroupConv1d(nn.Module):
    """One grouped residual block over the input tiled ``groups`` times, then
    a 1x1 fuse back to ``channels``: AudioDec v1's fast decoder
    (modules/multi_fusion.py:82-141)."""

    def __init__(self, channels=512, resblock_kernel_sizes=(3,), resblock_dilations=((1, 3, 5),),
                 groups=3, bias=True, use_additional_convs=True, negative_slope=0.1, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        if not len(resblock_kernel_sizes) == len(resblock_dilations) == 1:
            raise ValueError("MultiGroupConv1d takes one resblock kernel size")
        self.groups = groups
        self.block = HiFiGANResidualBlock(resblock_kernel_sizes[0], channels * groups,
                                          resblock_dilations[0], groups, bias,
                                          use_additional_convs, negative_slope,
                                          generator=generator)
        self.conv_out = Conv1d1x1(channels * groups, channels, bias=False, **_wn(generator))

    def forward(self, x):
        return self.conv_out(self.block(x.repeat(1, 1, self.groups)))

    def init_cache(self, batch):
        return {"block": self.block.init_cache(batch)}

    def step(self, cache, x):
        x, c = self.block.step(cache["block"], x.repeat(1, 1, self.groups))
        return self.conv_out(x), {"block": c}


class HiFiGANGenerator(nn.Module):
    """Causal HiFiGAN generator (reference HiFiGAN.py:28-305).

    ``stats`` is an optional ``(2, in_channels)`` array ``[mean; scale]`` of
    the analyzer's statistics: inputs are normalised ``(c - mean) / scale``
    first (HiFiGAN.py:206-219). Weights are drawn from ``generator`` (a fresh
    one seeded with ``seed`` if not given) on the CPU and moved to
    ``device``."""

    def __init__(self, in_channels=80, out_channels=1, channels=512, kernel_size=7,
                 upsample_scales=(8, 8, 2, 2), upsample_kernel_sizes=(16, 16, 4, 4),
                 resblock_kernel_sizes=(3, 7, 11),
                 resblock_dilations=((1, 3, 5), (1, 3, 5), (1, 3, 5)), groups=1, bias=True,
                 use_additional_convs=True, negative_slope=0.1, stats=None, *, seed: int = 0,
                 generator: torch.Generator | None = None, device="cuda"):
        super().__init__()
        if kernel_size % 2 != 1:
            raise ValueError(f"kernel_size must be odd, got {kernel_size}")
        if len(upsample_scales) != len(upsample_kernel_sizes):
            raise ValueError("upsample_scales and upsample_kernel_sizes differ in length")
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(seed)
        if len(resblock_kernel_sizes) == 1 and groups > 1:
            fusion_cls = MultiGroupConv1d
        else:
            fusion_cls = MultiReceptiveField
        self.negative_slope = negative_slope
        self.num_upsamples = len(upsample_kernel_sizes)
        self.input_conv = CausalConv1d(in_channels, channels, kernel_size, **_wn(generator))
        self.upsamples, self.blocks = nn.ModuleList(), nn.ModuleList()
        for i, (scale, k) in enumerate(zip(upsample_scales, upsample_kernel_sizes)):
            if k != 2 * scale:
                raise ValueError(f"upsample kernel {k} must be twice its scale {scale}")
            self.upsamples.append(CausalConvTranspose1d(
                channels // 2 ** i, channels // 2 ** (i + 1), k, scale, **_wn(generator)))
            self.blocks.append(fusion_cls(
                channels=channels // 2 ** (i + 1), resblock_kernel_sizes=resblock_kernel_sizes,
                resblock_dilations=resblock_dilations, groups=groups, bias=bias,
                use_additional_convs=use_additional_convs, negative_slope=negative_slope,
                generator=generator))
        self.output_conv = CausalConv1d(channels // 2 ** self.num_upsamples, out_channels,
                                        kernel_size, **_wn(generator))
        self.total_upsample = int(np.prod(upsample_scales))
        self.norm = stats is not None
        if self.norm:
            stats = np.asarray(stats, np.float32)
            self.register_buffer("mean", torch.from_numpy(stats[0].reshape(-1).copy()))
            self.register_buffer("scale", torch.from_numpy(stats[1].reshape(-1).copy()))
        self.to(device)

    @property
    def device(self) -> torch.device:
        return self.input_conv.v.device

    def _normalize(self, c):
        return (c - self.mean) / self.scale if self.norm else c

    def forward(self, c):
        """c: (B, T, in_channels) -> audio (B, T * total_upsample, out_channels)."""
        c = self.input_conv(self._normalize(c))
        for up, blk in zip(self.upsamples, self.blocks):
            c = blk(up(F.leaky_relu(c, self.negative_slope)))
        # upstream uses the default LeakyReLU slope (0.01) before the output
        # conv (HiFiGAN.py:116), unlike the 0.1 used elsewhere
        return torch.tanh(self.output_conv(F.leaky_relu(c, 0.01)))

    def init_cache(self, batch):
        return {"input_conv": self.input_conv.init_cache(batch),
                "upsamples": [u.init_cache(batch) for u in self.upsamples],
                "blocks": [b.init_cache(batch) for b in self.blocks],
                "output_conv": self.output_conv.init_cache(batch)}

    def step(self, cache, c):
        """Streaming decode of one chunk of codes (HiFiGAN.py:268-296)."""
        c, ic = self.input_conv.step(cache["input_conv"], self._normalize(c))
        new_up, new_blocks = [], []
        for i, (up, blk) in enumerate(zip(self.upsamples, self.blocks)):
            c, uc = up.step(cache["upsamples"][i], F.leaky_relu(c, self.negative_slope))
            new_up.append(uc)
            c, bc = blk.step(cache["blocks"][i], c)
            new_blocks.append(bc)
        c, oc = self.output_conv.step(cache["output_conv"], F.leaky_relu(c, 0.01))
        return torch.tanh(c), {"input_conv": ic, "upsamples": new_up, "blocks": new_blocks,
                               "output_conv": oc}


class HiFiGANDiscriminator(nn.Module):
    """MSD + MPD (reference HiFiGAN.py:308-395): the two discriminators'
    feature lists concatenated, MSD scales first. Weights are drawn from
    ``generator`` (a fresh one seeded with ``seed`` if not given), MSD then
    MPD, on the CPU and moved to ``device``."""

    def __init__(self, scales=3, scale_downsample_pooling="AvgPool1d",
                 scale_downsample_pooling_params=None, scale_discriminator_params=None,
                 follow_official_norm=True, periods=(2, 3, 5, 7, 11),
                 period_discriminator_params=None, *, seed: int = 0,
                 generator: torch.Generator | None = None, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(seed)
        self.msd = HiFiGANMultiScaleDiscriminator(
            scales, scale_downsample_pooling, scale_downsample_pooling_params,
            scale_discriminator_params, follow_official_norm, generator=generator)
        self.mpd = HiFiGANMultiPeriodDiscriminator(periods, period_discriminator_params,
                                                   generator=generator)
        self.to(device)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def forward(self, x):
        """x: (B, T, C) waveform -> one feature list per sub-discriminator."""
        x = fold_channels(x)
        return self.msd(x) + self.mpd(x)

    @property
    def num_subs(self) -> int:
        return len(self.msd.discriminators) + len(self.mpd.discriminators)

    def apply_sub(self, i: int, x):
        """Feature list of sub-discriminator ``i`` alone, equal to
        ``forward(x)[i]``: MSD scales first, then MPD periods."""
        x = fold_channels(x)
        n_msd = len(self.msd.discriminators)
        if i < n_msd:
            return self.msd.apply_sub(i, x)
        return self.mpd.apply_sub(i - n_msd, x)
