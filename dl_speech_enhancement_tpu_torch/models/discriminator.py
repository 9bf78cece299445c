"""GAN discriminators: HiFiGAN MPD / MSD and UnivNet MRSD, as ``nn.Module``s.

Counterpart of dl_speech_enhancement_tpu/models/discriminator.py. Each
returns per-layer feature lists with the final logits last, the contract of
the adversarial and feature-matching losses.

- **Layout**: waveforms come in as ``(B, T, 1)``, as everywhere in the
  port (the combined discriminators of models/hifigan.py and
  models/univnet.py take ``(B, T, C)`` and fold C into the batch); features
  leave in PyTorch's channels-first layouts, where the JAX
  package keeps channels last: the MSD's ``(B, C, T')``, the MPD's NCHW
  ``(B, C, T/P, P)`` (its last entry the flattened logits, in the same order
  as JAX's since C = 1), the MRSD's ``(B, 1, frames', freq')``. The losses
  are means over elements, so they do not see the layout.
- **Norms** as the reference runs them: weight norm on the MPD and MRSD
  convs; none on the MSD, whose ``follow_official_norm`` stays a no-op (the
  reference's norm hooks match only Conv2d). ``use_weight_norm`` /
  ``use_spectral_norm`` in ``discriminator_params`` turn real ones on.
- **Init**: torch's kaiming-uniform bound, drawn on the CPU from one
  ``torch.Generator`` seeded ``seed`` (the sub-discriminators in order) and
  moved to ``device``; tests carry JAX params across with
  ``utils/jax_params.py::discriminator_from_jax_params``.
- ``num_subs`` / ``apply_sub(i, x)``: sub-discriminator ``i``'s feature list
  alone, equal to ``forward(x)[i]``, for trainers that recompute one
  sub-discriminator at a time (``discriminator_remat``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from dl_speech_enhancement_tpu_torch.dsp.stft import hann_window, spectrogram
from dl_speech_enhancement_tpu_torch.nn.conv import Conv1d, Conv2d


def _layer_kw(generator):
    """Every discriminator layer is built on the CPU from ``generator``."""
    return {"generator": generator, "device": "cpu"}


def fold_channels(x: torch.Tensor) -> torch.Tensor:
    """(B, T, C) waveforms -> (B * C, T, 1): channels folded into the batch."""
    b, t, c = x.shape
    if c == 1:
        return x
    return x.permute(0, 2, 1).reshape(b * c, t, 1)


class HiFiGANPeriodDiscriminator(nn.Module):
    """Period discriminator (reference discriminator.py:26-157): the waveform
    folded to ``(B, 1, T/P, P)`` (reflect-padded at the end when P does not
    divide T), ``(k, 1)`` convs strided along T/P."""

    def __init__(self, in_channels=1, out_channels=1, period=3, kernel_sizes=(5, 3),
                 channels=32, downsample_scales=(3, 3, 3, 3, 1),
                 max_downsample_channels=1024, bias=True, negative_slope=0.1,
                 use_weight_norm=True, use_spectral_norm=False, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        if len(kernel_sizes) != 2 or kernel_sizes[0] % 2 != 1 or kernel_sizes[1] % 2 != 1:
            raise ValueError(f"kernel_sizes must be two odd sizes, got {kernel_sizes}")
        if use_spectral_norm:
            use_weight_norm = False  # mutually exclusive, as in the reference
        norms = dict(weight_norm=use_weight_norm, spectral_norm=use_spectral_norm,
                     **_layer_kw(generator))
        self.period = period
        self.negative_slope = negative_slope
        self.convs = nn.ModuleList()
        in_chs, out_chs = in_channels, channels
        for scale in downsample_scales:
            self.convs.append(Conv2d(in_chs, out_chs, (kernel_sizes[0], 1), (scale, 1),
                                     ((kernel_sizes[0] - 1) // 2, 0), bias, **norms))
            in_chs = out_chs
            out_chs = min(out_chs * 4, max_downsample_channels)
        self.output_conv = Conv2d(in_chs, out_channels, (kernel_sizes[1] - 1, 1), (1, 1),
                                  ((kernel_sizes[1] - 1) // 2, 0), bias, **norms)

    def forward(self, x: torch.Tensor) -> list:
        """x: (B, T, 1) -> features, the last the flattened logits (B, -1)."""
        x = x.transpose(1, 2)
        b, c, t = x.shape
        if t % self.period:
            x = F.pad(x, (0, self.period - t % self.period), mode="reflect")
            t = x.shape[-1]
        x = x.reshape(b, c, t // self.period, self.period)
        outs = []
        for conv in self.convs:
            x = F.leaky_relu(conv(x), self.negative_slope)
            outs.append(x)
        outs.append(self.output_conv(x).reshape(b, -1))
        return outs


def _clean(params: dict) -> dict:
    """The reference's YAML activation keys as a constructor's
    ``negative_slope``."""
    out = dict(params)
    nl = out.pop("nonlinear_activation", "LeakyReLU")
    nlp = out.pop("nonlinear_activation_params", {"negative_slope": 0.1})
    if nl != "LeakyReLU":
        raise NotImplementedError(f"discriminator activation {nl} is not supported")
    out["negative_slope"] = nlp.get("negative_slope", 0.1)
    return out


class HiFiGANMultiPeriodDiscriminator(nn.Module):
    """Reference discriminator.py:160-209."""

    def __init__(self, periods=(2, 3, 5, 7, 11), discriminator_params=None, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        params = dict(discriminator_params or {})
        params.pop("period", None)
        self.discriminators = nn.ModuleList(
            HiFiGANPeriodDiscriminator(period=p, **_clean(params), generator=generator)
            for p in periods)

    def forward(self, x: torch.Tensor) -> list:
        """x: (B, T, 1) -> one feature list per period."""
        return [d(x) for d in self.discriminators]

    def apply_sub(self, i: int, x: torch.Tensor) -> list:
        return self.discriminators[i](x)


class HiFiGANScaleDiscriminator(nn.Module):
    """Scale discriminator (reference discriminator.py:212-352): a first conv,
    grouped strided convs (groups 4, then x4 up to ``max_groups``), two
    output convs; LeakyReLU on all but the last. Plain convs by default."""

    def __init__(self, in_channels=1, out_channels=1, kernel_sizes=(15, 41, 5, 3),
                 channels=128, max_downsample_channels=1024, max_groups=16, bias=True,
                 downsample_scales=(2, 2, 4, 4, 1), negative_slope=0.1,
                 use_weight_norm=False, use_spectral_norm=False, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        if len(kernel_sizes) != 4 or any(k % 2 != 1 for k in kernel_sizes):
            raise ValueError(f"kernel_sizes must be four odd sizes, got {kernel_sizes}")
        if use_spectral_norm:
            use_weight_norm = False
        kw = dict(bias=bias, weight_norm=use_weight_norm, spectral_norm=use_spectral_norm,
                  **_layer_kw(generator))
        self.negative_slope = negative_slope
        self.layers = nn.ModuleList(
            [Conv1d(in_channels, channels, kernel_sizes[0], padding=(kernel_sizes[0] - 1) // 2,
                    **kw)])
        in_chs = out_chs = channels
        groups = 4
        for scale in downsample_scales:
            self.layers.append(Conv1d(in_chs, out_chs, kernel_sizes[1], stride=scale,
                                      padding=(kernel_sizes[1] - 1) // 2, groups=groups, **kw))
            in_chs = out_chs
            out_chs = min(in_chs * 2, max_downsample_channels)
            groups = min(groups * 4, max_groups)
        out_chs = min(in_chs * 2, max_downsample_channels)
        self.layers.append(Conv1d(in_chs, out_chs, kernel_sizes[2],
                                  padding=(kernel_sizes[2] - 1) // 2, **kw))
        self.layers.append(Conv1d(out_chs, out_channels, kernel_sizes[3],
                                  padding=(kernel_sizes[3] - 1) // 2, **kw))

    def forward(self, x: torch.Tensor) -> list:
        """x: (B, T, 1) -> per-layer features (B, C, T')."""
        x = x.transpose(1, 2)
        outs = []
        last = len(self.layers) - 1
        for i, layer in enumerate(self.layers):
            x = layer.forward_channels_first(x)
            if i < last:
                x = F.leaky_relu(x, self.negative_slope)
            outs.append(x)
        return outs


class HiFiGANMultiScaleDiscriminator(nn.Module):
    """Scales with ``AvgPool1d`` (count_include_pad) between them (reference
    discriminator.py:375-447). ``follow_official_norm`` is accepted and has
    no effect, as in the reference as it runs."""

    def __init__(self, scales=3, downsample_pooling="AvgPool1d",
                 downsample_pooling_params=None, discriminator_params=None,
                 follow_official_norm=False, *, generator: torch.Generator | None = None):
        super().__init__()
        if downsample_pooling != "AvgPool1d":
            raise NotImplementedError(f"downsample pooling {downsample_pooling}")
        del follow_official_norm
        self.pool_params = {"kernel_size": 4, "stride": 2, "padding": 2,
                            **(downsample_pooling_params or {})}
        params = _clean(dict(discriminator_params or {}))
        self.discriminators = nn.ModuleList(
            HiFiGANScaleDiscriminator(**params, generator=generator) for _ in range(scales))

    def _pool(self, x):
        """AvgPool1d over the T of (B, T, 1)."""
        y = F.avg_pool1d(x.transpose(1, 2), count_include_pad=True, **self.pool_params)
        return y.transpose(1, 2)

    def forward(self, x: torch.Tensor) -> list:
        outs = []
        for d in self.discriminators:
            outs.append(d(x))
            x = self._pool(x)
        return outs

    def apply_sub(self, i: int, x: torch.Tensor) -> list:
        for _ in range(i):
            x = self._pool(x)
        return self.discriminators[i](x)


class UnivNetSpectralDiscriminator(nn.Module):
    """Magnitude spectrogram -> 2-D conv stack (reference
    discriminator.py:450-570). Returns the final map only, not a list."""

    def __init__(self, fft_size, hop_size, win_length, window="hann_window",
                 kernel_sizes=((3, 9), (3, 9), (3, 9), (3, 9), (3, 3), (3, 3)),
                 strides=((1, 1), (1, 2), (1, 2), (1, 2), (1, 1), (1, 1)), channels=32,
                 bias=True, negative_slope=0.2, use_weight_norm=True, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        if window != "hann_window":
            raise NotImplementedError(f"window {window}")
        if len(kernel_sizes) != len(strides):
            raise ValueError("kernel_sizes and strides differ in length")
        self.fft_size, self.hop_size, self.win_length = fft_size, hop_size, win_length
        self.register_buffer("window", hann_window(win_length), persistent=False)
        self.negative_slope = negative_slope
        kw = dict(bias=bias, weight_norm=use_weight_norm, **_layer_kw(generator))
        n = len(kernel_sizes)
        self.layers = nn.ModuleList(
            Conv2d(1 if i == 0 else channels, 1 if i == n - 1 else channels,
                   tuple(kernel_sizes[i]), tuple(strides[i]), (0, 0), **kw)
            for i in range(n))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, T, 1) -> (B, 1, frames', freq')."""
        # a bf16 waveform meets the f32 window in f32, as jnp promotes them
        x = x.to(torch.promote_types(x.dtype, self.window.dtype))
        h = spectrogram(x[..., 0], self.window, n_fft=self.fft_size, hop=self.hop_size,
                        win_length=self.win_length, pad=self.win_length // 2)[:, None]
        last = len(self.layers) - 1
        for i, layer in enumerate(self.layers):
            h = layer(h)
            if i < last:
                h = F.leaky_relu(h, self.negative_slope)
        return h


class UnivNetMultiResolutionSpectralDiscriminator(nn.Module):
    """Spectral discriminators at several resolutions (reference
    discriminator.py:583-638)."""

    def __init__(self, fft_sizes=(1024, 2048, 512), hop_sizes=(120, 240, 50),
                 win_lengths=(600, 1200, 240), window="hann_window",
                 discriminator_params=None, *, generator: torch.Generator | None = None):
        super().__init__()
        if not len(fft_sizes) == len(hop_sizes) == len(win_lengths):
            raise ValueError("fft_sizes, hop_sizes and win_lengths differ in length")
        params = _clean(dict(discriminator_params or {}))
        self.discriminators = nn.ModuleList(
            UnivNetSpectralDiscriminator(f, h, w, window, **params, generator=generator)
            for f, h, w in zip(fft_sizes, hop_sizes, win_lengths))

    def forward(self, x: torch.Tensor) -> list:
        return [d(x) for d in self.discriminators]
