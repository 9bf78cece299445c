"""1-D convolutions with streaming caches, in PyTorch.

Counterpart of dl_speech_enhancement_tpu/nn/conv.py for the layers the
streaming generator uses:

- **Layout**: every public method takes and returns ``(B, T, C)``
  activations, as the JAX package does; the layers transpose to PyTorch's
  ``(B, C, T)`` around ``F.conv1d`` / ``F.conv_transpose1d``.
- **Weights** are ``nn.Parameter``s in PyTorch's own layouts: Conv1d
  ``(out, in, k)``, ConvTranspose1d ``(in, out, k)``. The JAX package stores
  ``(k, in, out)``, and the transposed kernel conv-ready and tap-flipped;
  utils/jax_params.py maps one onto the other.
- **Streaming**: causal layers expose ``init_cache(batch)`` and
  ``step(cache, x) -> (y, new_cache)``, with the cache a ``(B, pad, C)``
  tensor holding the last input rows, exactly as the reference's caches.
- **Init**: the reference's torch-default kaiming-uniform bound
  ``1/sqrt(fan_in)``, or with ``w_init="normal"`` HiFiGAN's official
  N(0, 0.01) weights, drawn on the CPU from an explicit ``torch.Generator``
  and then moved to ``device``. Same distributions as the JAX init, other
  numbers; tests carry JAX params across with utils/jax_params.py.
- **Weight norm** (``weight_norm=True``): the layer holds parameters ``v``
  and ``g`` and ``layer.weight`` is the effective weight ``v * g / max(||v||,
  1e-12)``, computed on each access as the JAX package computes it
  (``dl_speech_enhancement_tpu/nn/conv.py::_norm_weight``). The norm runs
  over dims (1, 2) of the PyTorch layout: per output channel for a conv
  (out, in/groups, k), per input channel for a transposed conv (in, out, k),
  which are the JAX package's axes; ``g`` is (out, 1, 1) or (in, 1, 1).
  ``Conv2d`` takes the norm over every dim but 0 of ``(out, in, kh, kw)``,
  so ``g`` is (out, 1, 1, 1).
- **Spectral norm** (``spectral_norm=True``, ``Conv1d`` and ``Conv2d``,
  exclusive with weight norm): ``layer.weight`` is ``w / sigma``, sigma the
  largest singular value of ``w`` as an (out, fan_in) matrix, estimated on
  every call by the JAX package's stateless power iteration
  (``_spectral_norm_weight``): 100 steps from a fixed unit vector, ``u`` and
  ``v`` constants for the gradient. The start vector comes from a
  ``torch.Generator`` seeded 0, not JAX's ``PRNGKey(0)``, so the two agree
  at the converged sigma, not bit for bit. No ``u`` buffer is kept (unlike
  ``torch.nn.utils.spectral_norm``): the parameters are ``weight`` and
  ``bias`` with the flag on or off.
- **Groups**: ``Conv1d`` and its subclasses take ``groups``; group g's
  outputs read input channels [g * in/groups, (g + 1) * in/groups), as in
  ``F.conv1d``. Transposed convs stay at ``groups == 1``, as in the JAX
  package.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from dl_speech_enhancement_tpu_torch.utils.device import resolve_device


NORMAL_INIT_STD = 0.01  # HiFiGAN's official init, N(0, 0.01)


def _uniform(shape, fan_in: int, generator) -> torch.Tensor:
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    return torch.empty(shape).uniform_(-bound, bound, generator=generator)


def _cast(t: torch.Tensor | None, dtype) -> torch.Tensor | None:
    return None if t is None else t.to(dtype)


def _norm_dims(v: torch.Tensor) -> tuple:
    return tuple(range(1, v.ndim))


def _norm_weight(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Weight norm: ``v * g / max(||v||, 1e-12)``, the norm over every dim
    but 0."""
    norm = torch.sqrt((v * v).sum(dim=_norm_dims(v), keepdim=True))
    return v * (g / torch.clamp(norm, min=1e-12))


SPECTRAL_NORM_ITERS = 100


def _start_vector(n: int, dtype, device) -> torch.Tensor:
    u = torch.randn(n, generator=torch.Generator().manual_seed(0), dtype=torch.float32)
    return (u / torch.linalg.vector_norm(u)).to(dtype=dtype, device=device)


def _spectral_norm_weight(w: torch.Tensor, n_iters: int = SPECTRAL_NORM_ITERS,
                          eps: float = 1e-12) -> torch.Tensor:
    """``w / sigma``, sigma the largest singular value of ``w`` as an (out,
    fan_in) matrix (dim 0 is out), by ``n_iters`` power-iteration steps from
    a fixed unit vector; the gradient flows through ``sigma = u W v`` with
    ``u`` and ``v`` held constant."""
    wm = w.reshape(w.shape[0], -1)
    with torch.no_grad():
        u = _start_vector(wm.shape[0], w.dtype, w.device)
        for _ in range(n_iters):
            v = wm.T @ u
            v = v / torch.clamp(torch.linalg.vector_norm(v), min=eps)
            u = wm @ v
            u = u / torch.clamp(torch.linalg.vector_norm(u), min=eps)
    return w / (u @ (wm @ v))


class _Weighted(nn.Module):
    """A layer whose ``weight`` is a parameter (divided by its spectral norm
    with ``spectral_norm``), or with weight norm the effective weight of its
    ``v`` and ``g`` parameters."""

    def _init_weight(self, shape, fan_in, weight_norm, w_init, generator, device,
                     spectral_norm=False):
        if weight_norm and spectral_norm:
            raise ValueError("weight_norm and spectral_norm are mutually exclusive")
        if w_init == "normal":
            w = torch.empty(shape).normal_(0.0, NORMAL_INIT_STD, generator=generator)
        elif w_init == "torch":
            w = _uniform(shape, fan_in, generator)
        else:
            raise ValueError(f"unknown w_init {w_init!r}; expected 'torch' or 'normal'")
        self.weight_norm = weight_norm
        self.spectral_norm = spectral_norm
        if weight_norm:
            self.v = nn.Parameter(w.to(device))
            self.g = nn.Parameter(torch.sqrt((w * w).sum(dim=_norm_dims(w), keepdim=True))
                                  .to(device))
        else:
            self.weight = nn.Parameter(w.to(device))

    @property
    def weight(self) -> torch.Tensor:
        params = self._parameters
        if "v" in params:
            return _norm_weight(params["v"], params["g"])
        if "weight" in params:
            if self.spectral_norm:
                return _spectral_norm_weight(params["weight"])
            return params["weight"]
        raise AttributeError("weight")


class Conv1d(_Weighted):
    """Plain 1-D convolution over (B, T, C), grouped and weight- or
    spectral-normed if asked.

    ``padding < 0`` selects "same" padding ``(k - 1) // 2 * dilation``
    (reference NonCausalConv1d)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = -1, dilation: int = 1,
                 groups: int = 1, bias: bool = True, weight_norm: bool = False,
                 w_init: str = "torch", *, spectral_norm: bool = False,
                 generator: torch.Generator | None = None, device="cuda"):
        super().__init__()
        if groups < 1 or in_channels % groups or out_channels % groups:
            raise ValueError(f"groups {groups} must divide {in_channels} and {out_channels}")
        if padding < 0:
            padding = (kernel_size - 1) // 2 * dilation
        device = resolve_device(device)
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.dilation = dilation
        self.groups = groups
        fan_in = kernel_size * in_channels // groups
        self._init_weight((out_channels, in_channels // groups, kernel_size), fan_in,
                          weight_norm, w_init, generator, device, spectral_norm)
        self.bias = (nn.Parameter(_uniform((out_channels,), fan_in, generator).to(device))
                     if bias else None)

    def _conv(self, x: torch.Tensor, pad_lo: int, pad_hi: int) -> torch.Tensor:
        x = x.transpose(1, 2)
        if pad_lo or pad_hi:
            x = F.pad(x, (pad_lo, pad_hi))
        y = F.conv1d(x, self.weight, self.bias, self.stride, 0, self.dilation, self.groups)
        return y.transpose(1, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv(x, self.padding, self.padding)

    def forward_channels_first(self, x: torch.Tensor) -> torch.Tensor:
        """The same convolution over ``(B, C, T)``, F.conv1d's own layout; the
        weight and bias are cast to ``x``'s dtype, as the JAX layers cast them."""
        return F.conv1d(x, self.weight.to(x.dtype), _cast(self.bias, x.dtype), self.stride,
                        self.padding, self.dilation, self.groups)


class Conv1d1x1(Conv1d):
    """1x1 conv (reference layers/conv_layer.py:19-23)."""

    def __init__(self, in_channels, out_channels, bias=True, **kw):
        super().__init__(in_channels, out_channels, kernel_size=1, padding=0,
                         bias=bias, **kw)


class CausalConv1d(Conv1d):
    """Causal conv: the offline path pads left, the streaming path carries
    the last ``(k - 1) * dilation`` input rows as its cache. Streaming chunk
    lengths must be multiples of ``stride``."""

    def __init__(self, in_channels, out_channels, kernel_size, stride: int = 1,
                 dilation: int = 1, groups: int = 1, bias: bool = True, **kw):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=0, dilation=dilation, groups=groups, bias=bias, **kw)
        self.pad_length = (kernel_size - 1) * dilation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv(x, self.pad_length, 0)

    def init_cache(self, batch: int, dtype=torch.float32) -> torch.Tensor:
        return torch.zeros((batch, self.pad_length, self.in_channels), dtype=dtype,
                           device=self.weight.device)

    def step(self, cache: torch.Tensor, x: torch.Tensor):
        if self.stride > 1 and x.shape[1] % self.stride != 0:
            # a partial chunk would shift the window phase of the cache
            # against the offline path
            raise ValueError(
                f"streaming chunk length {x.shape[1]} must be a multiple of "
                f"stride {self.stride}")
        x = torch.cat([cache, x], dim=1)
        new_cache = x[:, x.shape[1] - self.pad_length:, :]
        return self._conv(x, 0, 0), new_cache


class ConvTranspose1d(_Weighted):
    """Transposed 1-D conv over (B, T, C) with torch ConvTranspose1d
    semantics, weight-normed if asked. ``padding < 0`` / ``output_padding <
    0`` select the reference NonCausalConvTranspose1d defaults."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int, padding: int = -1, output_padding: int = -1,
                 groups: int = 1, bias: bool = True, weight_norm: bool = False,
                 w_init: str = "torch", *,
                 generator: torch.Generator | None = None, device="cuda"):
        super().__init__()
        if groups != 1:
            # the JAX package raises for them too (nn/conv.py::ConvTranspose1d)
            raise NotImplementedError("grouped transposed convs are not ported")
        if padding < 0:
            padding = (stride + 1) // 2
        if output_padding < 0:
            output_padding = 1 if stride % 2 else 0
        device = resolve_device(device)
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.output_padding = output_padding
        fan_in = kernel_size * out_channels
        self._init_weight((in_channels, out_channels, kernel_size), fan_in, weight_norm,
                          w_init, generator, device)
        self.bias = (nn.Parameter(_uniform((out_channels,), fan_in, generator).to(device))
                     if bias else None)

    def _deconv(self, x: torch.Tensor, padding: int, output_padding: int) -> torch.Tensor:
        y = F.conv_transpose1d(x.transpose(1, 2), self.weight, self.bias, self.stride,
                               padding, output_padding)
        return y.transpose(1, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._deconv(x, self.padding, self.output_padding)


class CausalConvTranspose1d(ConvTranspose1d):
    """Causal transposed conv (upsampler) with a one-row streaming cache.

    The offline path replication-pads one row on the left, runs the stride-s
    transposed conv and trims ``s`` samples from both ends (reference
    conv_layer.py:180-183); the trim is the transposed conv's ``padding=s``.
    ``step`` replaces the replication pad with the cached last input row."""

    def __init__(self, in_channels, out_channels, kernel_size, stride, bias=True, **kw):
        super().__init__(in_channels, out_channels, kernel_size, stride, padding=0,
                         output_padding=0, bias=bias, **kw)
        if kernel_size - 1 - stride < 0:
            raise ValueError("causal transposed conv requires kernel_size > stride")
        self.pad_length = 1
        self.cpad = kernel_size - 1 - stride

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.cat([x[:, :1, :], x], dim=1)
        return self._deconv(x, self.stride, 0)

    def init_cache(self, batch: int, dtype=torch.float32) -> torch.Tensor:
        return torch.zeros((batch, self.pad_length, self.in_channels), dtype=dtype,
                           device=self.weight.device)

    def step(self, cache: torch.Tensor, x: torch.Tensor):
        new_cache = x[:, x.shape[1] - self.pad_length:, :]
        x = torch.cat([cache, x], dim=1)
        return self._deconv(x, self.stride, 0), new_cache


class Conv2d(_Weighted):
    """2-D convolution over ``(B, C, H, W)`` (PyTorch's NCHW; the JAX package
    works in NHWC), weight- or spectral-normed if asked: the MPD's and
    MRSD's layer. Weight ``(out, in, kh, kw)``; JAX holds HWIO ``(kh, kw,
    in, out)``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: tuple[int, int],
                 stride: tuple[int, int] = (1, 1), padding: tuple[int, int] = (0, 0),
                 bias: bool = True, weight_norm: bool = False, spectral_norm: bool = False,
                 *, generator: torch.Generator | None = None, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = tuple(kernel_size)
        self.stride = tuple(stride)
        self.padding = tuple(padding)
        kh, kw = self.kernel_size
        fan_in = kh * kw * in_channels
        self._init_weight((out_channels, in_channels, kh, kw), fan_in, weight_norm, "torch",
                          generator, device, spectral_norm)
        self.bias = (nn.Parameter(_uniform((out_channels,), fan_in, generator).to(device))
                     if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` (B, C, H, W); the weight and bias are cast to its dtype."""
        return F.conv2d(x, self.weight.to(x.dtype), _cast(self.bias, x.dtype), self.stride,
                        self.padding)
