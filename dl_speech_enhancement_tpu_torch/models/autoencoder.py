"""AudioDec symmetric generator: the symAD codec (PQC) and the denoiser.

Counterpart of dl_speech_enhancement_tpu/models/autoencoder.py as
``nn.Module``s. ``AudioDecGenerator(use_pqc=True)`` is the symAD codec:
causal conv encoder, projector (k=3, 512 -> code_dim), residual VQ (int32 wire
codes), codebook lookup, decoder input conv (k=7, code_dim -> 512), decoder.
``use_pqc=False`` is the proposed denoiser: the decoder consumes the
512-channel encoder features directly (reference autoencoder_without_PQC/
AudioDec.py:95-100). The VQ state is functional (nn/vq.py): a ``VQState`` of
tensors passed to the methods that quantize, as in the JAX package.

Streaming: every sub-layer exposes ``init_cache``/``step``; the generator
aggregates them into one nested cache of the same structure as the JAX
package's, and exposes ``encode_step``, ``decode_step`` and ``prime``.
Activations are ``(B, T, C)``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from dl_speech_enhancement_tpu_torch.nn.conv import (
    CausalConv1d,
    CausalConvTranspose1d,
    Conv1d,
    Conv1d1x1,
    ConvTranspose1d,
)
from dl_speech_enhancement_tpu_torch.nn.vq import Quantizer, VQState
from dl_speech_enhancement_tpu_torch.utils.device import resolve_device


class ResidualUnit(nn.Module):
    """ELU -> dilated conv (k=7) -> ELU -> 1x1 conv, residual add."""

    def __init__(self, channels: int, kernel_size: int = 7, dilation: int = 1,
                 bias: bool = False, mode: str = "causal", **kw):
        super().__init__()
        if mode == "causal":
            self.conv1 = CausalConv1d(channels, channels, kernel_size,
                                      dilation=dilation, bias=bias, **kw)
        else:
            self.conv1 = Conv1d(channels, channels, kernel_size, dilation=dilation,
                                padding=-1, bias=bias, **kw)
        self.conv2 = Conv1d1x1(channels, channels, bias=bias, **kw)
        self.mode = mode

    def forward(self, x):
        return x + self.conv2(F.elu(self.conv1(F.elu(x))))

    def init_cache(self, batch):
        return {"conv1": self.conv1.init_cache(batch)}

    def step(self, cache, x):
        y, c1 = self.conv1.step(cache["conv1"], F.elu(x))
        return x + self.conv2(F.elu(y)), {"conv1": c1}


class EncoderBlock(nn.Module):
    """3 residual units (dilations 1, 3, 9) + strided conv (k = 2 * stride)."""

    def __init__(self, in_channels, out_channels, stride, dilations=(1, 3, 9),
                 bias=True, mode="causal", **kw):
        super().__init__()
        self.res_units = nn.ModuleList(
            ResidualUnit(in_channels, dilation=d, mode=mode, **kw) for d in dilations)
        if mode == "causal":
            self.conv = CausalConv1d(in_channels, out_channels, 2 * stride,
                                     stride=stride, bias=bias, **kw)
        else:
            self.conv = Conv1d(in_channels, out_channels, 2 * stride, stride=stride,
                               padding=-1, bias=bias, **kw)

    def forward(self, x):
        for u in self.res_units:
            x = u(x)
        return self.conv(x)

    def init_cache(self, batch):
        return {"res": [u.init_cache(batch) for u in self.res_units],
                "conv": self.conv.init_cache(batch)}

    def step(self, cache, x):
        new_res = []
        for u, uc in zip(self.res_units, cache["res"]):
            x, c = u.step(uc, x)
            new_res.append(c)
        x, cc = self.conv.step(cache["conv"], x)
        return x, {"res": new_res, "conv": cc}


class Encoder(nn.Module):
    """Input conv (k=7) + downsampling blocks."""

    def __init__(self, input_channels=1, encode_channels=32,
                 channel_ratios=(2, 4, 8, 16), strides=(3, 4, 5, 5), kernel_size=7,
                 bias=True, mode="causal", **kw):
        super().__init__()
        if len(channel_ratios) != len(strides):
            raise ValueError("channel_ratios and strides differ in length")
        conv_cls = CausalConv1d if mode == "causal" else Conv1d
        self.conv = conv_cls(input_channels, encode_channels, kernel_size, bias=False, **kw)
        blocks = []
        in_ch = encode_channels
        for ratio, stride in zip(channel_ratios, strides):
            out_ch = encode_channels * ratio
            blocks.append(EncoderBlock(in_ch, out_ch, stride, bias=bias, mode=mode, **kw))
            in_ch = out_ch
        self.blocks = nn.ModuleList(blocks)
        self.out_channels = in_ch
        self.hop = 1
        for s in strides:
            self.hop *= s

    def forward(self, x):
        x = self.conv(x)
        for b in self.blocks:
            x = b(x)
        return x

    def init_cache(self, batch):
        return {"conv": self.conv.init_cache(batch),
                "blocks": [b.init_cache(batch) for b in self.blocks]}

    def step(self, cache, x):
        x, cc = self.conv.step(cache["conv"], x)
        new_blocks = []
        for b, bc in zip(self.blocks, cache["blocks"]):
            x, c = b.step(bc, x)
            new_blocks.append(c)
        return x, {"conv": cc, "blocks": new_blocks}


class DecoderBlock(nn.Module):
    """Transposed-conv upsample + 3 residual units."""

    def __init__(self, in_channels, out_channels, stride, dilations=(1, 3, 9),
                 bias=True, mode="causal", **kw):
        super().__init__()
        if mode == "causal":
            self.conv = CausalConvTranspose1d(in_channels, out_channels, 2 * stride,
                                              stride, bias=bias, **kw)
        else:
            self.conv = ConvTranspose1d(in_channels, out_channels, 2 * stride, stride,
                                        padding=-1, output_padding=-1, bias=bias, **kw)
        self.res_units = nn.ModuleList(
            ResidualUnit(out_channels, dilation=d, mode=mode, **kw) for d in dilations)

    def forward(self, x):
        x = self.conv(x)
        for u in self.res_units:
            x = u(x)
        return x

    def init_cache(self, batch):
        return {"conv": self.conv.init_cache(batch),
                "res": [u.init_cache(batch) for u in self.res_units]}

    def step(self, cache, x):
        x, cc = self.conv.step(cache["conv"], x)
        new_res = []
        for u, uc in zip(self.res_units, cache["res"]):
            x, c = u.step(uc, x)
            new_res.append(c)
        return x, {"conv": cc, "res": new_res}


class Decoder(nn.Module):
    """Input conv + upsampling blocks + output conv.

    ``use_input_conv=False`` is the without-PQC decoder, which consumes the
    encoder features directly (reference autoencoder_without_PQC/modules/
    decoder.py:117-119)."""

    def __init__(self, code_dim=64, output_channels=1, decode_channels=32,
                 channel_ratios=(16, 8, 4, 2), strides=(5, 5, 4, 3), kernel_size=7,
                 bias=True, mode="causal", use_input_conv=True, **kw):
        super().__init__()
        if len(channel_ratios) != len(strides):
            raise ValueError("channel_ratios and strides differ in length")
        conv_cls = CausalConv1d if mode == "causal" else Conv1d
        self.use_input_conv = use_input_conv
        if use_input_conv:
            self.conv1 = conv_cls(code_dim, decode_channels * channel_ratios[0],
                                  kernel_size, bias=False, **kw)
        blocks = []
        for i, stride in enumerate(strides):
            in_ch = decode_channels * channel_ratios[i]
            out_ch = (decode_channels * channel_ratios[i + 1]
                      if i < len(channel_ratios) - 1 else decode_channels)
            blocks.append(DecoderBlock(in_ch, out_ch, stride, bias=bias, mode=mode, **kw))
        self.blocks = nn.ModuleList(blocks)
        self.conv2 = conv_cls(out_ch, output_channels, kernel_size, bias=False, **kw)

    def forward(self, z):
        x = self.conv1(z) if self.use_input_conv else z
        for b in self.blocks:
            x = b(x)
        return self.conv2(x)

    def init_cache(self, batch):
        cache = {"blocks": [b.init_cache(batch) for b in self.blocks],
                 "conv2": self.conv2.init_cache(batch)}
        if self.use_input_conv:
            cache["conv1"] = self.conv1.init_cache(batch)
        return cache

    def step(self, cache, z):
        new = {}
        if self.use_input_conv:
            x, new["conv1"] = self.conv1.step(cache["conv1"], z)
        else:
            x = z
        new_blocks = []
        for b, bc in zip(self.blocks, cache["blocks"]):
            x, c = b.step(bc, x)
            new_blocks.append(c)
        new["blocks"] = new_blocks
        x, new["conv2"] = self.conv2.step(cache["conv2"], x)
        return x, new


class Projector(nn.Module):
    """Causal conv (k=3) 512 -> code_dim. Reference modules/projector.py:20-54."""

    def __init__(self, input_channels, code_dim, kernel_size=3, stride=1, bias=False,
                 mode="causal", **kw):
        super().__init__()
        conv_cls = CausalConv1d if mode == "causal" else Conv1d
        self.conv = conv_cls(input_channels, code_dim, kernel_size, stride=stride,
                             bias=bias, **kw)

    def forward(self, x):
        return self.conv(x)

    def init_cache(self, batch):
        return {"conv": self.conv.init_cache(batch)}

    def step(self, cache, x):
        y, c = self.conv.step(cache["conv"], x)
        return y, {"conv": c}


class AudioDecGenerator(nn.Module):
    """The symmetric AudioDec generator, PQC (codec) or plain (denoiser).

    ``forward`` returns ``(y, zq, z, vqloss, perplexity, new_vq_state)``, the
    reference tuple plus the functional VQ state; for ``use_pqc=False`` the VQ
    loss and perplexity are zeros and the state is passed through, as in the
    JAX package. Weights are drawn from ``generator`` (a fresh one seeded with
    ``seed`` if not given) on the CPU and moved to ``device``. The codebooks
    are not weights: ``gen.quantizer.init(...)`` draws a ``VQState``."""

    def __init__(self, input_channels=1, output_channels=1, encode_channels=32,
                 decode_channels=32, code_dim=64, codebook_num=8, codebook_size=1024,
                 bias=True, enc_ratios=(2, 4, 8, 16), dec_ratios=(16, 8, 4, 2),
                 enc_strides=(3, 4, 5, 5), dec_strides=(5, 5, 4, 3), mode="causal",
                 codec="audiodec", projector="conv1d", quantier="residual_vq",
                 use_pqc=True, *, seed: int = 0,
                 generator: torch.Generator | None = None, device="cuda"):
        super().__init__()
        if codec != "audiodec":
            raise NotImplementedError(f"Codec ({codec}) is not supported!")
        if projector not in ("conv1d",):
            raise NotImplementedError(f"Projector ({projector}) is not supported!")
        if quantier != "residual_vq":
            raise NotImplementedError(f"Quantizer ({quantier}) is not supported!")
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(seed)
        kw = {"generator": generator, "device": "cpu"}
        self.mode = mode
        self.use_pqc = use_pqc
        self.input_channels = input_channels
        self.codebook_num = codebook_num
        self.encoder = Encoder(input_channels, encode_channels, enc_ratios, enc_strides,
                               7, bias, mode, **kw)
        self.decoder = Decoder(code_dim, output_channels, decode_channels, dec_ratios,
                               dec_strides, 7, bias, mode, use_input_conv=use_pqc, **kw)
        if use_pqc:
            self.projector = Projector(self.encoder.out_channels, code_dim, 3, 1, False,
                                       mode, **kw)
            self.quantizer = Quantizer(code_dim, codebook_num, codebook_size)
        self.hop = self.encoder.hop
        self.receptive_length = self._derive_receptive_length()
        self.model_receptive_length = self._derive_model_receptive_length()
        self.to(device)

    @property
    def device(self) -> torch.device:
        return self.encoder.conv.weight.device

    def _derive_receptive_length(self) -> int:
        """Exact tx receptive field in input samples for ONE code frame,
        walked backwards through the projector and the encoder with ``R_in =
        (R_out - 1) * stride + (kernel - 1) * dilation + 1``: 7209 for
        symAD_vctk_48000_hop300, 6609 for the without-PQC denoiser."""
        r = 1
        if self.use_pqc:
            c = self.projector.conv
            r = (r - 1) * c.stride + (c.kernel_size - 1) * c.dilation + 1
        for blk in reversed(self.encoder.blocks):
            c = blk.conv
            r = (r - 1) * c.stride + (c.kernel_size - 1) * c.dilation + 1
            for u in reversed(blk.res_units):
                r += (u.conv1.kernel_size - 1) * u.conv1.dilation
        c = self.encoder.conv
        r += (c.kernel_size - 1) * c.dilation
        return r

    def _derive_model_receptive_length(self) -> int:
        """The whole model's reach back in input samples: the least R such
        that output sample ``t`` depends on no input before ``t - R + 1``
        (13217 for the without-PQC denoiser, 15617 for
        symAD_vctk_48000_hop300). ``receptive_length`` covers the encoder
        only. The first input row an output row needs is walked back through
        the decoder (a transposed conv of stride s and kernel 2 * s gives
        output row t the input rows t // s - 1 and t // s) and the
        transmitter (a causal conv of stride s gives output row j the input
        rows from j * s - (kernel - 1) * dilation), at each phase of ``t``
        within the hop. Chunks of a long signal equal its full forward with
        this much left context (parallel/long_audio.py)."""
        def reach(conv):
            return (conv.kernel_size - 1) * conv.dilation

        dec, longest = self.decoder, 0
        for t in range(self.hop):
            first = t - reach(dec.conv2)
            for blk in reversed(dec.blocks):
                first -= sum(reach(u.conv1) for u in blk.res_units)
                first = first // blk.conv.stride - 1
            if dec.use_input_conv:
                first -= reach(dec.conv1)
            if self.use_pqc:
                first = first * self.projector.conv.stride - reach(self.projector.conv)
            for blk in reversed(self.encoder.blocks):
                first = first * blk.conv.stride - reach(blk.conv)
                first -= sum(reach(u.conv1) for u in blk.res_units)
            first -= reach(self.encoder.conv)
            longest = max(longest, t - first + 1)
        return longest

    # ---------------- parallel (offline) path ----------------

    def check_vq_state(self, vq_state) -> None:
        if self.use_pqc and vq_state is None:
            raise ValueError("the PQC generator quantizes with a VQState; got none")
        if not self.use_pqc and vq_state is not None:
            raise ValueError("a VQState was given to a without-PQC generator")

    def forward(self, x, vq_state=None, train: bool = True):
        """x: (B, T, C_in). Returns (y, zq, z, vqloss, ppl, new_vq_state)."""
        if x.shape[-1] != self.input_channels:
            x = x.reshape(x.shape[0], -1, self.input_channels)
        e = self.encoder(x)
        if self.use_pqc:
            self.check_vq_state(vq_state)
            z = self.projector(e)
            zq, new_state, vqloss, ppl = self.quantizer(vq_state, z, train=train)
        else:
            z = zq = e
            new_state = vq_state
            vqloss = torch.zeros((self.codebook_num,), dtype=x.dtype, device=x.device)
            ppl = vqloss.clone()
        y = self.decoder(zq)
        return y, zq, z, vqloss, ppl, new_state

    # ---------------- streaming path ----------------

    def init_cache(self, batch: int):
        cache = {"encoder": self.encoder.init_cache(batch),
                 "decoder": self.decoder.init_cache(batch)}
        if self.use_pqc:
            cache["projector"] = self.projector.init_cache(batch)
        return cache

    def encode_step(self, cache, x):
        """Streaming encode of one chunk -> (z, new cache parts): the encoder
        and, with PQC, the projector."""
        if x.shape[-1] != self.input_channels:
            x = x.reshape(x.shape[0], -1, self.input_channels)
        e, enc_c = self.encoder.step(cache["encoder"], x)
        if self.use_pqc:
            z, proj_c = self.projector.step(cache["projector"], e)
            return z, {"encoder": enc_c, "projector": proj_c}
        return e, {"encoder": enc_c}

    def quantize(self, vq_state: VQState, z):
        """z (B, T, D) -> flattened tx indices (L, B, T) int32
        (AudioDec.py:172-174)."""
        _, idx = self.quantizer.encode(vq_state, z)
        return idx

    def flat_codebook(self, vq_state: VQState):
        self.check_vq_state(vq_state)
        return self.quantizer.rvq.flat_codebook(vq_state)

    def lookup(self, flat_codebook, idx):
        """Flattened indices (L, B, T) -> summed codewords (B, T, D)."""
        return self.quantizer.decode(flat_codebook, idx)

    def decode_step(self, cache, zq):
        y, dec_c = self.decoder.step(cache["decoder"], zq)
        return y, {"decoder": dec_c}

    def prime(self, vq_state: VQState | None = None, batch: int = 1,
              receptive_length=None):
        """Prime all caches with zeros (reference initial_encoder /
        initial_decoder, AudioDec.py:151-160); the length is rounded up to
        whole code frames (7209 -> 7500 for the codec)."""
        self.check_vq_state(vq_state)
        rl = receptive_length or self.receptive_length
        rl = -(-rl // self.hop) * self.hop
        cache = self.init_cache(batch)
        zeros = torch.zeros((batch, rl, self.input_channels), device=self.device)
        z, enc_cache = self.encode_step(cache, zeros)
        cache.update(enc_cache)
        if self.use_pqc:
            zq = self.lookup(self.flat_codebook(vq_state), self.quantize(vq_state, z))
        else:
            zq = z
        _, dec_cache = self.decode_step(cache, zq)
        cache.update(dec_cache)
        return cache
