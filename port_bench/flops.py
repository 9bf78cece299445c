"""The benchmark's yardstick: peaks, and the operations and bytes of the
models and kernels it measures, counted from a configuration's sizes.

Every roofline and ``mfu`` share is taken against one fixed peak, the dense
bf16 rate of an H100 SXM, and its memory rate, whatever precision or
instruction a kernel uses. So a share reads the same work whatever
implements it, and no change of implementation can move the yardstick or
push a share past 100 %. Kernels that multiply f32 weights read low by
construction.

Counts, as in the port's ``chip_smoke.py`` (``chain_flops``, the per-site
counts of ``sites`` / ``codec_sites`` / ``vocoder_sites``), 2 operations a
multiply-add:

- a kernel's operations are what its launch computes, the residual chain's
  halo rows included (its cache holds inputs, so each unit recomputes the
  rows the later units' dilated taps reach back to);
- a kernel's bytes count each input read once and each output written once;
- model FLOPs count each layer's output rows once, with no halo, and leave
  out element-wise work (activations, residual adds, normalisation).
"""

from __future__ import annotations

PEAK_FLOPS = 989e12  # H100 SXM, dense bf16 tensor-core rate (NVIDIA data sheet)
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32 = 4  # bytes of an f32 value; every weight and activation the cells move is f32
I32 = 4

CHAIN_KERNEL, CHAIN_DILATIONS = 7, (1, 3, 9)  # the AudioDec residual unit
CHAIN_HALO = sum((CHAIN_KERNEL - 1) * d for d in CHAIN_DILATIONS)


def bound_s(flops: float, nbytes: float) -> float:
    """The least time for ``flops`` operations and ``nbytes`` moved, at the
    fixed peaks."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES_PER_S)


def conv_flops(rows_out: int, taps: int, cin: int, cout: int, groups: int = 1) -> float:
    return 2.0 * rows_out * taps * (cin // groups) * cout


def upsample_flops(rows_in: int, stride: int, cin: int, cout: int) -> float:
    """A stride-s transposed conv of kernel 2s: every input row meets every
    tap once."""
    return 2.0 * rows_in * 2 * stride * cin * cout


def chain_flops(channels: int, rows: int) -> float:
    """Operations of one residual-chain launch that outputs ``rows`` rows of
    one stream, the halo rows included."""
    total = 0.0
    for u in range(len(CHAIN_DILATIONS)):
        needed = rows + sum((CHAIN_KERNEL - 1) * d for d in CHAIN_DILATIONS[u + 1:])
        total += 2.0 * (CHAIN_KERNEL + 1) * channels * channels * needed
    return total


def chain_model_flops(channels: int, rows: int) -> float:
    return len(CHAIN_DILATIONS) * 2.0 * (CHAIN_KERNEL + 1) * channels * channels * rows


# ---------------------------------------------------------------- AudioDec


def levels(gp: dict):
    """(channels in, channels out, stride) of each encoder block and each
    decoder block of an AudioDec generator's ``generator_params``."""
    ec, dc = gp["encode_channels"], gp["decode_channels"]
    enc, cin = [], ec
    for ratio, stride in zip(gp["enc_ratios"], gp["enc_strides"]):
        enc.append((cin, ec * ratio, stride))
        cin = ec * ratio
    dec, ratios = [], gp["dec_ratios"]
    for i, stride in enumerate(gp["dec_strides"]):
        cout = dc * ratios[i + 1] if i < len(ratios) - 1 else dc
        dec.append((dc * ratios[i], cout, stride))
    return enc, dec


def hop(gp: dict) -> int:
    h = 1
    for s in gp["enc_strides"]:
        h *= s
    return h


def encoder_sites(gp: dict, samples: int, streams: int):
    """``(kernel, site, flops, bytes)`` of every launch of the encoder half
    of the whole-model stream over ``samples`` new samples of ``streams``
    streams (f32 weights): input conv, 4 x (residual chain, downsample), and
    with PQC the projector and the residual-VQ search."""
    enc, _ = levels(gp)
    b, t, out = streams, samples, []
    c0 = gp["encode_channels"]
    out.append(("causal_conv", "enc_in", b * conv_flops(t, 7, 1, c0),
                F32 * (b * 6 + b * t + 7 * c0 + b * t * c0)))
    for i, (cin, cout, s) in enumerate(enc):
        out.append(("residual_chain", f"e{i}ch", b * chain_flops(cin, t),
                    F32 * (b * CHAIN_HALO * cin + 2 * b * t * cin
                           + (CHAIN_KERNEL + 1) * cin * cin * len(CHAIN_DILATIONS))))
        out.append(("causal_conv", f"e{i}d", b * conv_flops(t // s, 2 * s, cin, cout),
                    F32 * (b * (2 * s - 1) * cin + b * t * cin + 2 * s * cin * cout + cout
                           + b * (t // s) * cout)))
        t //= s
    if gp.get("use_pqc"):
        c, d = enc[-1][1], gp["code_dim"]
        n_books, k = gp["codebook_num"], gp["codebook_size"]
        out.append(("causal_conv", "prj", b * conv_flops(t, 3, c, d),
                    F32 * (b * 2 * c + b * t * c + 3 * c * d + b * t * d)))
        out.append(("rvq_assign", "rvq", b * t * n_books * (2.0 * d * k + 3.0 * k),
                    F32 * (b * t * d + n_books * k * (d + 1)) + I32 * b * t * n_books))
    return out


def decoder_sites(gp: dict, samples: int, streams: int):
    """The same for the AudioDec decoder half (without PQC: it takes the
    encoder's features)."""
    _, dec = levels(gp)
    b, t, out = streams, samples // hop(gp), []
    for i, (cin, cout, s) in enumerate(dec):
        out.append(("causal_conv_transpose", f"d{i}u", b * upsample_flops(t, s, cin, cout),
                    F32 * (b * cin + b * t * cin + 2 * s * cin * cout + cout
                           + b * t * s * cout)))
        t *= s
        out.append(("residual_chain", f"d{i}ch", b * chain_flops(cout, t),
                    F32 * (b * CHAIN_HALO * cout + 2 * b * t * cout
                           + (CHAIN_KERNEL + 1) * cout * cout * len(CHAIN_DILATIONS))))
    c = dec[-1][1]
    out.append(("causal_conv", "dec_out", b * conv_flops(t, 7, c, 1),
                F32 * (b * 6 * c + b * t * c + 7 * c + b * t)))
    return out


def audiodec_model_flops(gp: dict, samples: int, decoder: bool = True) -> float:
    """Model FLOPs of one stream's ``samples`` through the encoder (and the
    projector and search with PQC) and, with ``decoder``, the decoder of the
    without-PQC denoiser: each layer's output rows once."""
    enc, dec = levels(gp)
    t, total = samples, conv_flops(samples, 7, 1, gp["encode_channels"])
    for cin, cout, s in enc:
        total += chain_model_flops(cin, t) + conv_flops(t // s, 2 * s, cin, cout)
        t //= s
    if gp.get("use_pqc"):
        c, d = enc[-1][1], gp["code_dim"]
        total += conv_flops(t, 3, c, d) + t * gp["codebook_num"] * 2.0 * d * gp["codebook_size"]
    if decoder:
        for cin, cout, s in dec:
            total += upsample_flops(t, s, cin, cout)
            t *= s
            total += chain_model_flops(cout, t)
        total += conv_flops(t, 7, dec[-1][1], 1)
    return total


# ---------------------------------------------------------------- HiFiGAN


def stages(vp: dict):
    """(channels in, channels out, stride) of each HiFiGAN upsampling stage."""
    ch, out = vp["channels"], []
    for i, s in enumerate(vp["upsample_scales"]):
        out.append((ch // 2 ** i, ch // 2 ** (i + 1), s))
    return out


def vocoder_sites(vp: dict, code_rows: int, streams: int, books: int, book_k: int):
    """``(kernel, site, flops, bytes)`` of every launch of the MultiGroupConv1d
    HiFiGAN receiver (AudioDec v1) over ``code_rows`` rows of codes of
    ``streams`` streams, f32 weights: codebook lookup, input conv, per stage
    the upsample, the grouped units and the 1x1 fuse, the output conv. The
    lookup reads ``books`` books of ``book_k`` codewords."""
    b, t, out = streams, code_rows, []
    d, ch, k_in = vp["in_channels"], vp["channels"], vp["kernel_size"]
    out.append(("codebook_lookup", "lookup", float(b * t * books * d),
                I32 * b * t * books + F32 * (min(b * t, book_k) * books * d + b * t * d)))
    out.append(("causal_conv", "v_in", b * conv_flops(t, k_in, d, ch),
                F32 * (b * (k_in - 1) * d + b * t * d + k_in * d * ch + ch + b * t * ch)))
    groups, k = vp["groups"], vp["resblock_kernel_sizes"][0]
    for si, (cin, cout, s) in enumerate(stages(vp)):
        out.append(("causal_conv_transpose", f"v{si}u", b * upsample_flops(t, s, cin, cout),
                    F32 * (b * cin + b * t * cin + 2 * s * cin * cout + cout
                           + b * t * s * cout)))
        t *= s
        gc = cout * groups
        for ui, dil in enumerate(vp["resblock_dilations"][0]):
            cin_u = cout if ui == 0 else gc
            w = 2 * (k * cout * gc + gc)  # two grouped convs and their biases
            out.append(("hifigan_unit", f"v{si}r{ui}", b * 2 * conv_flops(t, k, gc, gc, groups),
                        F32 * (b * (k - 1) * dil * cin_u + b * (k - 1) * gc + b * t * cin_u + w
                               + b * (t + k - 1) * gc)))
        out.append(("causal_conv", f"v{si}f", b * conv_flops(t, 1, gc, cout),
                    F32 * (b * t * gc + gc * cout + b * t * cout)))
    c = stages(vp)[-1][1]
    out.append(("causal_conv", "v_out", b * conv_flops(t, k_in, c, 1),
                F32 * (b * (k_in - 1) * c + b * t * c + k_in * c + 1 + b * t)))
    return out


def vocoder_model_flops(vp: dict, code_rows: int) -> float:
    """Model FLOPs of one stream's ``code_rows`` rows of codes through the
    MultiGroupConv1d HiFiGAN (v1)."""
    t, d, ch = code_rows, vp["in_channels"], vp["channels"]
    total = conv_flops(t, vp["kernel_size"], d, ch)
    groups, k = vp["groups"], vp["resblock_kernel_sizes"][0]
    for cin, cout, s in stages(vp):
        total += upsample_flops(t, s, cin, cout)
        t *= s
        gc = cout * groups
        total += len(vp["resblock_dilations"][0]) * 2 * conv_flops(t, k, gc, gc, groups)
        total += conv_flops(t, 1, gc, cout)
    total += conv_flops(t, vp["kernel_size"], stages(vp)[-1][1], 1)
    return total


# ---------------------------------------------------------------- training


def msd_layers(sp: dict):
    """``(in, out, kernel, stride, padding, groups)`` of each conv of one
    HiFiGAN scale discriminator (ParallelWaveGAN's MelGAN-style stack)."""
    k0, k1, k2, k3 = sp["kernel_sizes"]
    ch, max_ch, max_g = sp["channels"], sp["max_downsample_channels"], sp["max_groups"]
    out = [(sp["in_channels"], ch, k0, 1, (k0 - 1) // 2, 1)]
    cin = cout = ch
    groups = 4
    for s in sp["downsample_scales"]:
        out.append((cin, cout, k1, s, (k1 - 1) // 2, groups))
        cin, cout, groups = cout, min(cout * 2, max_ch), min(groups * 4, max_g)
    cout = min(cin * 2, max_ch)
    out.append((cin, cout, k2, 1, (k2 - 1) // 2, 1))
    out.append((cout, sp["out_channels"], k3, 1, (k3 - 1) // 2, 1))
    return out


def mpd_layers(pp: dict):
    """``(in, out, kernel height, stride height, padding height)`` of each
    Conv2d of one HiFiGAN period discriminator, the output conv last."""
    k0, k1 = pp["kernel_sizes"]
    out, cin, cout = [], pp["in_channels"], pp["channels"]
    for s in pp["downsample_scales"]:
        out.append((cin, cout, k0, s, (k0 - 1) // 2))
        cin, cout = cout, min(cout * 4, pp["max_downsample_channels"])
    out.append((cin, pp["out_channels"], k1 - 1, 1, (k1 - 1) // 2))
    return out


def discriminator_forward_flops(dp: dict, length: int) -> float:
    """Forward FLOPs of the course discriminator's convolutions (HiFiGAN MSD
    + MPD) on one waveform of ``length`` samples, from each layer's output
    shape."""
    sp, pool = dp["scale_discriminator_params"], dp["scale_downsample_pooling_params"]
    total, t = 0.0, length
    for _ in range(dp["scales"]):
        rows = t
        for cin, cout, k, stride, pad, groups in msd_layers(sp):
            rows = (rows + 2 * pad - k) // stride + 1
            total += conv_flops(rows, k, cin, cout, groups)
        t = (t + 2 * pool["padding"] - pool["kernel_size"]) // pool["stride"] + 1
    for period in dp["periods"]:
        rows = -(-length // period)
        for cin, cout, kh, stride, pad in mpd_layers(dp["period_discriminator_params"]):
            rows = (rows + 2 * pad - kh) // stride + 1
            total += period * conv_flops(rows, kh, cin, cout)
    return total


# forward-equivalents a course adversarial step runs: the generator forward
# and backward (3) and its forward again for the discriminator (1); the
# discriminator on the generator's output, forward and input gradient (2),
# on the target without gradients (1), then both, forward, input and weight
# gradients (2 x 3)
COURSE_GEN_PASSES, COURSE_DISC_PASSES = 4, 9


def course_step_flops(gp: dict, dp: dict, batch: int, length: int) -> float:
    """Model FLOPs of one adversarial course step on ``batch`` clips of
    ``length`` samples (the mel loss's FFTs left out)."""
    return batch * (COURSE_GEN_PASSES * audiodec_model_flops(gp, length)
                    + COURSE_DISC_PASSES * discriminator_forward_flops(dp, length))
