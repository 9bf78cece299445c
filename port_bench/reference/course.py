"""Plain PyTorch course training step in f32: the without-PQC AudioDec
denoiser against the HiFiGAN MSD + MPD discriminator, for the benchmark's
check of the adversarial step.

Written from the course configuration (``symAD_48MelWaveL1.yaml``) and the
models' equations, on the benchmark's state dicts: the generator's offline
forward (causal convs padded with zeros, each causal transposed conv
replicating its first input row, AudioDec's ``CausalConvTranspose1d``), the
loss ``lambda_mel * L1(log-mel) + lambda_snr * (1 - sigmoid(SNR)) +
lambda_wave_l1 * L1(wave) + lambda_adv * sum_d mean((D(y) - 1)^2) +
lambda_feat_match * mean_d mean_layers mean|D(y) - D(target)|`` (the
adversarial term a sum, as ``average_by_discriminators: false`` gives; the
course builds its feature-matching loss with the defaults, averaging, and
leaves ``feat_match_loss_params`` unread), ``torch.optim.Adam`` on the
generator; then the discriminator's
``lambda_adv * sum_d (mean((D(target) - 1)^2) + mean(D(y)^2))`` on the updated
generator's output, and its Adam step. The log-mel is ``torch.stft``'s
(centred, reflect-padded, periodic Hann), the Slaney mel filterbank worked
out here. Imports nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from port_bench.flops import mpd_layers, msd_layers
from port_bench.reference.audiodec import DILATIONS, causal_conv
from port_bench.reference.hifigan import weight

F32_EPS = float(np.finfo(np.float32).eps)


def upsample_replicate(x, w, b, stride: int):
    """AudioDec's offline causal transposed conv: the first row repeated
    before it, then ``s`` samples trimmed at each end."""
    return F.conv_transpose1d(torch.cat([x[..., :1], x], -1), w, b, stride, padding=stride)


def generate(p, gp: dict, x):
    """(B, 1, T) -> (B, 1, T): the denoiser's offline forward."""

    def units(prefix, h):
        for j, d in enumerate(DILATIONS):
            q = f"{prefix}.res_units.{j}"
            r = causal_conv(F.elu(h), p[f"{q}.conv1.weight"], dilation=d)
            h = h + F.conv1d(F.elu(r), p[f"{q}.conv2.weight"])
        return h

    h = causal_conv(x, p["encoder.conv.weight"])
    for i, s in enumerate(gp["enc_strides"]):
        h = units(f"encoder.blocks.{i}", h)
        h = causal_conv(h, p[f"encoder.blocks.{i}.conv.weight"],
                        p.get(f"encoder.blocks.{i}.conv.bias"), stride=s)
    for i, s in enumerate(gp["dec_strides"]):
        h = upsample_replicate(h, p[f"decoder.blocks.{i}.conv.weight"],
                               p.get(f"decoder.blocks.{i}.conv.bias"), s)
        h = units(f"decoder.blocks.{i}", h)
    return causal_conv(h, p["decoder.conv2.weight"])


def discriminate(p, dp: dict, x):
    """(B, 1, T) -> one feature list a sub-discriminator, the MSD's scales
    first, each list ending in the logits."""
    sp, pp = dp["scale_discriminator_params"], dp["period_discriminator_params"]
    slope_s = sp["nonlinear_activation_params"]["negative_slope"]
    slope_p = pp["nonlinear_activation_params"]["negative_slope"]
    pool = dp["scale_downsample_pooling_params"]
    outs, h_scale = [], x
    layers = msd_layers(sp)
    for s in range(dp["scales"]):
        h, feats = h_scale, []
        for i, (_, _, _, stride, pad, groups) in enumerate(layers):
            q = f"msd.discriminators.{s}.layers.{i}"
            h = F.conv1d(h, p[f"{q}.weight"], p[f"{q}.bias"], stride, pad, 1, groups)
            if i < len(layers) - 1:
                h = F.leaky_relu(h, slope_s)
            feats.append(h)
        outs.append(feats)
        h_scale = F.avg_pool1d(h_scale, pool["kernel_size"], pool["stride"], pool["padding"],
                               count_include_pad=True)
    convs = mpd_layers(pp)
    for j, period in enumerate(dp["periods"]):
        h = x
        t = h.shape[-1]
        if t % period:
            h = F.pad(h, (0, period - t % period), mode="reflect")
        h = h.reshape(h.shape[0], 1, -1, period)
        feats = []
        for i, (_, _, _, stride, pad) in enumerate(convs):
            last = i == len(convs) - 1
            q = f"mpd.discriminators.{j}." + ("output_conv" if last else f"convs.{i}")
            w = weight(p, q) if f"{q}.v" in p else p[f"{q}.weight"]
            h = F.conv2d(h, w, p[f"{q}.bias"], (stride, 1), (pad, 0))
            if last:
                feats.append(h.reshape(h.shape[0], -1))
            else:
                h = F.leaky_relu(h, slope_p)
                feats.append(h)
        outs.append(feats)
    return outs


def slaney_mel(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    """librosa's ``mel(htk=False, norm='slaney')``, transposed: (n_freq, n_mels)."""
    f_sp, min_log_hz = 200.0 / 3.0, 1000.0
    min_log_mel, logstep = min_log_hz / f_sp, math.log(6.4) / 27.0

    def to_mel(f):
        f = np.asarray(f, np.float64)
        return np.where(f >= min_log_hz,
                        min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
                        f / f_sp)

    def to_hz(m):
        return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)),
                        m * f_sp)

    freqs = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    hz = to_hz(np.linspace(to_mel(fmin), to_mel(fmax), n_mels + 2))
    ramps = hz[:, None] - freqs[None, :]
    fdiff = np.diff(hz)
    weights = np.maximum(0.0, np.minimum(-ramps[:-2] / fdiff[:-1, None], ramps[2:] / fdiff[1:, None]))
    weights *= (2.0 / (hz[2:n_mels + 2] - hz[:n_mels]))[:, None]
    return weights.T.astype(np.float32)


class MelL1:
    """The course's mel loss: mean |log-mel(y) - log-mel(target)| over its
    resolutions, averaged."""

    def __init__(self, mp: dict, device):
        self.res = []
        for n_fft, hop, win in zip(mp["fft_sizes"], mp["hop_sizes"], mp["win_lengths"]):
            win = win or n_fft
            n = np.arange(win)
            window = torch.as_tensor(0.5 * (1.0 - np.cos(2.0 * np.pi * n / win)),
                                     dtype=torch.float32, device=device)
            mel = torch.from_numpy(slaney_mel(mp["fs"], n_fft, mp["num_mels"], mp["fmin"] or 0.0,
                                              mp["fmax"] or mp["fs"] / 2.0)).to(device)
            self.res.append((n_fft, hop, win, window, mel))
        if mp.get("log_base") is not None:
            raise ValueError("the course's mel loss takes the natural log")
        self.eps = 1e-10

    def log_mel(self, x, n_fft, hop, win, window, mel):
        z = torch.stft(x, n_fft, hop, win, window, center=True, pad_mode="reflect",
                       return_complex=True)
        amp = torch.sqrt(torch.clamp(z.real * z.real + z.imag * z.imag, min=self.eps))
        return torch.log(torch.clamp(amp.transpose(1, 2) @ mel, min=self.eps))

    def __call__(self, y, target):
        total = 0.0
        for res in self.res:
            total = total + torch.mean(torch.abs(self.log_mel(y[:, 0], *res)
                                                 - self.log_mel(target[:, 0], *res)))
        return total / len(self.res)


class CourseStep:
    """The adversarial step on leaves of its own: ``gen`` and ``disc`` are
    dicts of f32 tensors (copies of the benchmark's state dicts) that the
    step updates in place through ``torch.optim.Adam``."""

    def __init__(self, cfg: dict, gen: dict, disc: dict, device):
        self.cfg, self.gp, self.dp = cfg, cfg["generator_params"], cfg["discriminator_params"]
        self.gen = {k: v.detach().clone().requires_grad_(True) for k, v in gen.items()}
        self.disc = {k: v.detach().clone().requires_grad_(True) for k, v in disc.items()}
        og, od = cfg["generator_optimizer_params"], cfg["discriminator_optimizer_params"]
        self.opt_g = torch.optim.Adam(list(self.gen.values()), lr=og["lr"],
                                      betas=tuple(og["betas"]), weight_decay=og["weight_decay"])
        self.opt_d = torch.optim.Adam(list(self.disc.values()), lr=od["lr"],
                                      betas=tuple(od["betas"]), weight_decay=od["weight_decay"])
        self.mel = MelL1(cfg["mel_loss_params"], device)

    def gen_loss(self, x, target):
        c = self.cfg
        y = generate(self.gen, self.gp, x)
        snr = 10.0 * (torch.log10(torch.sum(target * target) + F32_EPS)
                      - torch.log10(torch.sum((target - y) ** 2) + F32_EPS))
        total = (c["lambda_mel_loss"] * self.mel(y, target)
                 + c.get("lambda_snr_loss", 0.0) * (1.0 - torch.sigmoid(snr))
                 + c.get("lambda_wave_l1", 0.0) * torch.mean(torch.abs(y - target)))
        frozen = {k: v.detach() for k, v in self.disc.items()}
        fake = discriminate(frozen, self.dp, y)
        with torch.no_grad():
            real = discriminate(frozen, self.dp, target)
        adv = sum(torch.mean((f[-1] - 1.0) ** 2) for f in fake)
        fm = sum(sum(torch.mean(torch.abs(a - b)) for a, b in zip(fs[:-1], rs[:-1]))
                 / (len(fs) - 1) for fs, rs in zip(fake, real)) / len(fake)
        return total + c["lambda_adv"] * adv + c["lambda_feat_match"] * fm

    def __call__(self, x, target):
        """One step on (B, T, 1) batches; returns (g_loss, d_loss) and the
        gradients each optimizer was given, ``{name: tensor}``."""
        x, target = x.transpose(1, 2), target.transpose(1, 2)
        self.opt_g.zero_grad(set_to_none=True)
        g_loss = self.gen_loss(x, target)
        g_loss.backward()
        grads = {f"gen.{k}": v.grad.detach().clone() for k, v in self.gen.items()}
        self.opt_g.step()
        self.opt_d.zero_grad(set_to_none=True)
        with torch.no_grad():
            y = generate(self.gen, self.gp, x)
        real = discriminate(self.disc, self.dp, target)
        fake = discriminate(self.disc, self.dp, y)
        d_loss = self.cfg["lambda_adv"] * (sum(torch.mean((r[-1] - 1.0) ** 2) for r in real)
                                           + sum(torch.mean(f[-1] ** 2) for f in fake))
        d_loss.backward()
        grads.update({f"disc.{k}": v.grad.detach().clone() for k, v in self.disc.items()})
        self.opt_d.step()
        return (float(g_loss.detach()), float(d_loss.detach())), grads

    def leaves(self) -> dict:
        return {**{f"gen.{k}": v.detach() for k, v in self.gen.items()},
                **{f"disc.{k}": v.detach() for k, v in self.disc.items()}}
