"""Sequence-parallel (time-sharded) training over a ``time`` mesh axis.

Counterpart of dl_speech_enhancement_tpu/parallel/time_shard.py. Every model
of this family is causal with finite receptive fields, so the rank at time
position p computes its shard of a long clip exactly from its own samples
plus a left halo from rank p - 1. Two halos are exchanged a step: a
waveform halo covering the transmitter's receptive field
(``gen.receptive_length``, rounded up to whole code frames) and a code-frame
halo of the quantized codes covering the decoder's
(:func:`decoder_receptive_frames`), so the quantizer sees every code frame
once. Shard 0 receives zeros, the stream start (its output near the start
differs from the offline forward's, which pads true zeros at every layer;
beyond the warm-up they agree). Halo and shard lengths are whole code hops.

The exchange is an autograd Function over point-to-point sends: its forward
sends the tail of the shard to p + 1 and receives from p - 1, its backward
sends the halo's cotangent back to p - 1 and receives the tail's from p + 1
(the last shard's tail gets zeros), so the code halo's gradient reaches the
neighbour's encoder through its straight-through quantizer, as JAX's
``ppermute`` transpose does.

The objective is the JAX package's blocked form of the course metric loss:
``lambda_mel_loss`` times the mean over the shards of each shard's mel L1,
plus ``lambda_snr_loss * (1 - sigmoid(SNR))`` with the energy sums over the
whole mesh, plus (PQC generators) ``lambda_vq_loss`` times the VQ commitment
averaged over the mesh; the EMA statistics are summed over the mesh
(``axis_name`` of nn/vq.py). Gradients follow the rule of parallel/mesh.py:
a rank's loss is its local mel and commitment terms plus the SNR term whole
(through the differentiable ``psum``), and the gradients are averaged over
every rank of the mesh once a step. :func:`blocked_reference_step` computes
the same objective in one process, serially over the shards.

The mesh is a ``DeviceMesh`` (parallel/mesh.py::device_mesh) with a
``time`` dim, and for the 2-D layout a ``data`` dim (``batch_axis``) that
spreads the batch's rows. Every rank passes its own block of the clip
(:func:`local_shard`).
"""

from __future__ import annotations

import torch

from dl_speech_enhancement_tpu_torch.losses import MultiMelSpectrogramLoss
from dl_speech_enhancement_tpu_torch.utils.collectives import (
    average_gradients,
    exchange,
    pmean,
    psum,
)

_EPS = 1e-8


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def decoder_receptive_frames(dec) -> int:
    """The decoder's receptive field in code frames (one extra frame an
    upsampling block, as the JAX walk counts it): back through the output
    conv, the residual units and the 2-tap causal transposed convs (output
    row ``s * r + p`` reads input frames ``r - 1`` and ``r``)."""
    r = 1
    r += (dec.conv2.kernel_size - 1) * dec.conv2.dilation
    for blk in reversed(dec.blocks):
        for u in reversed(blk.res_units):
            r += (u.conv1.kernel_size - 1) * u.conv1.dilation
        r = _ceil_div(r, blk.conv.stride) + 1
    if dec.use_input_conv:
        r += (dec.conv1.kernel_size - 1) * dec.conv1.dilation
    return r


def _halos(gen, overlap=None):
    """(waveform halo samples, encoder halo frames, decoder halo frames)."""
    r_tx = gen.receptive_length if overlap is None else overlap
    he_frames = _ceil_div(r_tx, gen.hop)
    return he_frames * gen.hop, he_frames, decoder_receptive_frames(gen.decoder)


class _LeftHalo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tail, group, p, n):
        ctx.group, ctx.p, ctx.n = group, p, n
        return exchange(tail, p + 1 if p + 1 < n else None, tail, p - 1 if p > 0 else None,
                        group)

    @staticmethod
    def backward(ctx, grad):
        p, n = ctx.p, ctx.n
        got = exchange(grad, p - 1 if p > 0 else None, grad, p + 1 if p + 1 < n else None,
                       ctx.group)
        return got, None, None, None


def _left_halo(x, halo: int, group, p: int, n: int):
    """The last ``halo`` steps (axis 1) of rank p - 1's shard; zeros on
    shard 0, the stream-start state."""
    tail = x[:, x.shape[1] - halo:]
    if n == 1:
        return torch.zeros_like(tail)
    return _LeftHalo.apply(tail.contiguous(), group, p, n)


def _shard_forward(gen, vq_state, x, *, he, he_frames, hd_frames, group, p, n, train,
                   vq_axes):
    """One rank's exact forward: waveform halo -> encoder / projector, the
    core frames quantized, code halo -> decoder. Returns (y, vqloss, ppl,
    new_vq_state) of the local shard."""
    if x.shape[-1] != gen.input_channels:
        x = x.reshape(x.shape[0], -1, gen.input_channels)
    left = _left_halo(x, he, group, p, n)
    e = gen.encoder(torch.cat([left, x], dim=1))
    if gen.use_pqc:
        z = gen.projector(e)[:, he_frames:]
        zq, new_vq, vqloss, ppl = gen.quantizer(vq_state, z, train=train,
                                                axis_name=vq_axes if train else None)
    else:
        zq, new_vq = e[:, he_frames:], vq_state
        vqloss = torch.zeros((gen.codebook_num,), dtype=x.dtype, device=x.device)
        ppl = vqloss.clone()
    zleft = _left_halo(zq, hd_frames, group, p, n)
    y = gen.decoder(torch.cat([zleft, zq], dim=1))
    return y[:, hd_frames * gen.hop:], vqloss, ppl, new_vq


def _check_shapes(t_total: int, n_shards: int, hop: int, he: int, hd_frames: int):
    if t_total % (n_shards * hop):
        raise ValueError(f"T={t_total} must be a multiple of {n_shards} shards x hop {hop}")
    t_shard = t_total // n_shards
    if t_shard < max(he, hd_frames * hop):
        raise ValueError(f"shards of {t_shard} samples are shorter than the halo (enc {he} / "
                         f"dec {hd_frames * hop} samples): use fewer time shards")


def _axes(mesh, axis, batch_axis):
    """(time group, this rank's time position, time shards, reduction groups)."""
    group = mesh.get_group(axis)
    groups = (group,) if batch_axis is None else (group, mesh.get_group(batch_axis))
    return group, mesh.get_local_rank(axis), mesh[axis].size(), groups


def local_shard(mesh, x, axis: str = "time", batch_axis: str | None = None):
    """This rank's block of a global (B, T, ...) clip: its 1/n of T by its
    position on ``axis``, and of B by its position on ``batch_axis``."""
    n, p = mesh[axis].size(), mesh.get_local_rank(axis)
    t = x.shape[1] // n
    x = x[:, p * t:(p + 1) * t]
    if batch_axis is not None:
        m, d = mesh[batch_axis].size(), mesh.get_local_rank(batch_axis)
        b = x.shape[0] // m
        x = x[d * b:(d + 1) * b]
    return x


def time_sharded_forward(gen, mesh, axis: str = "time", overlap=None,
                         batch_axis: str | None = None):
    """Sharded inference ``f(vq_state, x)``: ``x`` is this rank's block
    (:func:`local_shard`) of a (B, T, C) clip whose T is a multiple of the
    time shards x ``gen.hop``; returns the rank's block of the output. Equals
    the offline forward beyond the stream-start warm-up."""
    he, he_frames, hd_frames = _halos(gen, overlap)
    group, p, n, _ = _axes(mesh, axis, batch_axis)

    @torch.no_grad()
    def forward(vq_state, x):
        _check_shapes(x.shape[1] * n, n, gen.hop, he, hd_frames)
        y, *_ = _shard_forward(gen, vq_state, x, he=he, he_frames=he_frames,
                               hd_frames=hd_frames, group=group, p=p, n=n, train=False,
                               vq_axes=None)
        return y

    return forward


def _objective(config, device):
    return (MultiMelSpectrogramLoss(**config["mel_loss_params"], device=device),
            config.get("lambda_mel_loss", 45.0), config.get("lambda_snr_loss", 0.0),
            config.get("lambda_vq_loss", 1.0))


def _snr_term(l_snr, s_t, s_n):
    snr = 10.0 * (torch.log10(s_t + _EPS) - torch.log10(s_n + _EPS))
    return l_snr * (1.0 - torch.sigmoid(snr))


def make_time_sharded_steps(gen, config: dict, optimizer, mesh, axis: str = "time",
                            overlap=None, batch_axis: str | None = None):
    """Train and eval steps of the blocked metric objective on a
    time-sharded clip (module docstring), each rank passing its block of
    ``x`` and ``target`` (:func:`local_shard`).

    ``train(vq_state, x, target) -> (vq_state, loss, frags)`` updates
    ``gen``'s parameters in place with ``optimizer`` (anything with
    ``zero_grad`` / ``step`` over them) after the gradients are averaged over
    the mesh, and returns the advanced codebooks (PQC generators; the given
    ones otherwise); ``eval(vq_state, x, target) -> loss``. The loss and the
    fragments are the whole clip's, equal on every rank."""
    mel_loss, l_mel, l_snr, l_vq = _objective(config, gen.device)
    he, he_frames, hd_frames = _halos(gen, overlap)
    group, p, n, groups = _axes(mesh, axis, batch_axis)

    def local_loss(vq_state, x, target, train):
        """(the rank's loss, the clip's loss value, frags, new codebooks)."""
        _check_shapes(x.shape[1] * n, n, gen.hop, he, hd_frames)
        y, vqloss, ppl, new_vq = _shard_forward(
            gen, vq_state, x, he=he, he_frames=he_frames, hd_frames=hd_frames, group=group,
            p=p, n=n, train=train, vq_axes=groups)
        mel = l_mel * mel_loss(y, target)
        total = mel
        frags = {"mel_loss": pmean(mel.detach(), groups)}
        if l_snr:
            s_t = psum(torch.sum(torch.square(target)), groups)
            s_n = psum(torch.sum(torch.square(target - y)), groups)
            snr = _snr_term(l_snr, s_t, s_n)
            total = total + snr
            frags["snr_loss"] = snr.detach()
        if gen.use_pqc:
            vq = l_vq * torch.sum(vqloss)
            total = total + vq
            frags["vq_loss"] = pmean(vq.detach(), groups)
            frags["perplexity"] = torch.sum(pmean(ppl.detach(), groups))
        value = sum(v for k, v in frags.items() if k != "perplexity")
        return total, value, frags, new_vq

    def train(vq_state, x, target):
        optimizer.zero_grad()
        total, value, frags, new_vq = local_loss(vq_state, x, target, True)
        total.backward()
        average_gradients(gen.parameters(), groups)
        optimizer.step()
        return (new_vq if gen.use_pqc else vq_state), value, frags

    @torch.no_grad()
    def evaluate(vq_state, x, target):
        return local_loss(vq_state, x, target, False)[1]

    return {"train": train, "eval": evaluate, "halo_samples": he,
            "decoder_halo_frames": hd_frames}


def blocked_reference_step(gen, config: dict, optimizer, n_shards: int, overlap=None):
    """One process's implementation of the computation the sharded step
    distributes, a serial walk over the shards with the same halo windows
    (zeros for shard 0): ``step(vq_state, x, target) -> (vq_state, loss)``
    on whole (B, T, C) clips, updating ``gen`` in place with ``optimizer``.
    The equivalence tests hold the sharded step to it; it also reads as the
    objective's definition."""
    mel_loss, l_mel, l_snr, l_vq = _objective(config, gen.device)

    def forward(vq_state, x):
        he, he_frames, hd_frames = _halos(gen, overlap)
        ts = x.shape[1] // n_shards
        tf = ts // gen.hop
        zs = []
        for p in range(n_shards):
            lo = p * ts
            left = (x.new_zeros((x.shape[0], he, x.shape[2])) if p == 0
                    else x[:, lo - he:lo])
            e = gen.encoder(torch.cat([left, x[:, lo:lo + ts]], dim=1))
            zs.append((gen.projector(e) if gen.use_pqc else e)[:, he_frames:])
        z = torch.cat(zs, dim=1)
        if gen.use_pqc:
            zq, new_vq, vqloss, _ = gen.quantizer(vq_state, z, train=True)
        else:
            zq, new_vq, vqloss = z, vq_state, None
        ys = []
        for p in range(n_shards):
            lo = p * tf
            left = (zq.new_zeros((zq.shape[0], hd_frames, zq.shape[2])) if p == 0
                    else zq[:, lo - hd_frames:lo])
            ys.append(gen.decoder(torch.cat([left, zq[:, lo:lo + tf]], dim=1))
                      [:, hd_frames * gen.hop:])
        return torch.cat(ys, dim=1), vqloss, new_vq

    def step(vq_state, x, target):
        optimizer.zero_grad()
        y, vqloss, new_vq = forward(vq_state, x)
        ts = x.shape[1] // n_shards
        mel = sum(mel_loss(y[:, p * ts:(p + 1) * ts], target[:, p * ts:(p + 1) * ts])
                  for p in range(n_shards)) / n_shards
        total = l_mel * mel
        if l_snr:
            total = total + _snr_term(l_snr, torch.sum(torch.square(target)),
                                      torch.sum(torch.square(target - y)))
        if gen.use_pqc:
            total = total + l_vq * torch.sum(vqloss)
        total.backward()
        optimizer.step()
        return new_vq, total.detach()

    return step
