"""EMA vector quantization and residual VQ, as functional state transitions.

Counterpart of dl_speech_enhancement_tpu/nn/vq.py (reference
layers/vq_module.py):

- ``VectorQuantizeEMA``: nearest-codeword assignment by squared L2 on a
  ``(dim, n_embed)`` codebook, EMA codebook update (decay 0.8, Laplace
  smoothing), commitment MSE loss, straight-through estimator, perplexity of
  the assignment histogram.
- ``ResidualVQ``: a cascade of quantizers over a stacked state ``(L, dim,
  K)``. The residual subtraction keeps the straight-through ``q``, so only
  the first layer's gradient reaches the encoder (reference
  vq_module.py:126-129). ``forward_index`` quantizes without EMA updates and
  optionally flattens indices by ``+ i * codebook_size`` (the int32 wire
  codes); ``lookup`` sums the codewords of all layers.

The state is an explicit ``VQState`` of tensors, never updated in place: each
call returns a new one. Distances are ``|x|^2 - 2 x.E + |E|^2`` in f32 in
exactly the JAX package's form, and ``argmin`` keeps the lowest index on ties,
so the wire codes agree with the reference. Under data or sequence
parallelism ``axis_name`` names the ranks a call's batch is spread over (a
process group, or a tuple of them for the 2-D ``(data, time)`` layout; None
is local): the EMA counts and codeword sums are summed over them and the
assignment histogram averaged before the entropy, as the JAX package's
``psum`` / ``pmean`` do, so every rank applies the update of the whole batch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from dl_speech_enhancement_tpu_torch.utils.collectives import pmean, psum
from dl_speech_enhancement_tpu_torch.utils.device import resolve_device


class VQState(NamedTuple):
    embed: torch.Tensor  # (dim, n_embed), or (L, dim, n_embed) when stacked
    cluster_size: torch.Tensor  # (n_embed,) or (L, n_embed)
    embed_avg: torch.Tensor  # same shape as embed


def _quantize_core(embed: torch.Tensor, flat: torch.Tensor):
    """Nearest-codeword assignment. flat: (N, dim); embed: (dim, K).
    Returns (ind (N,) int64, quantized (N, dim))."""
    dist = ((flat * flat).sum(1, keepdim=True) - 2.0 * (flat @ embed)
            + (embed * embed).sum(0, keepdim=True))
    ind = torch.argmin(dist, dim=1)
    return ind, embed.t()[ind]


class VectorQuantizeEMA:
    """Single EMA-codebook vector quantizer (functional)."""

    def __init__(self, dim: int, codebook_size: int, decay: float = 0.8,
                 commitment: float = 1.0, eps: float = 1e-5):
        self.dim = dim
        self.n_embed = codebook_size
        self.decay = decay
        self.commitment = commitment
        self.eps = eps

    def init(self, generator: torch.Generator | None = None, *, seed: int = 0,
             device="cuda") -> VQState:
        """N(0, 1) codebook drawn on the CPU from ``generator`` (a fresh one
        seeded with ``seed`` if not given), then moved to ``device`` (the card
        by default, as the port's other entry points; raises without one)."""
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(seed)
        embed = torch.randn((self.dim, self.n_embed), generator=generator).to(device)
        return VQState(embed, torch.zeros((self.n_embed,), device=device), embed.clone())

    @torch.no_grad()
    def _ema_update(self, state: VQState, flat, onehot, axis_name=None) -> VQState:
        counts = psum(onehot.sum(0), axis_name)
        embed_sum = psum(flat.t() @ onehot, axis_name)
        d = self.decay
        cluster_size = state.cluster_size * d + counts * (1.0 - d)
        embed_avg = state.embed_avg * d + embed_sum * (1.0 - d)
        n = cluster_size.sum()
        smoothed = (cluster_size + self.eps) / (n + self.n_embed * self.eps) * n
        return VQState(embed_avg / smoothed[None, :], cluster_size, embed_avg)

    def __call__(self, state: VQState, x: torch.Tensor, train: bool, axis_name=None):
        """x: (..., dim). Returns (q_st, new_state, loss, perplexity)."""
        flat = x.reshape(-1, self.dim)
        ind, quantized = _quantize_core(state.embed, flat)
        onehot = F.one_hot(ind, self.n_embed).to(flat.dtype)
        quantized = quantized.reshape(x.shape)
        new_state = (self._ema_update(state, flat.detach(), onehot, axis_name) if train
                     else state)
        loss = self.commitment * torch.mean((quantized.detach() - x) ** 2)
        q_st = x + (quantized - x).detach()
        avg_probs = pmean(onehot.mean(0), axis_name)
        perplexity = torch.exp(-torch.sum(avg_probs * torch.log(avg_probs + 1e-10)))
        return q_st, new_state, loss, perplexity

    def forward_index(self, state: VQState, x: torch.Tensor):
        """Inference-path quantization: no EMA update. Returns (q_st, indices
        int64 of shape x.shape[:-1])."""
        flat = x.reshape(-1, self.dim)
        ind, quantized = _quantize_core(state.embed, flat)
        q_st = x + (quantized.reshape(x.shape) - x).detach()
        return q_st, ind.reshape(x.shape[:-1])


def _stack(states) -> VQState:
    return VQState(*(torch.stack(xs) for xs in zip(*states)))


def _layer(state: VQState, i: int) -> VQState:
    return VQState(*(t[i] for t in state))


class ResidualVQ:
    """Residual VQ over a stacked state ``(L, dim, K)``."""

    def __init__(self, dim: int, num_quantizers: int, codebook_size: int,
                 decay: float = 0.8, commitment: float = 1.0, eps: float = 1e-5):
        self.num_quantizers = num_quantizers
        self.codebook_size = codebook_size
        self.layer = VectorQuantizeEMA(dim, codebook_size, decay, commitment, eps)

    def init(self, generator: torch.Generator | None = None, *, seed: int = 0,
             device="cuda") -> VQState:
        """One N(0, 1) codebook per layer, drawn in layer order from
        ``generator`` (see :meth:`VectorQuantizeEMA.init`)."""
        if generator is None:
            generator = torch.Generator().manual_seed(seed)
        return _stack([self.layer.init(generator, device=device)
                       for _ in range(self.num_quantizers)])

    def __call__(self, state: VQState, x: torch.Tensor, train: bool, axis_name=None):
        """Returns (quantized_out, new_state, losses (L,), perplexities (L,)).
        The residual subtraction uses the straight-through ``q`` (not
        detached), as the reference does."""
        residual, q_out = x, torch.zeros_like(x)
        new_states, losses, ppls = [], [], []
        for i in range(self.num_quantizers):
            q, new_ls, loss, ppl = self.layer(_layer(state, i), residual, train=train,
                                              axis_name=axis_name)
            residual, q_out = residual - q, q_out + q
            new_states.append(new_ls)
            losses.append(loss)
            ppls.append(ppl)
        return q_out, _stack(new_states), torch.stack(losses), torch.stack(ppls)

    def forward_index(self, state: VQState, x: torch.Tensor, flatten_idx: bool = False):
        """Returns (quantized_out, indices (L, ...) int32); with
        ``flatten_idx`` layer i's indices are offset by ``i * codebook_size``."""
        residual, q_out = x, torch.zeros_like(x)
        idxs = []
        for i in range(self.num_quantizers):
            q, ind = self.layer.forward_index(_layer(state, i), residual)
            if flatten_idx:
                ind = ind + i * self.codebook_size
            residual, q_out = residual - q, q_out + q
            idxs.append(ind.to(torch.int32))
        return q_out, torch.stack(idxs)

    def flat_codebook(self, state: VQState) -> torch.Tensor:
        """(L*K, dim) lookup table for the rx side (vq_module.py:151-157)."""
        return state.embed.transpose(1, 2).reshape(-1, state.embed.shape[1])

    def lookup(self, flat_codebook: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
        """indices: (L, ...) flattened codes -> summed codewords (..., dim)."""
        emb = flat_codebook[indices.long()]
        return emb.sum(0)


class Quantizer:
    """The reference's Quantizer facade (modules/quantizer.py) on (B, T, D)
    activations."""

    def __init__(self, code_dim: int, codebook_num: int, codebook_size: int):
        self.rvq = ResidualVQ(code_dim, codebook_num, codebook_size)
        self.code_dim = code_dim
        self.codebook_num = codebook_num
        self.codebook_size = codebook_size

    def init(self, generator: torch.Generator | None = None, *, seed: int = 0,
             device="cuda") -> VQState:
        """The codec's seeded ``VQState`` (see :meth:`ResidualVQ.init`)."""
        return self.rvq.init(generator, seed=seed, device=device)

    def __call__(self, state: VQState, z, train: bool, axis_name=None):
        return self.rvq(state, z, train, axis_name)

    def inference(self, state: VQState, z):
        return self.rvq.forward_index(state, z)

    def encode(self, state: VQState, z):
        """Quantize to flattened tx indices (quantizer.py:42-44)."""
        return self.rvq.forward_index(state, z, flatten_idx=True)

    def decode(self, flat_codebook, indices):
        return self.rvq.lookup(flat_codebook, indices)
