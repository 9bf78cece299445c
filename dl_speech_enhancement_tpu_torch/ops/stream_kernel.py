"""The fused causal residual chain (CUDA) and the per-frame fused chunk step.

Counterpart of dl_speech_enhancement_tpu/ops/stream_kernel.py. The residual
chain (three causal residual units at dilations 1/3/9: ELU -> k=7 dilated
conv -> ELU -> 1x1 -> residual add) dominates every encoder and decoder
block; :func:`residual_chain` runs it as one hand-written kernel
(csrc/residual_chain.cu) that reads the cache-prepended input once and
writes the output once. :func:`make_fused_chunk_step` assembles a per-frame
streaming step from it, with the boundary convs left to the plain modules,
as the JAX package leaves them to XLA.

Each kernel wrapper takes its plain PyTorch version (tap-by-tap f32
``matmul``s) for CPU tensors only; for a CUDA tensor it launches the kernel
or raises. ``<wrapper>.launches`` counts kernel launches. The layer kernels
take B independent streams in one launch, as (B, time, C) activations with
(B, ctx, C) caches; a 2-D (time, C) call is the B = 1 case of the same
kernel.
"""

from __future__ import annotations

import functools

import torch

from dl_speech_enhancement_tpu_torch.ops import _cuda

KERNEL_SIZE = 7
DILATIONS = (1, 3, 9)
_MAX_SMEM = 232448  # bytes of shared memory one H100 block may use
_N_SM = 132
_BK = 32  # input channels per GEMM step (csrc/tile_gemm.cuh kBK)


def _elu(x: torch.Tensor) -> torch.Tensor:
    """ELU as the reference kernels write it: exp(min(x, 0)) - 1 below 0."""
    return torch.where(x > 0, x, torch.exp(torch.clamp(x, max=0.0)) - 1.0)


def chain_halo(dilations=DILATIONS, kernel_size: int = KERNEL_SIZE) -> int:
    """Cache rows one residual chain needs: sum of (k - 1) * d."""
    return sum((kernel_size - 1) * d for d in dilations)


def residual_chain_plain(cache, x, w1, w2, dilations=DILATIONS):
    """Plain PyTorch version of :func:`residual_chain`, in f32, on (time, C)
    or (B, time, C)."""
    h = torch.cat([cache, x], dim=-2)
    w1, w2 = w1.float(), w2.float()
    for u, d in enumerate(dilations):
        pad = (KERNEL_SIZE - 1) * d
        rows = h.shape[-2] - pad
        a = _elu(h)
        acc = a[..., 0:rows, :] @ w1[u, 0]
        for j in range(1, KERNEL_SIZE):
            acc = acc + a[..., j * d: j * d + rows, :] @ w1[u, j]
        h = h[..., pad:, :] + _elu(acc) @ w2[u]
    return h


def _check_operands(what, device, acts, weights, bias=None, cache=None):
    """Raise unless the operands are what the kernels take: activations
    contiguous f32, weights all f32 or all bf16, bias f32, and the cache f32
    with contiguous rows (streams may lie at any stride: a cache is often the
    tail of the previous activation, a view)."""
    for name, t in acts.items():
        if t.device != device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous float32 tensor on "
                             f"{device}, got {t.dtype} on {t.device}")
    if cache is not None and (cache.device != device or cache.dtype != torch.float32
                              or cache.stride(-1) != 1
                              or (cache.shape[-2] > 1 and cache.stride(-2) != cache.shape[-1])):
        raise ValueError(f"{what}: the cache must be float32 on {device} with contiguous rows")
    dtypes = {t.dtype for t in weights}
    if len(dtypes) != 1 or not dtypes <= {torch.float32, torch.bfloat16}:
        raise ValueError(f"{what}: weights must all be float32 or all bfloat16")
    for t in weights:
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"{what}: weights must be contiguous on {device}")
    if bias is not None and (bias.device != device or bias.dtype != torch.float32
                             or not bias.is_contiguous()):
        raise ValueError(f"{what}: bias must be a contiguous float32 tensor on {device}")


@functools.lru_cache(maxsize=256)
def _chain_plan(batch: int, rows: int, channels: int, dilations: tuple) -> tuple[int, int]:
    """(tile, cluster) for the residual-chain kernel: output rows per time
    tile, and blocks per cluster splitting the channels of one tile, for
    ``batch`` streams of ``rows`` rows each.

    Every tile recomputes its halo, so long tiles waste less work, but fewer
    tiles use fewer SMs. The model counts, for each candidate, the GEMM steps
    one block makes (each step is the same work, tile_gemm.cuh) times the
    blocks one SM runs in turn or side by side, over the whole grid of
    ``batch * ceil(rows / tile) * cluster`` blocks, and takes the smallest
    among the candidates whose shared memory fits; ties go to fewer blocks."""
    lib = _cuda.load("residual_chain")
    halo = chain_halo(dilations)
    k_slices = -(-channels // _BK)
    clusters = [1] + [n for n in (2, 4, 8) if channels % (n * _BK) == 0]

    def cost(tile, cluster):
        smem = lib.dse_residual_chain_smem(tile, channels, cluster, *dilations)
        if smem > _MAX_SMEM:
            return None
        nc = channels // cluster
        bm = lib.dse_residual_chain_block_rows(channels, cluster)
        col_tiles = -(-nc // (32 if nc <= 32 else 64))
        steps, remaining = 0, tile + halo
        for d in dilations:
            remaining -= (KERNEL_SIZE - 1) * d
            steps += -(-remaining // bm) * col_tiles * (KERNEL_SIZE + 1) * k_slices
        blocks = batch * -(-rows // tile) * cluster
        per_sm = max(1, min(8, (_MAX_SMEM + 1024) // (smem + 1024)))
        waves = -(-blocks // (_N_SM * per_sm))
        sharing = min(per_sm, -(-blocks // _N_SM))  # blocks an SM runs at once
        return waves * sharing * steps, blocks

    plans = []
    for cluster in clusters:
        for tile in (4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, rows):
            if tile <= rows:
                c = cost(tile, cluster)
                if c is not None:
                    plans.append((c, (tile, cluster)))
    if not plans:
        raise ValueError(f"residual_chain: no tile fits shared memory at C={channels}")
    return min(plans)[1]


def residual_chain(cache: torch.Tensor, x: torch.Tensor, w1: torch.Tensor,
                   w2: torch.Tensor, dilations=DILATIONS) -> torch.Tensor:
    """Three fused causal residual units over ``[cache; x]``, for B streams.

    cache: (B, sum (k-1)*d, C) f32, x: (B, T, C) f32 (or (halo, C) / (T, C)
    for one stream), w1: (3, 7, C, C) and w2: (3, C, C) in f32 or bf16 ((tap,
    in, out) layout). Returns x's shape in f32. A stream's new chain cache is
    the last ``halo`` rows of its ``[cache; x]``."""
    if x.device.type == "cpu":
        return residual_chain_plain(cache, x, w1, w2, dilations)
    if x.device.type != "cuda":
        raise ValueError(f"residual_chain: unsupported device {x.device}")
    if x.dim() == 2 and cache.dim() == 2:
        return residual_chain(cache[None], x[None], w1, w2, dilations)[0]
    dilations = tuple(int(d) for d in dilations)
    if x.dim() != 3:
        raise ValueError(f"residual_chain: x must be (B, T, C), got {tuple(x.shape)}")
    B, T, C = x.shape
    if len(dilations) != 3 or cache.shape != (B, chain_halo(dilations), C):
        raise ValueError(f"residual_chain: cache {tuple(cache.shape)} does not fit "
                         f"dilations {dilations} at x {tuple(x.shape)}")
    if w1.shape != (3, KERNEL_SIZE, C, C) or w2.shape != (3, C, C):
        raise ValueError(f"residual_chain: weights {tuple(w1.shape)}, {tuple(w2.shape)} "
                         f"do not fit C={C}")
    _check_operands("residual_chain", x.device, {"x": x}, (w1, w2), cache=cache)
    out = torch.empty_like(x)
    if B * T == 0:
        return out
    lib = _cuda.load("residual_chain")
    tile, cluster = _chain_plan(B, T, C, dilations)
    err = lib.dse_residual_chain(cache.data_ptr(), cache.stride(0), x.data_ptr(),
                                 w1.data_ptr(), w2.data_ptr(), out.data_ptr(), B, T, C,
                                 *dilations, tile, cluster, int(w1.dtype == torch.bfloat16),
                                 _cuda.stream_handle(x))
    _cuda.check(lib, err, "residual_chain")
    residual_chain.launches += 1
    return out


residual_chain.launches = 0


def chain_weights(units, weight_dtype=torch.float32):
    """Stack three ResidualUnits' weights as the kernel takes them:
    w1 (3, 7, C, C) and w2 (3, C, C), (tap, in, out)."""
    w1 = torch.stack([u.conv1.weight.detach().permute(2, 1, 0) for u in units])
    w2 = torch.stack([u.conv2.weight.detach()[:, :, 0].t() for u in units])
    return (w1.to(weight_dtype).contiguous(), w2.to(weight_dtype).contiguous())


def fused_residual_chain(units, x: torch.Tensor, *, dilations=DILATIONS,
                         kernel_size: int = KERNEL_SIZE,
                         weight_dtype=torch.float32) -> torch.Tensor:
    """N=3 chained causal residual units on a cache-prepended chunk
    ``x`` (T_in, C) with T_in = halo + T; ``units`` are the port's
    ResidualUnit modules. Returns (T, C)."""
    if kernel_size != KERNEL_SIZE:
        raise ValueError(f"residual_chain supports kernel_size {KERNEL_SIZE}")
    halo = chain_halo(dilations, kernel_size)
    w1, w2 = chain_weights(units, weight_dtype)
    return residual_chain(x[:halo], x[halo:], w1, w2, dilations)


def _check_fold(x: torch.Tensor, fold: int, dilations, kernel_size: int) -> None:
    """JAX ``fused_residual_chain_folded``'s asserts as ValueErrors."""
    c, t_in = x.shape[1], x.shape[0]
    pads = [(kernel_size - 1) * d for d in dilations]
    if fold < 1 or fold * c > 128:
        raise ValueError(f"fold {fold} x {c} channels must pack into at most 128 lanes")
    if any(p % fold for p in pads):
        raise ValueError(f"fold {fold} must divide every unit's pad {pads}")
    if t_in % fold:
        raise ValueError(f"fold {fold} must divide the input length {t_in}")
    if t_in <= sum(pads):
        raise ValueError(f"input of {t_in} rows holds no row past the chain's {sum(pads)}")


def fused_residual_chain_folded_plain(units, x: torch.Tensor, fold: int, *,
                                      dilations=DILATIONS,
                                      kernel_size: int = KERNEL_SIZE) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_residual_chain_folded`, in the
    JAX kernel's folded form: ``fold`` consecutive rows side by side, each
    dilated conv a sum over row offsets ``o`` of (fold*C, fold*C) block
    matrices ``M_o[b-block, p-block] = W_j`` where ``(o, b) = divmod(p + j*d,
    fold)``, the 1x1 conv block-diagonal. x (T_in, C) -> (T_in - halo, C)."""
    _check_fold(x, fold, dilations, kernel_size)
    k, (t_in, c) = kernel_size, x.shape
    h = x.float().reshape(t_in // fold, fold * c)
    for u, d in zip(units, dilations):
        w1 = u.conv1.weight.detach().permute(2, 1, 0).float()  # (k, in, out)
        w2 = u.conv2.weight.detach()[:, :, 0].t().float()
        offsets = (k - 1) * d // fold
        m1 = w1.new_zeros((offsets + 1, fold * c, fold * c))
        for j in range(k):
            for p in range(fold):
                o, b = divmod(p + j * d, fold)
                m1[o, b * c:(b + 1) * c, p * c:(p + 1) * c] = w1[j]
        m2 = torch.block_diag(*[w2] * fold)
        rows = h.shape[0] - offsets
        a = _elu(h)
        acc = a[0:rows] @ m1[0]
        for o in range(1, offsets + 1):
            acc = acc + a[o:o + rows] @ m1[o]
        h = h[offsets:] + _elu(acc) @ m2
    return h.reshape(-1, c)


def fused_residual_chain_folded(units, x: torch.Tensor, fold: int, *, dilations=DILATIONS,
                                kernel_size: int = KERNEL_SIZE) -> torch.Tensor:
    """Counterpart of the JAX ``fused_residual_chain_folded`` (K1f): the three
    causal residual units of :func:`fused_residual_chain` on ``x`` (T_in, C),
    with JAX's contract (``fold * C <= 128``, ``fold`` divides every pad
    ``(k-1)*d`` and ``T_in``; else ValueError). Returns (T_in - sum of pads,
    C).

    On the TPU, folding ``fold`` time steps into 128 lanes fills lanes that a
    narrow chain leaves idle. A Hopper block has no lanes to fill: the
    residual_chain kernel (csrc/residual_chain.cu) tiles time and channels
    itself, and the folded function equals the unfolded one. So K1f runs that
    kernel on the unfolded layout; :func:`fused_residual_chain_folded_plain`
    keeps the folded arithmetic, and the two are held against each other."""
    _check_fold(x, fold, dilations, kernel_size)
    return fused_residual_chain(units, x, dilations=dilations, kernel_size=kernel_size)


def tail(cache: torch.Tensor, x: torch.Tensor, n: int) -> torch.Tensor:
    """The last ``n`` rows of ``[cache; x]`` along the time axis (-2), per
    stream: a layer's next cache. A view of ``x`` where it holds them."""
    t = x.shape[-2]
    if t >= n:
        return x[..., t - n:, :]
    return torch.cat([cache[..., t:, :], x], dim=-2)


def chain_topology_error(gen) -> str | None:
    """Why the fused chain route cannot run ``gen``, or None if it can."""
    blocks = list(gen.encoder.blocks) + list(gen.decoder.blocks)
    for blk in blocks:
        for u in blk.res_units:
            if u.conv1.kernel_size != KERNEL_SIZE:
                return (f"fused chunk step supports residual kernel_size {KERNEL_SIZE}, "
                        f"got {u.conv1.kernel_size}")
        dil = tuple(u.conv1.dilation for u in blk.res_units)
        if dil != DILATIONS:
            return f"fused chunk step supports residual dilations {DILATIONS}, got {dil}"
    if gen.encoder.conv.kernel_size != 7 or gen.decoder.conv2.kernel_size != 7:
        return ("fused chunk step supports kernel_size-7 input/output convs, got "
                f"{gen.encoder.conv.kernel_size}/{gen.decoder.conv2.kernel_size}")
    if gen.mode != "causal":
        return f"fused chunk step needs a causal generator, got mode {gen.mode!r}"
    return None


def make_fused_chunk_step(gen):
    """Streaming chunk step (without-PQC denoiser) with every residual chain
    run by the residual_chain kernel; the boundary convs (input, strided,
    transposed, output) run through the plain modules. Cache layout:
    ``{"chains": [tensor...], "convs": {name: tensor}}``, one (pad, C) tensor
    per chain / boundary conv.

    Returns ``(init_cache(), step(cache, chunk (T, C)) -> (y (T, C), cache))``.
    The chunk length must be a multiple of ``gen.hop``."""
    if gen.use_pqc:
        raise NotImplementedError("the fused chunk step covers the without-PQC denoiser")
    reason = chain_topology_error(gen)
    if reason:
        raise ValueError(reason)
    halo = chain_halo()
    enc_blocks, dec_blocks = gen.encoder.blocks, gen.decoder.blocks
    weights = [chain_weights(b.res_units) for b in list(enc_blocks) + list(dec_blocks)]
    device = gen.device

    def zeros(rows, ch):
        return torch.zeros((rows, ch), device=device)

    def init_cache():
        cache = {"chains": [], "convs": {"enc_in": zeros(6, gen.input_channels)}}
        for bi, blk in enumerate(enc_blocks):
            cache["chains"].append(zeros(halo, blk.conv.in_channels))
            cache["convs"][f"enc_down{bi}"] = zeros(blk.conv.pad_length,
                                                    blk.conv.in_channels)
        for bi, blk in enumerate(dec_blocks):
            cache["convs"][f"dec_up{bi}"] = zeros(1, blk.conv.in_channels)
            cache["chains"].append(zeros(halo, blk.conv.out_channels))
        cache["convs"]["dec_out"] = zeros(6, gen.decoder.conv2.in_channels)
        return cache

    def conv_step(layer, cache, x):
        y, new_cache = layer.step(cache[None], x[None])
        return y[0], new_cache[0]

    def chain(ci, cache, h):
        h = h.contiguous()
        return residual_chain(cache, h, *weights[ci]), tail(cache, h, halo)

    @torch.no_grad()
    def step(cache, x):
        chains, convs = cache["chains"], cache["convs"]
        new_chains, new_convs = [], {}
        h, new_convs["enc_in"] = conv_step(gen.encoder.conv, convs["enc_in"], x)
        for bi, blk in enumerate(enc_blocks):
            h, c = chain(bi, chains[bi], h)
            new_chains.append(c)
            h, new_convs[f"enc_down{bi}"] = conv_step(blk.conv, convs[f"enc_down{bi}"], h)
        for bi, blk in enumerate(dec_blocks):
            ci = len(enc_blocks) + bi
            h, new_convs[f"dec_up{bi}"] = conv_step(blk.conv, convs[f"dec_up{bi}"], h)
            h, c = chain(ci, chains[ci], h)
            new_chains.append(c)
        y, new_convs["dec_out"] = conv_step(gen.decoder.conv2, convs["dec_out"], h)
        return y, {"chains": new_chains, "convs": new_convs}

    return init_cache, step
