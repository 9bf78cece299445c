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
``matmul``s) for CPU tensors only; for a CUDA tensor it launches the kernel or
raises. With bf16 weights every product multiplies bf16 by bf16, as the JAX
kernels' ``jnp.dot(a.astype(wd), w, preferred_element_type=f32)`` does: each
GEMM's activated operand is rounded to bf16 (:func:`mma_operand`); the sums,
the residual stream, biases and caches stay f32.
``<wrapper>.launches`` counts kernel launches; in a profiler trace each
wrapper's call is the span ``dse.launch.<wrapper>`` (utils/trace.py). The layer
kernels take B independent streams in one launch, as (B, time, C) activations
with (B, ctx, C) caches; a 2-D (time, C) call is the B = 1 case of the same
kernel. Activations are f32 or bf16 (:data:`ACT_DTYPES`, the streams' boundary
dtype between launches, ops/mega_stacked.py): a kernel widens bf16 to f32 as it
loads it, computes in f32 and rounds what it stores, and the plain version
rounds at the same point with ``.to(torch.bfloat16)``. Caches stay f32.
"""

from __future__ import annotations

import functools

import torch

from dl_speech_enhancement_tpu_torch.ops import _cuda
from dl_speech_enhancement_tpu_torch.utils.trace import spanned

KERNEL_SIZE = 7
DILATIONS = (1, 3, 9)
_MAX_SMEM = 232448  # bytes of shared memory one H100 block may use
_N_SM = 132
# Clusters the H100 runs at once (cudaOccupancyMaxActiveClusters, printed by
# tools/rvq_timing.py) by (cluster, blocks an SM): the GPCs, not the SMs, cap
# them, and one more would wait for a whole cluster to finish; else the SMs
# over the cluster's blocks.
_CLUSTERS_AT_ONCE = {(16, 1): 7, (16, 2): 14, (8, 1): 15, (8, 2): 29}


def _max_clusters(cluster: int, per_sm: int = 1) -> int:
    return _CLUSTERS_AT_ONCE.get((cluster, per_sm), _N_SM * per_sm // cluster)
ACT_DTYPES = (torch.float32, torch.bfloat16)  # activations between launches


def check_boundary_dtype(boundary_dtype) -> None:
    """Raise unless ``boundary_dtype`` is one the kernels take between
    launches: float32 or bfloat16."""
    if boundary_dtype not in ACT_DTYPES:
        raise ValueError(f"boundary_dtype must be float32 or bfloat16, got {boundary_dtype}")


def act_types(weights_bf16: bool, *acts_bf16: bool) -> int:
    """The C entries' ``types`` bits: bit 0 bf16 weights, then one bit each
    for the activations named (x, then the output where it has its own)."""
    bits = int(weights_bf16)
    for i, flag in enumerate(acts_bf16):
        bits |= int(flag) << (i + 1)
    return bits


def _elu(x: torch.Tensor) -> torch.Tensor:
    """ELU as the reference kernels write it: exp(min(x, 0)) - 1 below 0."""
    return torch.where(x > 0, x, torch.exp(torch.clamp(x, max=0.0)) - 1.0)


def mma_operand(a: torch.Tensor, weight_dtype) -> torch.Tensor:
    """A GEMM operand as the JAX kernels multiply it with weights of
    ``weight_dtype``: rounded to bf16 (to nearest even, as ``astype`` and the
    kernels round) and held in f32 where the weights are bf16; ``a`` itself
    where they are f32."""
    return a.to(torch.bfloat16).float() if weight_dtype == torch.bfloat16 else a


def chain_halo(dilations=DILATIONS, kernel_size: int = KERNEL_SIZE) -> int:
    """Cache rows one residual chain needs: sum of (k - 1) * d."""
    return sum((kernel_size - 1) * d for d in dilations)


def residual_chain_plain(cache, x, w1, w2, dilations=DILATIONS):
    """Plain PyTorch version of :func:`residual_chain`, in f32, on (time, C)
    or (B, time, C); returns x's dtype. With bf16 weights each conv's
    operand, ELU(x_ext) before conv1 and ELU(conv1) before conv2, is rounded
    to bf16 (JAX ops/stream_kernel.py:78,84); the residual stream stays f32."""
    h = torch.cat([cache, x.float()], dim=-2)
    wd, w1, w2 = w1.dtype, w1.float(), w2.float()
    for u, d in enumerate(dilations):
        pad = (KERNEL_SIZE - 1) * d
        rows = h.shape[-2] - pad
        a = mma_operand(_elu(h), wd)
        acc = a[..., 0:rows, :] @ w1[u, 0]
        for j in range(1, KERNEL_SIZE):
            acc = acc + a[..., j * d: j * d + rows, :] @ w1[u, j]
        h = h[..., pad:, :] + mma_operand(_elu(acc), wd) @ w2[u]
    return h.to(x.dtype)


def _check_operands(what, device, acts, weights, bias=None, cache=None,
                    act_dtypes=(torch.float32,)):
    """Raise unless the operands are what the kernels take: activations
    contiguous, of ``act_dtypes``, weights all f32 or all bf16, bias f32, and
    the cache f32 with contiguous rows (streams may lie at any stride: a cache
    is often the tail of the previous activation, a view)."""
    for name, t in acts.items():
        if t.device != device or t.dtype not in act_dtypes or not t.is_contiguous():
            names = " or ".join(str(d).replace("torch.", "") for d in act_dtypes)
            raise ValueError(f"{what}: {name} must be a contiguous {names} tensor on "
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


# csrc/residual_chain.cu, as the planner needs it: cluster sizes (blocks
# splitting a tile's C output channels, at most 64 a block), the W ring
# (tile_mma.cuh: 4 stages of 64-channel tiles), and the block's warps.
_CHAIN_CLUSTERS = (1, 2, 4, 8, 16)
_CHAIN_MAX_COLS = 64
_CHAIN_STAGES, _CHAIN_KC, _CHAIN_WARPS = 4, 64, 8
# The planner's model of a block (_chain_block_us), in us: its fixed time
# (launch, X load, write-back), a GEMM's cluster barrier with its first
# weight tiles behind it, a (tap, 64-channel) step's fixed time and its time
# per instruction a warp issues (the SM's four schedulers each issue one a
# cycle), and the window fill per float4 a thread copies, fitted to an H100
# sweep of every plan at the paths' chain sites (tools/chain_timing.py
# --sweep, then --fit on its report); blocks one SM holds at most (the
# kernel's 178-213 registers a thread, -Xptxas -v).
_CHAIN_BLOCK_US, _CHAIN_SYNC_US = 1.4, 1.0
_CHAIN_STEP_US, _CHAIN_INSTR_US = 0.05, 0.001
_CHAIN_COPY_US = 0.056
# the same for the bf16-weight arm (bf16 mma, bf16 windows, the clusters the
# card holds at once), fitted to its own sweep
_CHAIN_BLOCK_US_BF16, _CHAIN_SYNC_US_BF16 = 0.358, 0.0856
_CHAIN_STEP_US_BF16, _CHAIN_INSTR_US_BF16 = 0.00914, 0.00322
_CHAIN_COPY_US_BF16 = 0.0603
_CHAIN_BLOCKS_PER_SM = 1


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def _chain_nf(nc: int) -> int:
    """8-column mma fragments across a block computing ``nc`` columns (NF)."""
    return 1 if nc <= 8 else 2 if nc <= 16 else 4 if nc <= 32 else 8


def chain_lda(channels: int, bf16: bool = False) -> int:
    """Row stride of the kernel's A window: f32 (f32 weights), C rounded up
    to 8, plus 4; bf16 (bf16 weights), C rounded up to 16, plus 8."""
    return -(-channels // 16) * 16 + 8 if bf16 else -(-channels // 8) * 8 + 4


def chain_window_rows(tile: int, dilations=DILATIONS) -> int:
    """Rows of the A window for a tile of ``tile`` output rows: unit u's
    conv1 reads its output rows rounded up to 16 plus its reach 6 * d_u."""
    rows, remaining = 0, tile + chain_halo(dilations)
    for d in dilations:
        pad = (KERNEL_SIZE - 1) * d
        rows = max(rows, _round16(remaining - pad) + pad)
        remaining -= pad
    return rows


def chain_smem_bytes(tile: int, channels: int, cluster: int, dilations=DILATIONS,
                     bf16: bool = True) -> int:
    """Shared memory of one residual_chain block (csrc/residual_chain.cu::
    dse_residual_chain_smem): the W ring (4 stages of 64 weight rows by the
    block's columns rounded up to 8 fragments' width, plus 8), the block's
    f32 slice of X (tile + halo rows), the full-width A window and the
    block's slice of H (the first unit's conv1 rows), the last two in the
    weights' dtype (bf16 halves them)."""
    nc = channels // cluster
    halo = chain_halo(dilations)
    e = 2 if bf16 else 4  # bytes of a window element
    ring = _CHAIN_STAGES * _CHAIN_KC * (8 * _chain_nf(nc) + 8) * e
    h = (tile + halo - (KERNEL_SIZE - 1) * dilations[0]) * nc
    window = chain_window_rows(tile, dilations) * chain_lda(channels, bf16)
    return ring + 4 * (tile + halo) * nc + e * (h + window)


def chain_scratch_floats(tile: int, channels: int, dilations=DILATIONS,
                         bf16: bool = False) -> int:
    """Floats of device scratch one cluster of more than one block takes
    (csrc/residual_chain.cu::dse_residual_chain_scratch): the E rows of a
    tile (tile + halo) and its H rows (the first unit's conv1 rows), C
    elements each in the weights' dtype (a bf16 pair a float), through which
    the blocks exchange their slices."""
    halo = chain_halo(dilations)
    elems = (2 * (tile + halo) - (KERNEL_SIZE - 1) * dilations[0]) * channels
    return elems // 2 if bf16 else elems


def _chain_clusters(channels: int) -> list[int]:
    """Cluster sizes the kernel takes for C channels: each block's share a
    multiple of 4 channels, at most 64."""
    return [n for n in _CHAIN_CLUSTERS
            if channels % n == 0 and (channels // n) % 4 == 0
            and channels // n <= _CHAIN_MAX_COLS]


@functools.lru_cache(maxsize=64)
def chain_fit_error(channels: int, dilations: tuple = DILATIONS) -> str | None:
    """Why no plan of the residual_chain kernel fits C channels, or None:
    the planner's own test at its shortest tile, one row, f32 weights."""
    if not _chain_clusters(channels):
        return (f"the residual_chain kernel takes a multiple of 4 channels, at most "
                f"{_CHAIN_MAX_COLS * _CHAIN_CLUSTERS[-1]}, not {channels}")
    if not any(chain_smem_bytes(1, channels, n, dilations, False) <= _MAX_SMEM
               for n in _chain_clusters(channels)):
        return f"{channels} channels do not fit the residual_chain kernel's shared memory"
    return None


def _chain_warps(nf: int) -> tuple[int, int]:
    """(warps along the columns, 8-column fragments a warp) of a block of
    ``nf`` fragments: the warps go along the rows first (csrc/tile_mma.cuh
    MmaTile with kRows)."""
    warps_n = 1 if nf < 8 else 2
    return warps_n, nf // warps_n


def _chain_warp_rows(m: int, nf: int, bf16: bool = False) -> int:
    """16-row fragments a warp takes in one GEMM of ``m`` rows (csrc/
    residual_chain.cu::chain_gemm): as many as cover ``m`` in one pass, of
    1, 2 or 4, at most 4 fragments a warp in all with f32 weights, 8 with
    bf16."""
    warps_n, wn = _chain_warps(nf)
    most = 8 if bf16 else 4
    per_warp = -(-(-(-m // 16)) // (_CHAIN_WARPS // warps_n))
    return 1 if per_warp <= 1 or 2 * wn > most else 2 if per_warp <= 2 or 4 * wn > most else 4


def _chain_block_us(tile: int, channels: int, cluster: int, dilations=DILATIONS,
                    bf16: bool = True) -> float:
    """The planner's model of one block's time: per unit, two GEMMs, each
    behind a cluster barrier and a window fill (the rows times C elements,
    16 bytes a thread at a time), each walking its (tap, 64-channel) steps
    over its row passes. With f32 weights a step issues, per 8-channel slice
    and warp, 24 instructions per 16-row fragment (its A operand's loads and
    split), 4 per 8-column fragment (the weights') and 2 mma per pair; with
    bf16 weights, per 16-channel slice, 2 per 16-row fragment (an ldmatrix
    and its address), 1 per 8-column fragment (half an ldmatrix and its
    address) and 1 mma per pair. The busiest scheduler issues for the live
    warps it holds."""
    nc = channels // cluster
    nf = _chain_nf(nc)
    warps_n, wn = _chain_warps(nf)
    warps_m = _CHAIN_WARPS // warps_n
    slices = -(-channels // _CHAIN_KC)
    k8 = min(8, -(-channels // 8))
    k16 = min(4, -(-channels // 16))
    remaining = tile + chain_halo(dilations)
    block_us, sync_us, step_us, instr_us, copy_us = (
        (_CHAIN_BLOCK_US_BF16, _CHAIN_SYNC_US_BF16, _CHAIN_STEP_US_BF16, _CHAIN_INSTR_US_BF16,
         _CHAIN_COPY_US_BF16) if bf16 else
        (_CHAIN_BLOCK_US, _CHAIN_SYNC_US, _CHAIN_STEP_US, _CHAIN_INSTR_US, _CHAIN_COPY_US))
    total = block_us
    for d in dilations:
        m = remaining - (KERNEL_SIZE - 1) * d
        wm = _chain_warp_rows(m, nf, bf16)
        passes = -(-m // (16 * wm * warps_m))
        live = min(warps_m, -(-min(-(-m // 16), wm * warps_m) // wm)) * warps_n
        instr = ((2 * wm + wn + wm * wn) * k16 if bf16
                 else (24 * wm + 4 * wn + 2 * wm * wn) * k8)
        step = step_us + instr_us * instr * -(-live // 4)
        fills = (remaining + m) * channels * (2 if bf16 else 4) / 16 / 256
        total += (2 * sync_us + copy_us * fills + passes * (KERNEL_SIZE + 1) * slices * step)
        remaining = m
    return total


def _chain_cost(batch: int, rows: int, tile: int, channels: int, cluster: int, smem: int,
                dilations=DILATIONS, bf16: bool = True) -> tuple[float, int]:
    """(us, blocks) of one launch at the plan (tile, cluster): the grid of
    ``batch * ceil(rows / tile) * cluster`` blocks in waves of the blocks the
    SMs hold (for the bf16-weight arm, whose constants were fitted with it,
    the clusters the card holds at once), blocks sharing an SM each as slow
    as their count."""
    blocks = batch * -(-rows // tile) * cluster
    per_sm = max(1, min(_CHAIN_BLOCKS_PER_SM, (_MAX_SMEM + 1024) // (smem + 1024)))
    at_once = _max_clusters(cluster, per_sm) * cluster if bf16 else _N_SM * per_sm
    waves = -(-blocks // at_once)
    sharing = min(per_sm, -(-blocks // _N_SM))
    return waves * sharing * _chain_block_us(tile, channels, cluster, dilations, bf16), blocks


def chain_plans(rows: int, channels: int, dilations=DILATIONS,
                bf16: bool = True) -> list[tuple[int, int, int]]:
    """Every plan the kernel takes for ``rows`` rows a stream at C channels,
    as ``(tile, cluster, shared memory)``: tiles of 4 to 1024 rows, those
    whose first conv1 fills whole 64-row passes (64k - 72 rows), and the
    whole of ``rows``, no longer than ``rows``; each cluster size of
    :func:`_chain_clusters`, where the block's shared memory fits."""
    first = (KERNEL_SIZE - 1) * (sum(dilations) - dilations[0])  # unit 0's rows past the tile
    tiles = sorted({t for t in (4, 8, 16, 20, 32, 48, 64, 96, 128, 192, 256, 384, 512, 768,
                                1024, rows, *range(64 - first % 64, 513, 64)) if 0 < t <= rows})
    return [(tile, cluster, smem) for cluster in _chain_clusters(channels) for tile in tiles
            if (smem := chain_smem_bytes(tile, channels, cluster, dilations, bf16))
            <= _MAX_SMEM]


@functools.lru_cache(maxsize=256)
def _chain_plan(batch: int, rows: int, channels: int, dilations: tuple = DILATIONS,
                bf16: bool = True) -> tuple[int, int]:
    """(tile, cluster) for the residual-chain kernel: output rows per time
    tile, and blocks per cluster splitting the channels of one tile, for
    ``batch`` streams of ``rows`` rows each.

    Every tile recomputes its 78-row halo, so long tiles waste less work,
    but fewer tiles fill fewer SMs, and a long tile's full-width window
    outgrows shared memory; a wider cluster spreads a tile over more SMs,
    each with fewer columns, at the price of its window copies. Of the plans
    :func:`chain_plans` lists, the model (:func:`_chain_cost`) takes the one
    with the fewest blocks within 5 % of the cheapest. Pure Python, so the
    CPU tests hold it; no plan changes a stream's bits."""
    dilations = tuple(dilations)
    plans = [(*_chain_cost(batch, rows, tile, channels, cluster, smem, dilations, bf16),
              (tile, cluster)) for tile, cluster, smem in chain_plans(rows, channels,
                                                                      dilations, bf16)]
    if not plans:
        raise ValueError(f"residual_chain: no plan fits at C={channels}")
    cheapest = min(p[0] for p in plans)
    return min((blocks, cost, plan) for cost, blocks, plan in plans
               if cost <= 1.05 * cheapest)[2]


@spanned("launch.residual_chain")
def residual_chain(cache: torch.Tensor, x: torch.Tensor, w1: torch.Tensor,
                   w2: torch.Tensor, dilations=DILATIONS) -> torch.Tensor:
    """Three fused causal residual units over ``[cache; x]``, for B streams.

    cache: (B, sum (k-1)*d, C) f32, x: (B, T, C) f32 or bf16 (or (halo, C) /
    (T, C) for one stream), w1: (3, 7, C, C) and w2: (3, C, C) in f32 or bf16
    ((tap, in, out) layout). Returns x's shape and dtype. A stream's new chain
    cache is the last ``halo`` rows of its ``[cache; x]``, in f32."""
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
    _check_operands("residual_chain", x.device, {"x": x}, (w1, w2), cache=cache,
                    act_dtypes=ACT_DTYPES)
    reason = chain_fit_error(C, dilations)
    if reason:
        raise ValueError(f"residual_chain: {reason}")
    if (w1.data_ptr() | w2.data_ptr()) % 16:
        raise ValueError("residual_chain: the weights must be 16-byte aligned")
    out = torch.empty_like(x)
    if B * T == 0:
        return out
    bf16 = w1.dtype == torch.bfloat16
    tile, cluster = _chain_plan(B, T, C, dilations, bf16)
    scratch = None
    if cluster > 1:
        scratch = torch.empty(B * -(-T // tile) * chain_scratch_floats(tile, C, dilations,
                                                                       bf16), device=x.device)
    lib = _cuda.load("residual_chain")
    _cuda.launch(lib, "dse_residual_chain", "residual_chain", x, cache.data_ptr(),
                 cache.stride(0), x.data_ptr(), w1.data_ptr(), w2.data_ptr(), out.data_ptr(),
                 None if scratch is None else scratch.data_ptr(), B, T, C, *dilations, tile,
                 cluster, act_types(bf16, x.dtype == torch.bfloat16))
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
                                      kernel_size: int = KERNEL_SIZE,
                                      weight_dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_residual_chain_folded`, in the
    JAX kernel's folded form: ``fold`` consecutive rows side by side, each
    dilated conv a sum over row offsets ``o`` of (fold*C, fold*C) block
    matrices ``M_o[b-block, p-block] = W_j`` where ``(o, b) = divmod(p + j*d,
    fold)``, the 1x1 conv block-diagonal. x (T_in, C) -> (T_in - halo, C).
    ``weight_dtype`` bf16 rounds the weights and each conv's operand as
    :func:`residual_chain_plain` does (folding moves rows, not values)."""
    _check_fold(x, fold, dilations, kernel_size)
    k, (t_in, c) = kernel_size, x.shape
    h = x.float().reshape(t_in // fold, fold * c)
    for u, d in zip(units, dilations):
        w1 = u.conv1.weight.detach().permute(2, 1, 0).to(weight_dtype).float()  # (k, in, out)
        w2 = u.conv2.weight.detach()[:, :, 0].t().to(weight_dtype).float()
        offsets = (k - 1) * d // fold
        m1 = w1.new_zeros((offsets + 1, fold * c, fold * c))
        for j in range(k):
            for p in range(fold):
                o, b = divmod(p + j * d, fold)
                m1[o, b * c:(b + 1) * c, p * c:(p + 1) * c] = w1[j]
        m2 = torch.block_diag(*[w2] * fold)
        rows = h.shape[0] - offsets
        a = mma_operand(_elu(h), weight_dtype)
        acc = a[0:rows] @ m1[0]
        for o in range(1, offsets + 1):
            acc = acc + a[o:o + rows] @ m1[o]
        h = h[offsets:] + mma_operand(_elu(acc), weight_dtype) @ m2
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
    stream, in the cache's dtype: a layer's next cache. A view of ``x`` where
    it holds them and has that dtype; where ``x`` is a bf16 activation, its
    rows widened to the f32 cache (exactly, as the JAX package's caches hold
    a bf16 boundary's values in f32)."""
    t = x.shape[-2]
    if t >= n:
        return x[..., t - n:, :].to(cache.dtype)
    return torch.cat([cache[..., t:, :], x.to(cache.dtype)], dim=-2)


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
        reason = chain_fit_error(blk.res_units[0].conv1.in_channels)
        if reason:
            return reason
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
