"""Whole-model streaming of the AudioDec generator on hand-written kernels.

Counterpart of dl_speech_enhancement_tpu/ops/mega_kernel.py::make_mega_stream
(K2) and ::make_mega_stream_batched (K3a). On the TPU those functions compile
the whole encoder and the whole decoder into one Pallas kernel each, with
``grid=(n_frames,)`` running frame after frame and the streaming caches held
in VMEM between grid steps; K3a does the same for B streams in a (B, time,
C) layout. Hopper runs blocks in no order, so that design does not carry
over. Instead:

- Every layer is causal and a dispatch's chunk is a whole number of hops, so
  streaming N consecutive frames with carried caches equals running each
  layer once over the N * chunk samples with its cache prepended. ``run``
  does exactly that, layer by layer, which gives the card N frames of
  parallel work per launch; with N = 1 the same code is the real-time path.
  Each layer's new cache is the tail of its input.
- B independent streams go through each layer in the same launch: the
  activations are (B, N * chunk, C), the caches (B, ctx, C), and every kernel
  keeps each window inside its own stream. So a dispatch is 18 launches (22
  with PQC) whatever B is, and at N = 1 the deep layers get B times the 4-20
  rows of one stream. One copy each way, outside the kernels, turns frames
  (N, B, chunk) into per-stream samples (B, N * chunk) and back.
- The encoder half (:func:`mega_encoder`) is the launch sequence input conv
  -> 4 x (residual_chain, downsample) and replaces the TPU ``enc_kernel``;
  the decoder half (:func:`mega_decoder`) is 4 x (upsample, residual_chain)
  -> output conv and replaces ``dec_kernel``. They use three kernels:
  residual_chain (ops/stream_kernel.py, csrc/residual_chain.cu),
  :func:`causal_conv` (csrc/causal_conv.cu) and :func:`causal_conv_transpose`
  (csrc/causal_conv_transpose.cu). :func:`join_halves` runs one after the
  other; an asymmetric receiver joins one generator's encoder to another's
  decoder (parallel/serve.py).
- With PQC (the symAD codec) four launches join them: the projector
  (causal_conv, k=3, 512 -> code_dim) and :func:`rvq_assign`
  (csrc/rvq_assign.cu, the residual-VQ search emitting the int32 wire codes)
  end the encoder half; :func:`codebook_lookup` (csrc/codebook_lookup.cu)
  and the decoder input conv (causal_conv, k=7, code_dim -> 512) start the
  decoder half. The wire codes are the hand-off between the halves and are
  returned beside the audio, as the TPU kernels hand them from ``enc_kernel``
  to ``dec_kernel``. The lookup records a code outside its book in a word
  of host memory that the card writes (:class:`BadCodeWord`), so no
  dispatch waits for the card; the decoder half raises at its next call.
- Weights are assembled once, at build time, into the kernels' (tap, in,
  out) layout and ``weight_dtype`` (bf16 by default, as in the JAX package).
  With bf16 weights every product is bf16 by bf16 with an f32 sum, as the
  JAX kernels' ``jnp.dot(a.astype(wd), w, preferred_element_type=f32)``:
  each layer rounds its activated input rows to bf16 before the product
  (the input conv, the downsamples, whose 0/1 row selection in JAX
  (ops/mega_kernel.py:405) picks rows it then rounds, the projector, the
  decoder input conv, the upsamples and the output conv; the chains round
  ELU(x) and ELU(conv1), ops/stream_kernel.py), and nothing else: biases,
  the residual stream, caches and sums stay f32. Codebooks, their squared
  norms and the distances stay f32 whatever ``weight_dtype`` is. That is
  the counterpart of the TPU's one-time VMEM load.
- ``boundary_dtype`` (f32 by default) is the dtype of every dense activation
  that leaves one launch for the next: bf16 halves that traffic. Each kernel
  loads and stores it itself (no conversion launch), and computes in f32 on
  the widened values; the int32 wire codes are never converted, the final
  audio stays f32, and the caches stay f32 (a bf16 activation's tail widened
  exactly), as JAX ``_assemble`` (ops/mega_stacked.py:173-180) keeps them.
  The launch boundaries here are the layers, finer than JAX's stages in the
  chains' three units (one launch, no rounding between them) and coarser at
  the PQC projector and lookup (their outputs z and zq cross a launch, so
  they are rounded too).
- The TPU's time folding and 0/1 selection / replication / permutation
  matmuls work around TPU lanes and Mosaic; the CUDA kernels index strided
  rows, transposed phases and streams directly.

Math (zero caches at stream start), per stream:

- causal conv, stride s, dilation d: ``y[t] = b + sum_j x_ext[s*t + j*d] @
  W[j]`` with ``x_ext = [cache((k-1)*d); x]``.
- causal transposed conv, k = 2s, conv-ready kernel Wc, cpad = s - 1:
  ``y[s*r+p] = b + x_ext[r] @ Wc[cpad-p] + x_ext[r+1] @ Wc[cpad+s-p]`` with
  ``x_ext = [cache(1); x]``. Phase p is a 2-tap conv over the one-row
  cache whose rows are written at stride s, offset p: the kernel runs the
  causal conv's GEMM arm on each phase (csrc/conv_gemm.cuh), planned by
  :func:`_upsample_plan`.
"""

from __future__ import annotations

import ctypes
import functools
import threading
import weakref
from typing import Callable, NamedTuple

import torch

from dl_speech_enhancement_tpu_torch.ops import _cuda
from dl_speech_enhancement_tpu_torch.ops.stream_kernel import (
    _MAX_SMEM,
    _N_SM,
    _max_clusters as _rvq_max_clusters,
    ACT_DTYPES,
    _check_operands,
    act_types,
    chain_halo,
    chain_topology_error,
    chain_weights,
    check_boundary_dtype,
    mma_operand,
    residual_chain,
    tail,
)
from dl_speech_enhancement_tpu_torch.utils.trace import span, spanned

# ---------------------------------------------------------------- kernels


def _leaky(x, slope):
    """LeakyReLU as the reference writes it: x where x >= 0, else slope * x."""
    return torch.where(x >= 0, x, slope * x)


def _loaded(cache, x, leaky):
    """``[cache; x]`` in f32, with LeakyReLU(``leaky``) applied unless it is
    None."""
    h = torch.cat([cache, x.float()], dim=-2)
    return h if leaky is None else _leaky(h, leaky)


def causal_conv_plain(cache, x, w, b=None, stride: int = 1, dilation: int = 1,
                      leaky: float | None = None, tanh: bool = False, out_dtype=None):
    """Plain PyTorch version of :func:`causal_conv`, in f32, on (time, C) or
    (B, time, C); returns ``out_dtype`` (x's by default). With bf16 weights
    the input rows are rounded to bf16 after the activation, as the JAX
    kernels round ``v.astype(wd)`` before each product."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    h = mma_operand(_loaded(cache, x, leaky), w.dtype)
    w = w.float()
    rows = x.shape[-2] // stride
    span = stride * (rows - 1) + 1
    y = h[..., 0:span:stride, :] @ w[0]
    for j in range(1, w.shape[0]):
        y = y + h[..., j * dilation: j * dilation + span: stride, :] @ w[j]
    y = y if b is None else y + b
    return (torch.tanh(y) if tanh else y).to(out_dtype)


# csrc/causal_conv.cu, as the planner needs it
CONV_ARMS = ("cin1", "cout1", "gemm")  # the C entry's arm codes 0, 1, 2
# The GEMM arm's tiles by index (DSE_CONV_TILES, then DSE_CONV_TILES_BF16X):
# warps along rows and columns, 16-row and 8-column mma fragments a warp. The
# last, of 16 x 64-output warps, is the bf16-x arm's with bf16 weights
# alone; the others are every arm's (the first _CONV_TILES_F32X).
_CONV_TILES = ((1, 2, 1, 1), (1, 4, 1, 1), (2, 4, 1, 2), (2, 4, 2, 2), (4, 2, 1, 2),
               (8, 1, 1, 4), (8, 1, 1, 8))
_CONV_TILES_F32X = 6
# The planner's model of a tile (_gemm_cost): registers a thread (-Xptxas -v;
# 256-thread tiles are held to 128, two blocks an SM) and the time of one
# 64-term step, in us, with the block, fold and fold-element times below,
# fitted so that at every GEMM site of the paths the model picks a plan close
# to the fastest of an H100 sweep of them all (tools/conv_timing.py --sweep,
# then --fit on its report). The bf16-x arm has its own step and block times.
_CONV_TILE_REGS = (120, 115, 128, 128, 128, 128, 128)
_CONV_STEP_US = (0.3, 0.2, 0.216, 0.475, 0.864, 0.864)
_CONV_BLOCK_US, _CONV_FOLD_US, _CONV_FOLD_US_PER_ELEM = 3.54, 0.444, 0.0067
_CONV_STEP_US_BF16X = (0.19, 0.332, 0.086, 0.397, 0.403, 0.18, 0.3)
_CONV_BLOCK_US_BF16X = 1.01
# ring depth, channels a step, A row stride (f32 x; bf16 x)
_CONV_STAGES, _CONV_KC, _CONV_LDA, _CONV_LDA_H = 3, 64, 68, 72
_CONV_MAX_CLUSTER = 8
_CONV_MIN_BLOCKS = 32  # SMs a plan within 10 % of the cheapest should cover
_DIRECT_ROWS = (256, 128, 64, 32, 16, 8, 4, 2, 1)  # Cout = 1 arm: output rows a block


def conv_tile_dims(tile: int) -> tuple[int, int, int]:
    """(BM, BN, threads) of the GEMM arm's tile ``tile``."""
    wm, wn, fm, fn = _CONV_TILES[tile]
    return 16 * fm * wm, 8 * fn * wn, 32 * wm * wn


def conv_chunks(taps: int, cin: int) -> list[tuple[int, int]]:
    """The GEMM arm's fixed cut of the reduction, in the order its partial
    sums are folded: the ``taps * cin`` terms in (tap, channel) order (term
    ``j * cin + c``, the row of the (taps * cin, cout) weight), 64 at a time,
    as ``(first term, end term)``. It depends on the layer alone; a plan only
    says how many consecutive chunks a block of a cluster takes."""
    terms = taps * cin
    return [(g0, min(terms, g0 + _CONV_KC)) for g0 in range(0, terms, _CONV_KC)]


def conv_cache_rows(taps: int, stride: int, dilation: int) -> int:
    """Q: a stream's first output rows that may read terms of the cache
    ((taps - 1) * dilation rows), ceil(that / stride)."""
    return -(-(taps - 1) * dilation // stride)


def conv_side_rows(bm: int, t_out: int, q: int) -> int:
    """Rows of a bf16-x GEMM tile of ``bm`` rows staged in f32 a step (the
    side rows, csrc/conv_gemm.cuh::conv_side_rows): ``min(q, t_out)`` rows
    of each stream the tile meets, at most ``bm``."""
    if q <= 0:
        return 0
    return min(bm, (-(-bm // t_out) + 1) * min(q, t_out))


def conv_smem_bytes(arm: str, tile: int, cin: int, cout: int, taps: int, stride: int,
                    dilation: int, steps_per_block: int, bf16: bool, x_bf16: bool = False,
                    t_out: int = 0) -> int:
    """Shared memory of one causal_conv block (csrc/causal_conv.cu::
    dse_causal_conv_smem): ``cin1`` W in f32; ``cout1`` the input window of
    ``tile`` output rows at an odd row stride and W; ``gemm`` the (A, W) ring
    of tile index ``tile``, a stage per step a block takes up to 3, and,
    where a cluster splits the steps, one f32 BM x BN slot per step. With
    bf16 x (``x_bf16``, at ``t_out`` output rows a stream) an A stage is the
    tile's rows in bf16 and its side rows (:func:`conv_side_rows`) in f32,
    and a bf16 W row is padded to BN + 16 (48 at BN = 16; conv_gemm.cuh::
    conv_ldw_bf16x)."""
    if arm == "cin1":
        return 4 * taps * cout
    if arm == "cout1":
        return 4 * (((tile - 1) * stride + (taps - 1) * dilation + 1) * (cin | 1) + taps * cin)
    bm, bn, _ = conv_tile_dims(tile)
    if x_bf16:
        if t_out < 1:
            raise ValueError(f"conv_smem_bytes: bf16 x needs its rows a stream, got {t_out}")
        side = conv_side_rows(bm, t_out, conv_cache_rows(taps, stride, dilation))
        a_stage = 2 * bm * _CONV_LDA_H + 4 * side * _CONV_LDA
        ldw = (48 if bn == 16 else bn + 16) if bf16 else bn + 8
    else:
        a_stage, ldw = 4 * bm * _CONV_LDA, bn + 8
    ring = min(_CONV_STAGES, steps_per_block) * (a_stage + _CONV_KC * ldw * (2 if bf16 else 4))
    split = steps_per_block < len(conv_chunks(taps, cin))
    return ring + (4 * steps_per_block * bm * bn if split else 0)


def _gemm_cost(rows: int, cin: int, cout: int, taps: int, tile: int, steps_per_block: int,
               smem: int, phases: int = 1, x_bf16: bool = False) -> tuple[float, int]:
    """The planner's model of one GEMM-arm launch: (us, blocks). The grid
    (``phases`` GEMMs of ``rows`` rows: a transposed conv's s phases) runs
    in waves of the blocks the SMs hold (threads, registers and shared
    memory bound it); a block takes a fixed time, then its steps, each the
    tile's step time scaled by the terms it holds (a part of a step is
    latency, whatever its terms) and by the blocks that share its SM, then
    with a cluster the fold over distributed shared memory. The bf16-x arm
    (``x_bf16``) has its own block and step times."""
    block_us, step_us = ((_CONV_BLOCK_US_BF16X, _CONV_STEP_US_BF16X) if x_bf16
                         else (_CONV_BLOCK_US, _CONV_STEP_US))
    bm, bn, threads = conv_tile_dims(tile)
    cluster = -(-len(conv_chunks(taps, cin)) // steps_per_block)
    k8 = -(-min(taps * cin, _CONV_KC) // 8)
    per_sm = max(1, min(2048 // threads, 65536 // (threads * _CONV_TILE_REGS[tile]),
                        (_MAX_SMEM + 1024) // (smem + 1024), 32))
    blocks = -(-rows // bm) * -(-cout // bn) * cluster * phases
    sharing = min(per_sm, -(-blocks // _N_SM))
    waves = -(-blocks // (_N_SM * per_sm))
    step = step_us[tile] * (0.25 + 0.75 * k8 / 8) * sharing
    fold = 0.0 if cluster == 1 else (_CONV_FOLD_US
                                     + _CONV_FOLD_US_PER_ELEM * bm * bn * cluster / threads)
    return waves * (block_us + steps_per_block * step + fold), blocks


def conv_gemm_plans(cin: int, cout: int, taps: int, stride: int, dilation: int,
                    bf16: bool, x_bf16: bool = False,
                    t_out: int = 0) -> list[tuple[int, int, int]]:
    """Every plan the GEMM arm can take for a (taps, cin, cout) layer, as
    ``(tile, steps per block, shared memory)``: each tile of its dtypes (all
    of ``_CONV_TILES`` for bf16 x and weights, else the first
    ``_CONV_TILES_F32X``) with each cluster split of the steps (1 to 8
    blocks), where the block's shared memory (with bf16 x at ``t_out``
    output rows a stream) fits."""
    steps = len(conv_chunks(taps, cin))
    splits = sorted({-(-steps // n) for n in range(1, _CONV_MAX_CLUSTER + 1)})
    plans = []
    for tile in range(len(_CONV_TILES) if x_bf16 and bf16 else _CONV_TILES_F32X):
        for q in splits:
            smem = conv_smem_bytes("gemm", tile, cin, cout, taps, stride, dilation, q, bf16,
                                   x_bf16, t_out)
            if smem <= _MAX_SMEM:
                plans.append((tile, q, smem))
    return plans


def _gemm_plan(rows: int, cin: int, cout: int, taps: int, bf16: bool, phases: int = 1,
               x_bf16: bool = False, t_out: int = 0, stride: int = 1,
               dilation: int = 1) -> tuple[int, int] | None:
    """(tile, steps per block) of the GEMM arm for ``phases`` GEMMs of
    ``rows`` rows over a (taps, cin, cout) layer (with bf16 x, ``t_out``
    rows a stream at ``stride`` and ``dilation``), or None where none fits:
    of :func:`conv_gemm_plans` on tiles no more than twice as wide as
    ``cout``, the plans within 10 % of the cheapest by :func:`_gemm_cost`,
    of those the ones whose grid covers 32 SMs if any, and the cheapest of
    them."""
    widest = max(16, 1 << (cout - 1).bit_length())  # no tile twice as wide as Cout
    plans = [(*_gemm_cost(rows, cin, cout, taps, tile, q, smem, phases, x_bf16), tile, q)
             for tile, q, smem in conv_gemm_plans(cin, cout, taps, stride, dilation, bf16,
                                                  x_bf16, t_out)
             if conv_tile_dims(tile)[1] <= widest]
    if not plans:
        return None
    near = [p for p in plans if p[0] <= 1.1 * min(p[0] for p in plans)]
    spread = [p for p in near if p[1] >= _CONV_MIN_BLOCKS] or near
    _, _, tile, q = min(spread)
    return tile, q


@functools.lru_cache(maxsize=1024)
def _conv_plan(batch: int, t_out: int, cin: int, cout: int, taps: int, stride: int,
               dilation: int, bf16: bool, x_bf16: bool = False) -> tuple[str, int, int]:
    """(arm, tile, steps per block) for ``batch`` streams of ``t_out`` output
    rows of a (taps, cin, cout) conv with bf16 weights (``bf16``) and x
    (``x_bf16``) or f32: ``cin1`` for one input channel, ``cout1`` for one
    output channel (``tile`` its output rows a block, the most whose window
    fits), else ``gemm`` at :func:`_gemm_plan`'s plan. Raises ValueError
    where no plan fits. Pure Python, so the CPU tests hold it."""
    if cin == 1:
        if conv_smem_bytes("cin1", 0, cin, cout, taps, stride, dilation, 1, bf16) <= _MAX_SMEM:
            return "cin1", 0, 1
    elif cout == 1:
        for rows in _DIRECT_ROWS:
            if rows <= max(t_out, 1) and conv_smem_bytes(
                    "cout1", rows, cin, cout, taps, stride, dilation, 1, bf16) <= _MAX_SMEM:
                return "cout1", rows, 1
    else:
        plan = _gemm_plan(batch * t_out, cin, cout, taps, bf16, 1, x_bf16, t_out, stride,
                          dilation)
        if plan:
            return ("gemm", *plan)
    raise ValueError(f"causal_conv: no plan fits {cin} -> {cout} channels at kernel {taps}, "
                     f"stride {stride}, dilation {dilation}")


@spanned("launch.causal_conv")
def causal_conv(cache: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor | None = None, stride: int = 1, dilation: int = 1,
                leaky: float | None = None, tanh: bool = False,
                out_dtype=None) -> torch.Tensor:
    """Causal conv over ``[cache; x]`` for B streams: cache (B, (k-1)*d,
    Cin) f32, x (B, T, Cin) f32 or bf16 with T a multiple of ``stride`` (or
    (ctx, Cin) / (T, Cin) for one stream), w (k, Cin, Cout) f32 or bf16, b
    (Cout,) f32 or None. ``leaky`` (a slope) applies LeakyReLU to the input
    as it is loaded, ``tanh`` tanh to the output. Returns (B, T / stride,
    Cout) in ``out_dtype`` (f32 or bf16; x's by default; 2-D for one
    stream). On the card the arm and plan come from :func:`_conv_plan`; the
    GEMM arm's products are tensor-core passes (split TF32 with f32 weights;
    one pass on the bf16-rounded input with bf16 weights) summed in an order
    fixed by the layer, so a stream's bits do not depend on B, T or the
    plan. The GEMM arm takes every pair of dtypes but bf16 x into an f32
    output (no path asks for it)."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if out_dtype not in ACT_DTYPES:
        raise ValueError(f"causal_conv: out_dtype must be float32 or bfloat16, got {out_dtype}")
    if x.device.type == "cpu":
        return causal_conv_plain(cache, x, w, b, stride, dilation, leaky, tanh, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"causal_conv: unsupported device {x.device}")
    if x.dim() not in (2, 3) or cache.dim() != x.dim():
        raise ValueError(f"causal_conv: x must be (B, T, Cin) or (T, Cin) with a cache of "
                         f"its rank, got {tuple(x.shape)} and {tuple(cache.shape)}")
    T, cin = x.shape[-2:]
    k, _, cout = w.shape
    if T % stride:
        raise ValueError(f"causal_conv: chunk length {T} must be a multiple of "
                         f"stride {stride}")
    if cache.shape != (*x.shape[:-2], (k - 1) * dilation, cin) or w.shape[1] != cin:
        raise ValueError(f"causal_conv: cache {tuple(cache.shape)} / weight "
                         f"{tuple(w.shape)} do not fit input {tuple(x.shape)}")
    if b is not None and b.shape != (cout,):
        raise ValueError(f"causal_conv: bias {tuple(b.shape)} does not fit Cout={cout}")
    _check_operands("causal_conv", x.device, {"x": x}, (w,), b, cache=cache,
                    act_dtypes=ACT_DTYPES)
    B = x.shape[0] if x.dim() == 3 else 1
    out = torch.empty((*x.shape[:-2], T // stride, cout), device=x.device, dtype=out_dtype)
    if B * T == 0:
        return out
    bf16 = w.dtype == torch.bfloat16
    x_bf16, y_bf16 = x.dtype == torch.bfloat16, out_dtype == torch.bfloat16
    arm, tile, steps = _conv_plan(B, T // stride, cin, cout, k, stride, dilation, bf16, x_bf16)
    if arm == "gemm" and x_bf16 and not y_bf16:
        raise ValueError("causal_conv: the GEMM arm does not take bf16 x into an f32 output")
    lib = _cuda.load("causal_conv")
    _cuda.launch(lib, "dse_causal_conv", "causal_conv", x, cache.data_ptr(),
                 cache.stride(0) if B > 1 else 0, x.data_ptr(), w.data_ptr(),
                 None if b is None else b.data_ptr(), out.data_ptr(), B, T // stride, cin, cout,
                 k, stride, dilation, int(leaky is not None), leaky or 0.0, int(tanh),
                 act_types(bf16, x_bf16, y_bf16), CONV_ARMS.index(arm), tile, steps)
    causal_conv.launches += 1
    return out


causal_conv.launches = 0


ROUNDINGS = (None, "product", "output")  # the C entry's rounding codes 0, 1, 2


def causal_conv_transpose_plain(cache, x, w, b=None, stride: int = 1,
                                leaky: float | None = None, rounding: str | None = None):
    """Plain PyTorch version of :func:`causal_conv_transpose`, in f32, on
    (time, C) or (B, time, C); returns x's dtype. With bf16 weights the
    input rows are rounded to bf16 after the activation, and with
    ``rounding`` the product before the bias (``"product"``) or the output
    after it (``"output"``)."""
    h = mma_operand(_loaded(cache, x, leaky), w.dtype)
    wd, w = w.dtype, w.float()
    cpad = stride - 1
    y = h.new_empty((*x.shape[:-2], x.shape[-2] * stride, w.shape[2]))
    for p in range(stride):
        y[..., p::stride, :] = (h[..., :-1, :] @ w[cpad - p]
                                + h[..., 1:, :] @ w[cpad + stride - p])
    if rounding == "product":
        y = mma_operand(y, wd)
    y = y if b is None else y + b
    if rounding == "output":
        y = mma_operand(y, wd)
    return y.to(x.dtype)


@functools.lru_cache(maxsize=1024)
def _upsample_plan(batch: int, t_in: int, cin: int, cout: int, stride: int,
                   bf16: bool, x_bf16: bool = False) -> tuple[int, int]:
    """(tile, steps per block) of causal_conv_transpose for ``batch`` streams
    of ``t_in`` input rows of a (2 * stride, cin, cout) layer: the GEMM
    arm's plan for ``stride`` phases of ``batch * t_in`` rows over the
    2 * cin terms of a tap pair (:func:`_gemm_plan`; a block's shared memory
    is the GEMM arm's at 2 taps, ``conv_smem_bytes("gemm", tile, cin, cout,
    2, 1, 1, steps, bf16, x_bf16, t_in)``, which equals
    csrc/causal_conv_transpose.cu::dse_causal_conv_transpose_smem). Raises
    ValueError where no plan fits. Pure Python, so the CPU tests hold it."""
    plan = _gemm_plan(batch * t_in, cin, cout, 2, bf16, stride, x_bf16, t_in)
    if plan is None:
        raise ValueError(f"causal_conv_transpose: no plan fits {cin} -> {cout} channels at "
                         f"stride {stride}")
    return plan


@spanned("launch.causal_conv_transpose")
def causal_conv_transpose(cache: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                          b: torch.Tensor | None = None, stride: int = 1,
                          leaky: float | None = None,
                          rounding: str | None = None) -> torch.Tensor:
    """Causal transposed conv (k = 2 * stride) over ``[cache; x]`` for B
    streams: cache (B, 1, Cin) f32, x (B, T, Cin) f32 or bf16 (or (1, Cin) /
    (T, Cin) for one stream), w (2s, Cin, Cout) conv-ready tap-flipped, f32 or
    bf16, b (Cout,) f32 or None; ``leaky`` (a slope) applies LeakyReLU to the
    input as it is loaded. ``rounding`` (bf16 weights; with f32 weights it
    changes nothing) is a vocoder upsample's extra rounding to bf16, as the JAX
    vocoders round: ``"product"`` each phase's product before the bias (K4,
    ops/vocoder_kernel.py:324, ``yp.astype(wd)``), ``"output"`` the output
    after it (K5, ops/vocoder_stacked.py:253). Returns (B, T * stride, Cout) in
    x's dtype (2-D for one stream). On the card the plan comes from
    :func:`_upsample_plan`; each phase's products are tensor-core passes (split
    TF32 with f32 weights, one pass on the bf16-rounded input with bf16
    weights) summed in an order fixed by the layer, so a stream's bits do not
    depend on B, T or the plan."""
    if rounding not in ROUNDINGS:
        raise ValueError(f"causal_conv_transpose: rounding must be one of {ROUNDINGS}")
    if x.device.type == "cpu":
        return causal_conv_transpose_plain(cache, x, w, b, stride, leaky, rounding)
    if x.device.type != "cuda":
        raise ValueError(f"causal_conv_transpose: unsupported device {x.device}")
    if x.dim() == 2 and cache.dim() == 2:
        return causal_conv_transpose(cache[None], x[None], w, b, stride, leaky, rounding)[0]
    if x.dim() != 3:
        raise ValueError(f"causal_conv_transpose: x must be (B, T, Cin), got "
                         f"{tuple(x.shape)}")
    B, T, cin = x.shape
    k, _, cout = w.shape
    if k != 2 * stride or cache.shape != (B, 1, cin) or w.shape[1] != cin:
        raise ValueError(f"causal_conv_transpose: cache {tuple(cache.shape)} / weight "
                         f"{tuple(w.shape)} do not fit input {tuple(x.shape)} at "
                         f"stride {stride} (kernel must be 2 * stride)")
    if b is not None and b.shape != (cout,):
        raise ValueError(f"causal_conv_transpose: bias {tuple(b.shape)} does not fit "
                         f"Cout={cout}")
    _check_operands("causal_conv_transpose", x.device, {"x": x}, (w,), b, cache=cache,
                    act_dtypes=ACT_DTYPES)
    out = torch.empty((B, T * stride, cout), device=x.device, dtype=x.dtype)
    if B * T == 0:
        return out
    bf16 = w.dtype == torch.bfloat16
    tile, steps = _upsample_plan(B, T, cin, cout, stride, bf16, x.dtype == torch.bfloat16)
    lib = _cuda.load("causal_conv_transpose")
    _cuda.launch(lib, "dse_causal_conv_transpose", "causal_conv_transpose", x,
                 cache.data_ptr(), cache.stride(0) if B > 1 else 0, x.data_ptr(), w.data_ptr(),
                 None if b is None else b.data_ptr(), out.data_ptr(), B, T, cin, cout, stride,
                 int(leaky is not None), leaky or 0.0,
                 act_types(bf16, x.dtype == torch.bfloat16) | (ROUNDINGS.index(rounding) << 2
                                                               if bf16 else 0), tile, steps)
    causal_conv_transpose.launches += 1
    return out


causal_conv_transpose.launches = 0


RVQ_MAX_DIM = 1024  # csrc/rvq_assign.cu kMaxDim
RVQ_CLUSTERS = (16, 8, 4, 2, 1)  # blocks splitting K, the planner's order of preference
_RVQ_MAX_THREADS = 512  # kMaxThreads, at 8 rows a thread
_RVQ_MAX_GROUPS = 32  # kMaxGroups: groups of 4 codewords a block
_RVQ_MIN_TILE = 8  # rows a cluster takes at least, where there are as many


class RvqPlan(NamedTuple):
    """A launch of csrc/rvq_assign.cu: ``cluster`` blocks split K, each
    cluster carries ``tile`` rows at a time through the L stages, ``clusters``
    persistent clusters walk the row tiles, and ``stages`` book slots sit in
    each block's shared memory (L: every book resident; fewer: a ring)."""

    cluster: int
    tile: int
    clusters: int
    stages: int


def rvq_groups(book_k: int, cluster: int) -> int:
    """Groups of 4 codewords each block owns: the least power of two that
    covers ceil(K / cluster) (csrc/rvq_assign.cu::rvq_groups)."""
    per, groups = -(-book_k // cluster), 1
    while 4 * groups < per:
        groups *= 2
    return groups


def rvq_smem_bytes(tile: int, dim: int, book_k: int, cluster: int, stages: int) -> int:
    """Shared memory of one block (csrc/rvq_assign.cu::dse_rvq_assign_smem):
    the mbarriers (``stages`` + 2), ``stages`` slots of S * (D + 1) floats (a
    book's slice and its norms), the residual tile at row stride round4(D) +
    4, two words a row (|r|^2, the pick) and two buffers of the cluster's
    candidates (distance, index: 2 * cluster words a row each)."""
    slice_k = 4 * rvq_groups(book_k, cluster)
    round4 = lambda n: -(-n // 4) * 4  # noqa: E731
    return (-(-8 * (stages + 2) // 16) * 16
            + 4 * (stages * slice_k * (dim + 1) + tile * (round4(dim) + 4)
                   + (4 * cluster + 2) * round4(tile)))


def _rvq_tile_fit(dim: int, book_k: int, cluster: int, stages: int, cap: int) -> int:
    """The most rows (at most ``cap``) a tile may have beside ``stages`` book
    slots, or 0."""
    tile = cap
    while tile and rvq_smem_bytes(tile, dim, book_k, cluster, stages) > _MAX_SMEM:
        tile -= 1
    return tile


def rvq_block_threads(tile: int, book_k: int, cluster: int) -> tuple[int, int, int]:
    """(threads, codewords a thread, rows a thread) of a block at ``tile``
    rows (csrc/rvq_assign.cu::dse_rvq_assign_threads): 2 codewords a thread
    at one row where a row's 2 * S / 4 lanes fit a warp and carry the tile in
    512 threads, else 4 codewords at the fewest of 1, 2, 4, 8 rows that keep
    the block within 256 threads (8 rows up to 512)."""
    groups = rvq_groups(book_k, cluster)
    cw = 2 if 2 * groups <= 32 and 2 * groups * tile <= _RVQ_MAX_THREADS else 4
    rt = 1
    while cw == 4 and rt < 8 and groups * -(-tile // rt) > 256:
        rt *= 2
    return -(-(4 * groups // cw) * -(-tile // rt) // 32) * 32, cw, rt


def rvq_single_pass(tile: int, dim: int, book_k: int, cluster: int) -> bool:
    """Whether a stage's merge, update and |r|^2 take csrc/rvq_assign.cu's
    single pass: rows of D / 4 16-byte chunks (a power of two up to 32) and
    max(D / 4, cluster) lanes a row of the tile within the block's threads."""
    chunks = dim // 4 if dim % 4 == 0 and dim <= 128 else 0
    return (chunks > 0 and chunks & (chunks - 1) == 0
            and tile * max(chunks, cluster) <= rvq_block_threads(tile, book_k, cluster)[0])


_RVQ_RING = 3  # book slots of the plans for many rows: two blocks fit an SM at few rows a tile
_SM_SMEM = 233472  # bytes of shared memory an SM holds for its blocks, 1 KB each reserved


@functools.lru_cache(maxsize=1024)
def _rvq_plan(rows: int, dim: int, book_k: int, n_books: int) -> RvqPlan:
    """The launch of :func:`rvq_assign` for ``rows`` rows of a (n_books,
    dim, book_k) codebook, in three regimes measured on the card
    (tools/rvq_timing.py --sweep):

    - few rows: the largest cluster whose blocks each own some codewords (at
      most 128), every book resident, as many clusters as the card runs at
      once with at least 8 rows each, where the tile takes the single pass
      (rvq_single_pass);
    - more: half that cluster with a ring of 3 book slots, so that two blocks
      share an SM and twice the clusters run at once, again at least 8 rows a
      cluster and the single pass;
    - many: half the cluster, 3 slots, the clusters that run at once at one
      block an SM, in as few passes over tiles as 512 threads and shared
      memory allow.

    Where none fits, the largest cluster with as many book slots as fit.
    Raises ValueError where no plan fits. Pure Python, so the CPU tests hold
    it."""
    if rows < 1 or not 0 < dim <= RVQ_MAX_DIM or book_k < 1 or n_books < 1:
        raise ValueError(f"rvq_assign: no plan for {rows} rows of a ({n_books}, {dim}, "
                         f"{book_k}) codebook")
    sizes = [c for c in RVQ_CLUSTERS if rvq_groups(book_k, c) <= _RVQ_MAX_GROUPS
             and (c - 1) * 4 * rvq_groups(book_k, c) < book_k]
    if not sizes:
        raise ValueError(f"rvq_assign: no plan fits a ({n_books}, {dim}, {book_k}) codebook "
                         "(at most 128 codewords a block of 16)")
    big, small = sizes[0], sizes[min(1, len(sizes) - 1)]
    ring = min(_RVQ_RING, n_books)

    def fits(tile, cluster, stages, per_sm=1):
        smem = rvq_smem_bytes(tile, dim, book_k, cluster, stages)
        return smem <= _MAX_SMEM and per_sm * (smem + 1024) <= _SM_SMEM

    for cluster, stages, per_sm in ((big, n_books, 1), (small, ring, 2)):
        clusters = min(_rvq_max_clusters(cluster, per_sm), -(-rows // _RVQ_MIN_TILE))
        tile = -(-rows // clusters)
        if rvq_single_pass(tile, dim, book_k, cluster) and fits(tile, cluster, stages, per_sm):
            return RvqPlan(cluster, tile, -(-rows // tile), stages)
    for cluster, stages in ((small, ring), (big, n_books)):
        cap = _rvq_tile_fit(dim, book_k, cluster, stages,
                            8 * (_RVQ_MAX_THREADS // rvq_groups(book_k, cluster)))
        if not cap:
            continue
        most = _rvq_max_clusters(cluster)
        passes = -(-rows // (most * cap))
        tile = -(-rows // (most * passes))
        return RvqPlan(cluster, tile, min(most, -(-rows // tile)), stages)
    for stages in range(n_books - 1, 1, -1):
        tile = _rvq_tile_fit(dim, book_k, big, stages, 8 * (_RVQ_MAX_THREADS // rvq_groups(
            book_k, big)))
        if tile:
            most = _rvq_max_clusters(big)
            tile = min(tile, -(-rows // most))
            return RvqPlan(big, tile, min(most, -(-rows // tile)), stages)
    raise ValueError(f"rvq_assign: no plan fits a ({n_books}, {dim}, {book_k}) codebook "
                     "(at most 128 codewords a block of 16, and two book slots in shared "
                     "memory)")


def rvq_assign_plain(z, books, sqnorm):
    """Plain PyTorch version of :func:`rvq_assign`: the JAX package's
    ``(|r|^2 - 2 r.E) + |E|^2`` in f32 (on z widened where it is bf16),
    ``argmin`` at the lowest index."""
    n_books, _, book_k = books.shape
    r, codes = z.float(), []
    for l in range(n_books):
        dist = (r * r).sum(1, keepdim=True) - 2.0 * (r @ books[l]) + sqnorm[l]
        ind = torch.argmin(dist, dim=1)
        r = r - books[l].t()[ind]
        codes.append(ind + l * book_k)
    return torch.stack(codes, 1).to(torch.int32)


@spanned("launch.rvq_assign")
def rvq_assign(z: torch.Tensor, books: torch.Tensor, sqnorm: torch.Tensor,
               books_t: torch.Tensor) -> torch.Tensor:
    """Residual-VQ nearest-codeword search: z (R, D) f32 or bf16 (widened to
    f32 as it is loaded), books (L, D, K) f32,
    sqnorm (L, K) f32 (``(books ** 2).sum(1)``). Returns the flattened wire
    codes (R, L) int32, ``ind + l * K``. Rows are independent: B streams of
    N frames are B * N * chunk / hop rows of one launch, at the plan of
    :func:`_rvq_plan`; a row's codes do not depend on the plan, B or N.
    ``books_t`` is the same books as (L, K, D), where the kernel reads each
    stage's winning codeword: pass the one :func:`vq_tables` returns beside
    ``books`` (it is not checked against them)."""
    if z.device.type == "cpu":
        return rvq_assign_plain(z, books, sqnorm)
    if z.device.type != "cuda":
        raise ValueError(f"rvq_assign: unsupported device {z.device}")
    R, D = z.shape
    L, _, K = books.shape
    if books.shape[1] != D or sqnorm.shape != (L, K):
        raise ValueError(f"rvq_assign: books {tuple(books.shape)} / sqnorm "
                         f"{tuple(sqnorm.shape)} do not fit z {tuple(z.shape)}")
    if D > RVQ_MAX_DIM:
        raise ValueError(f"rvq_assign: code dim {D} above {RVQ_MAX_DIM} (the residuals "
                         "live in shared memory)")
    if books_t.shape != (L, K, D):
        raise ValueError(f"rvq_assign: books_t {tuple(books_t.shape)} is not books "
                         f"{tuple(books.shape)} as (L, K, D)")
    _check_operands("rvq_assign", z.device, {"z": z}, (books,), act_dtypes=ACT_DTYPES)
    _check_operands("rvq_assign", z.device, {"books": books, "sqnorm": sqnorm,
                                             "books_t": books_t}, (books,))
    codes = torch.empty((R, L), dtype=torch.int32, device=z.device)
    if R == 0:
        return codes
    plan = _rvq_plan(R, D, K, L)
    lib = _cuda.load("rvq_assign")
    _cuda.launch(lib, "dse_rvq_assign", "rvq_assign", z, z.data_ptr(), books.data_ptr(),
                 sqnorm.data_ptr(), books_t.data_ptr(), codes.data_ptr(), R, D, K, L,
                 plan.cluster, plan.tile, plan.clusters, plan.stages,
                 act_types(False, z.dtype == torch.bfloat16))
    rvq_assign.launches += 1
    return codes


rvq_assign.launches = 0


def _bad_codes(what):
    return ValueError(f"{what}: a code lies outside its book's range [l*K, (l+1)*K)")


def codebook_lookup_plain(codes, books_t, out_dtype=torch.float32):
    """Plain PyTorch version of :func:`codebook_lookup`, summing over the
    books in ascending order in f32, returned in ``out_dtype``."""
    n_books, book_k, _ = books_t.shape
    ind = codes.long() - torch.arange(n_books, device=codes.device) * book_k
    if bool(((ind < 0) | (ind >= book_k)).any()):
        raise _bad_codes("codebook_lookup")
    zq = books_t[0][ind[:, 0]]
    for l in range(1, n_books):
        zq = zq + books_t[l][ind[:, l]]
    return zq.to(out_dtype)


class BadCodeWord:
    """Where :func:`codebook_lookup`'s kernel records a code outside its
    book: 8 bytes of pinned host memory mapped into the card's address space
    (csrc/codebook_lookup.cu::dse_mapped_word_alloc, made at the first call
    on the card). Each call on the card is given the next number, and a call
    that meets such a code stores its number there; nothing clears it. The
    host reads the word without a synchronisation: :meth:`check` raises
    ValueError once for each new number it finds, so a bad code is reported
    by the first check after its call has finished on the card.

    One mechanism for every caller: a stream half's decoder owns one word
    (:func:`mega_decoder`, ops/vocoder_kernel.py::vocoder_half), a direct
    call uses its device's (:func:`check_codes`)."""

    def __init__(self):
        self._word = None  # ctypes view of the host word
        self.device_ptr = None
        self.calls = self.seen = 0
        self._lock = threading.Lock()  # a streamer's threads may share an endpoint

    def next_call(self) -> int:
        """The number of the next call on the card, allocating the word."""
        with self._lock:
            if self._word is None:
                lib = _cuda.load("codebook_lookup")
                host, dev = ctypes.c_void_p(), ctypes.c_void_p()
                _cuda.check(lib, lib.dse_mapped_word_alloc(ctypes.byref(host),
                                                           ctypes.byref(dev)),
                            "codebook_lookup: the bad-code word")
                weakref.finalize(self, lib.dse_mapped_word_free, host.value)
                self._word = ctypes.c_longlong.from_address(host.value)
                self.device_ptr = dev.value
            self.calls += 1
            return self.calls

    def check(self) -> None:
        """Raise ValueError if a call has recorded a bad code since the last
        check that raised. It sees the calls that have finished on the card:
        after a synchronising read (``.cpu()`` of an output,
        ``torch.cuda.synchronize()``), every earlier call."""
        if self._word is not None and self._word.value != self.seen:
            self.seen = self._word.value
            raise _bad_codes("codebook_lookup")


_DEVICE_WORDS: dict[int, BadCodeWord] = {}  # card index -> the word of direct calls


def _device_word(device) -> BadCodeWord:
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    return _DEVICE_WORDS.setdefault(index, BadCodeWord())


def check_codes(device="cuda") -> None:
    """Raise ValueError if a direct :func:`codebook_lookup` call on
    ``device`` (one given no ``word``) met a code outside its book since the
    last check that raised. Call it after ``torch.cuda.synchronize()`` to
    cover every call made before."""
    _device_word(device).check()


@spanned("launch.codebook_lookup")
def codebook_lookup(codes: torch.Tensor, books_t: torch.Tensor,
                    word: BadCodeWord | None = None, out_dtype=torch.float32) -> torch.Tensor:
    """Codebook lookup of flattened wire codes: codes (R, L) int32, books_t
    (L, K, D) f32. Returns zq (R, D) in ``out_dtype`` (f32 or bf16: the f32
    sum rounded once), ``sum_l books_t[l, codes[:, l] - l * K]``. A code
    outside its book's range raises ValueError. On the CPU it raises at
    once. On the card the kernel reads no such code (its term
    is zero, as the TPU kernel's one-hot product makes it) and records it in
    ``word`` (the caller's :class:`BadCodeWord`; by default the device's),
    and the call returns without waiting for the card: the bad code raises
    at the first check of the word after its call has finished there, that
    is at the word's next call (which checks first) or at an explicit
    ``word.check()`` / :func:`check_codes` after a synchronising read."""
    if out_dtype not in ACT_DTYPES:
        raise ValueError(f"codebook_lookup: out_dtype must be float32 or bfloat16, got "
                         f"{out_dtype}")
    if codes.device.type == "cpu":
        return codebook_lookup_plain(codes, books_t, out_dtype)
    if codes.device.type != "cuda":
        raise ValueError(f"codebook_lookup: unsupported device {codes.device}")
    R, L = codes.shape
    _, K, D = books_t.shape
    if books_t.shape[0] != L:
        raise ValueError(f"codebook_lookup: books {tuple(books_t.shape)} do not fit codes "
                         f"{tuple(codes.shape)}")
    if (codes.dtype != torch.int32 or not codes.is_contiguous()
            or codes.device != books_t.device):
        raise ValueError(f"codebook_lookup: codes must be a contiguous int32 tensor on "
                         f"{books_t.device}")
    _check_operands("codebook_lookup", codes.device, {"books_t": books_t}, (books_t,))
    out = torch.empty((R, D), device=codes.device, dtype=out_dtype)
    if R == 0:
        return out
    word = _device_word(codes.device) if word is None else word
    word.check()
    call = word.next_call()
    lib = _cuda.load("codebook_lookup")
    _cuda.launch(lib, "dse_codebook_lookup", "codebook_lookup", codes, codes.data_ptr(),
                 books_t.data_ptr(), out.data_ptr(), word.device_ptr, call, R, L, K, D,
                 act_types(False, out_dtype == torch.bfloat16))
    codebook_lookup.launches += 1
    return out


codebook_lookup.launches = 0

# ---------------------------------------------------------------- weights


def conv_weight(layer, weight_dtype=torch.float32) -> torch.Tensor:
    """A CausalConv1d's weight as (k, in, out)."""
    return layer.weight.detach().permute(2, 1, 0).to(weight_dtype).contiguous()


def conv_transpose_weight(layer, weight_dtype=torch.float32) -> torch.Tensor:
    """A CausalConvTranspose1d's weight, conv-ready and tap-flipped, as
    (k, in, out): ``Wc[j] = weight[:, :, k - 1 - j]``."""
    return layer.weight.detach().flip(2).permute(2, 0, 1).to(weight_dtype).contiguous()


def _bias(layer):
    return None if layer.bias is None else layer.bias.detach().float().contiguous()


def vq_tables(vq_state, device):
    """The kernels' f32 codebook tables from a ``VQState``: books (L, D, K)
    for :func:`rvq_assign`, their squared norms (L, K), and books_t (L, K, D)
    for :func:`codebook_lookup` and :func:`rvq_assign`'s winning codewords."""
    books = vq_state.embed.detach().to(device, torch.float32).contiguous()
    return books, (books * books).sum(1).contiguous(), books.transpose(1, 2).contiguous()


# ---------------------------------------------------------------- stream


def mega_topology_error(gen, chunk: int) -> str | None:
    """Why the whole-model stream cannot run ``gen`` at ``chunk``, or None.

    make_scan_stream asks this before it builds anything, in place of the
    JAX package's ``except AssertionError`` fallback."""
    reason = chain_topology_error(gen)
    if reason:
        return reason
    if gen.use_pqc:
        for name, layer in (("projector", gen.projector.conv),
                            ("decoder input conv", gen.decoder.conv1)):
            if layer.stride != 1 or layer.dilation != 1:
                return f"mega stream needs an unstrided, undilated {name}"
    if gen.input_channels != 1:
        return f"mega stream takes mono input, got {gen.input_channels} channels"
    if chunk <= 0 or chunk % gen.hop:
        return f"chunk {chunk} must be a positive multiple of the hop {gen.hop}"
    for blk in list(gen.encoder.blocks) + list(gen.decoder.blocks):
        if blk.conv.kernel_size != 2 * blk.conv.stride:
            return (f"mega stream needs kernel_size == 2 * stride at the block convs, "
                    f"got {blk.conv.kernel_size} at stride {blk.conv.stride}")
        if getattr(blk.conv, "dilation", 1) != 1:
            return "mega stream needs undilated block convs"
    return None


class StreamHalf(NamedTuple):
    """The encoder or the decoder half of the whole-model stream (or the
    vocoder receiver, ops/vocoder_kernel.py::vocoder_half)."""

    shapes: dict  # cache name -> per-stream (rows, channels)
    run: Callable  # (cache, activations) -> (activations, new cache entries)
    hop: int  # samples per wire row
    codes: bool  # the wire is int32 codes (PQC), not encoder features
    fills: dict | None = None  # cache name -> (channels,) row a fresh cache holds; else zeros
    boundary: torch.dtype = torch.float32  # activations between its launches
    name: str = "half"  # its span in a profiler trace: dse.half.<name>


def init_half_cache(halves, batch: int, device) -> dict:
    """A fresh cache of ``halves``: ``{name: (batch, rows, channels)}`` on
    ``device``, zeros but where a half names the row it starts from."""
    cache = {}
    for half in halves:
        for name, shape in half.shapes.items():
            cache[name] = torch.zeros((batch, *shape), device=device)
            if half.fills and name in half.fills:
                cache[name][:] = half.fills[name].to(device)
    return cache


def _check_half_dtype(weight_dtype):
    if weight_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"weight_dtype must be float32 or bfloat16, got {weight_dtype}")


def _check_half(gen, weight_dtype, vq_state, boundary_dtype):
    gen.check_vq_state(vq_state)
    _check_half_dtype(weight_dtype)
    check_boundary_dtype(boundary_dtype)
    reason = mega_topology_error(gen, gen.hop)
    if reason:
        raise ValueError(reason)


def mega_encoder(gen, weight_dtype=torch.bfloat16, vq_state=None,
                 boundary_dtype=torch.float32) -> StreamHalf:
    """The encoder half of ``gen``'s whole-model stream: input conv -> 4 x
    (residual_chain, downsample), with PQC then the projector and
    rvq_assign; 9 launches, 11 with PQC.

    ``run(cache, x (B, T, 1) f32) -> (wire, new cache entries)``: ``wire`` is
    the int32 wire codes (B, T / hop, L) with PQC (pass ``vq_state``), the
    encoder features (B, T / hop, C) in ``boundary_dtype`` without. Weights
    are copied now in ``weight_dtype``, the codebooks in f32; activations
    cross launches in ``boundary_dtype`` (float32 or bfloat16)."""
    _check_half(gen, weight_dtype, vq_state, boundary_dtype)
    enc, wd, halo = gen.encoder, weight_dtype, chain_halo()
    w_in = conv_weight(enc.conv, wd)
    levels = [(chain_weights(blk.res_units, wd), conv_weight(blk.conv, wd), _bias(blk.conv),
               blk.conv.stride) for blk in enc.blocks]
    shapes = {"enc_in": (enc.conv.pad_length, 1)}
    for bi, blk in enumerate(enc.blocks):
        shapes[f"e{bi}ch"] = (halo, blk.conv.in_channels)
        shapes[f"e{bi}d"] = (blk.conv.pad_length, blk.conv.in_channels)
    if gen.use_pqc:
        w_pr = conv_weight(gen.projector.conv, wd)
        books, sqnorm, books_t = vq_tables(vq_state, gen.device)
        shapes["prj"] = (gen.projector.conv.pad_length, gen.projector.conv.in_channels)

    def run(cache, x):
        # x may be a view of the caller's frames: keep the cache off it
        new = {"enc_in": tail(cache["enc_in"], x, shapes["enc_in"][0]).clone()}
        h = causal_conv(cache["enc_in"], x, w_in, out_dtype=boundary_dtype)
        for bi, ((w1, w2), w_dn, b_dn, s) in enumerate(levels):
            new[f"e{bi}ch"] = tail(cache[f"e{bi}ch"], h, halo)
            h = residual_chain(cache[f"e{bi}ch"], h, w1, w2)
            new[f"e{bi}d"] = tail(cache[f"e{bi}d"], h, 2 * s - 1)
            h = causal_conv(cache[f"e{bi}d"], h, w_dn, b_dn, stride=s)
        if not gen.use_pqc:
            return h, new
        new["prj"] = tail(cache["prj"], h, shapes["prj"][0])
        z = causal_conv(cache["prj"], h, w_pr)
        b, rows, dim = z.shape
        codes = rvq_assign(z.reshape(b * rows, dim), books, sqnorm, books_t)
        return codes.reshape(b, rows, -1), new

    return StreamHalf(shapes, run, gen.hop, gen.use_pqc, boundary=boundary_dtype,
                      name="encoder")


def mega_decoder(gen, weight_dtype=torch.bfloat16, vq_state=None,
                 boundary_dtype=torch.float32) -> StreamHalf:
    """The decoder half of ``gen``'s whole-model stream: with PQC first
    codebook_lookup and the decoder input conv, then 4 x (upsample,
    residual_chain) -> output conv; 9 launches, 11 with PQC.

    ``run(cache, wire) -> (audio (B, T, 1) f32, new cache entries)`` takes
    what an encoder half sends: int32 wire codes (B, rows, L) with PQC
    (looked up in ``vq_state``'s books; a code outside its book raises
    ValueError, on the card at the half's next ``run`` after its dispatch has
    finished: the half owns a :class:`BadCodeWord`), features (B, rows, C)
    without (f32 features are converted to ``boundary_dtype`` as they come
    in: an encoder half of that dtype sends them so already). Activations
    cross launches in ``boundary_dtype``."""
    _check_half(gen, weight_dtype, vq_state, boundary_dtype)
    dec, wd, halo = gen.decoder, weight_dtype, chain_halo()
    levels = [(conv_transpose_weight(blk.conv, wd), _bias(blk.conv), blk.conv.stride,
               chain_weights(blk.res_units, wd)) for blk in dec.blocks]
    w_out = conv_weight(dec.conv2, wd)
    shapes = {}
    if gen.use_pqc:
        w_dc1 = conv_weight(dec.conv1, wd)
        _, _, books_t = vq_tables(vq_state, gen.device)
        word = BadCodeWord()
        shapes["dc1"] = (dec.conv1.pad_length, dec.conv1.in_channels)
    for bi, blk in enumerate(dec.blocks):
        shapes[f"d{bi}u"] = (1, blk.conv.in_channels)
        shapes[f"d{bi}ch"] = (halo, blk.conv.out_channels)
    shapes["dec_out"] = (dec.conv2.pad_length, dec.conv2.in_channels)

    def run(cache, wire):
        new, h = {}, wire
        if gen.use_pqc:
            b, rows, n_books = wire.shape
            zq = codebook_lookup(wire.reshape(b * rows, n_books), books_t, word,
                                 boundary_dtype).reshape(b, rows, -1)
            new["dc1"] = tail(cache["dc1"], zq, shapes["dc1"][0])
            h = causal_conv(cache["dc1"], zq, w_dc1)
        elif wire.dtype != boundary_dtype:
            h = wire.to(boundary_dtype)
        for bi, (w_up, b_up, s, (w1, w2)) in enumerate(levels):
            new[f"d{bi}u"] = tail(cache[f"d{bi}u"], h, 1)
            h = causal_conv_transpose(cache[f"d{bi}u"], h, w_up, b_up, stride=s)
            new[f"d{bi}ch"] = tail(cache[f"d{bi}ch"], h, halo)
            h = residual_chain(cache[f"d{bi}ch"], h, w1, w2)
        new["dec_out"] = tail(cache["dec_out"], h, shapes["dec_out"][0])
        return causal_conv(cache["dec_out"], h, w_out, out_dtype=torch.float32), new

    return StreamHalf(shapes, run, gen.hop, gen.use_pqc, boundary=boundary_dtype,
                      name="decoder")


def join_halves(encoder: StreamHalf, decoder: StreamHalf, batch: int, device,
                chunk: int | None = None):
    """``(init_cache, run)`` streaming ``batch`` streams through an encoder
    half and then a decoder half, which may come from different generators
    (or the vocoder receiver, ops/vocoder_kernel.py::vocoder_half).

    ``init_cache() -> {name: (batch, rows, channels)}`` on ``device``
    (:func:`init_half_cache`);
    ``run(cache, frames (N, batch, F)) -> (out (N, batch, F'), new_cache)``,
    and with PQC also ``codes (N, batch, F / hop, L)`` int32. ``F`` must be
    ``chunk``, or any positive multiple of the hop when ``chunk`` is None.
    The halves must share their boundary dtype (the activations between
    launches, the features on the wire without PQC). In a profiler trace a
    ``run`` is the span ``dse.dispatch``, each half's call inside it
    ``dse.half.<name>`` (utils/trace.py)."""
    if encoder.codes != decoder.codes:
        raise ValueError("one half sends int32 wire codes (PQC) and the other takes "
                         "encoder features")
    if encoder.boundary != decoder.boundary:
        raise ValueError(f"the halves' boundary dtypes differ: {encoder.boundary} and "
                         f"{decoder.boundary}")
    if batch < 1:
        raise ValueError(f"batch must be at least 1, got {batch}")
    if set(encoder.shapes) & set(decoder.shapes):
        raise ValueError(f"the halves' cache names collide: "
                         f"{sorted(set(encoder.shapes) & set(decoder.shapes))}")

    enc_span, dec_span = f"half.{encoder.name}", f"half.{decoder.name}"

    def init_cache():
        return init_half_cache((encoder, decoder), batch, device)

    @spanned("dispatch")
    def run(cache, frames):
        if frames.dim() != 3 or frames.shape[1] != batch:
            raise ValueError(f"frames must be (N, {batch}, F), got {tuple(frames.shape)}")
        n, b, t = frames.shape
        if chunk is not None and t != chunk:
            raise ValueError(f"frames of {t} samples given to a stream built for {chunk}")
        if t <= 0 or t % encoder.hop:
            raise ValueError(f"frames of {t} samples: not a positive multiple of the hop "
                             f"{encoder.hop}")
        x = frames.transpose(0, 1).reshape(b, n * t, 1).contiguous()
        with span(enc_span):
            wire, new = encoder.run(cache, x)
        with span(dec_span):
            y, dec_new = decoder.run(cache, wire)
        new.update(dec_new)
        out = y.reshape(b, n, -1).transpose(0, 1).contiguous()
        if not encoder.codes:
            return out, new
        return out, new, wire.reshape(b, n, -1, wire.shape[-1]).transpose(0, 1).contiguous()

    return init_cache, run


def make_mega_stream_batched(gen, chunk: int, batch: int, weight_dtype=torch.bfloat16,
                             vq_state=None, boundary_dtype=torch.float32):
    """Whole-model streaming of ``batch`` independent streams of the
    ``AudioDecGenerator`` family, 18 launches per dispatch (22 with PQC)
    whatever ``batch`` is.

    Returns ``(init_cache, run)`` with ``init_cache() -> {name: (B, ctx,
    C)}`` and

    - without PQC: ``run(cache, frames (N, B, chunk)) -> (out (N, B, chunk),
      new_cache)``; per stream and frame it matches ``gen.encode_step`` +
      ``gen.decode_step`` from zero caches;
    - with PQC (pass ``vq_state``): ``run(cache, frames) -> (out, new_cache,
      codes (N, B, chunk / hop, L) int32)``, the flattened wire codes
      computed in the same dispatch; per stream and frame it matches
      ``encode_step -> quantize -> lookup -> decode_step``. The codes equal
      the eager route's at ``weight_dtype=float32``; at bf16 the encoder and
      projector weights perturb ``z`` and a near-tie codeword can resolve
      differently.

    The returned cache continues the streams in the next dispatch. The
    weights are the generator's own, copied once now in ``weight_dtype``
    (float32 or bfloat16); the codebooks are copied in f32. Dense activations
    cross launches in ``boundary_dtype`` (float32 or bfloat16: bf16 halves
    that traffic, the kernels converting as they load and store; the codes,
    the audio and the caches stay as they are). Runs on the generator's
    device: kernels on CUDA, their plain versions on the CPU."""
    gen.check_vq_state(vq_state)
    check_boundary_dtype(boundary_dtype)
    reason = mega_topology_error(gen, chunk)
    if reason:
        raise ValueError(reason)
    return join_halves(mega_encoder(gen, weight_dtype, vq_state, boundary_dtype),
                       mega_decoder(gen, weight_dtype, vq_state, boundary_dtype), batch,
                       gen.device, chunk)


def make_mega_stream(gen, chunk: int, weight_dtype=torch.bfloat16, vq_state=None):
    """One stream of :func:`make_mega_stream_batched` (its B = 1 case) in the
    single-stream layout of the JAX package's ``make_mega_stream``:
    ``init_cache() -> {name: (ctx, C)}``, ``run(cache, frames (N, chunk)) ->
    (out (N, chunk), new_cache)``, and with PQC also ``codes (N, chunk / hop,
    L)`` int32."""
    init_b, run_b = make_mega_stream_batched(gen, chunk, 1, weight_dtype, vq_state)

    def init_cache():
        return {name: t[0] for name, t in init_b().items()}

    def run(cache, frames):
        if frames.dim() != 2:
            raise ValueError(f"frames must be (N, chunk), got {tuple(frames.shape)}")
        out, new, *codes = run_b({name: t[None] for name, t in cache.items()},
                                 frames[:, None])
        return (out[:, 0], {name: t[0] for name, t in new.items()},
                *(c[:, 0] for c in codes))

    return init_cache, run
