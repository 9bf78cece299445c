"""Streaming of the HiFiGAN vocoder receiver on hand-written kernels.

Counterpart of dl_speech_enhancement_tpu/ops/vocoder_kernel.py::
make_mega_vocoder (K4, both arms) and, through the batch
axis, of ops/vocoder_stacked.py::make_stacked_vocoder (K5). On the TPU, K4
packs the ~19.5 M parameters of the AudioDec v1 receiver into VMEM-budgeted
segments, fuses a stage's groups into block-diagonal 128-lane matmuls
because Mosaic pads lanes, and K5 stacks streams along sublanes; none of
that applies to Hopper. As for the codec (ops/mega_kernel.py), every layer
is causal and a dispatch's chunk a whole number of hops, so one launch per
layer covers all B streams and all N frames, and each layer's cache is the
tail of its input. A dispatch with PQC is 23 launches (v1) or 43 (v0)
whatever B is:

- :func:`~dl_speech_enhancement_tpu_torch.ops.mega_kernel.codebook_lookup`
  of the int32 wire codes in the transmitter's books (without PQC the wire
  is the encoder features);
- the input conv (causal_conv), with the analyzer statistics folded into
  its weights and bias in f64 at build time; its cache starts at the
  statistics' mean, which is zero once normalised, as the reference's is;
- per stage: the upsample (causal_conv_transpose with LeakyReLU(0.1) fused
  on load), then the fusion block: for MultiGroupConv1d (v1, v2) three
  :func:`hifigan_unit` launches (csrc/hifigan_unit.cu; the first reads its
  c-channel input for every group, the reference's tile) and the 1x1 fuse
  (causal_conv, no bias); for MultiReceptiveField (v0, v3; K4's ``add_mrf``)
  three ungrouped blocks of three units over the same entrance, averaged in
  the units' accumulate epilogue (43 launches a dispatch with PQC);
- the output conv: causal_conv with LeakyReLU(0.01) on load and tanh.

:func:`vocoder_half` is that sequence as a
:class:`~dl_speech_enhancement_tpu_torch.ops.mega_kernel.StreamHalf`, so
``join_halves(mega_encoder(codec, ...), vocoder_half(voc, ...), ...)`` is the
tx -> wire codes -> rx stream of a vocoder-paired preset. Weights are copied
once, at build time, in ``weight_dtype`` (bf16 by default; sums, biases and
books stay f32). With bf16 weights every product is bf16 by bf16, as in the JAX
kernels: each layer rounds its activated input rows to bf16, and each upsample
rounds once more where the JAX kernel it stands for does
(``upsample_rounding``): K4 its phase product before the bias
(ops/vocoder_kernel.py:324, ``yp.astype(wd)``), K5 its output after it
(ops/vocoder_stacked.py:253, before a 0/1 tiling matmul in bf16); the
activations between launches (the units' running sum too) in
``boundary_dtype``, f32 by default or bf16, which the kernels load and store
themselves (ops/mega_kernel.py). The JAX K5 refuses a MultiReceptiveField
receiver; the port's batch axis serves it, as the JAX ``VocoderReceiver`` does
through XLA.
"""

from __future__ import annotations

import functools

import torch

from dl_speech_enhancement_tpu_torch.models.hifigan import (
    HiFiGANGenerator,
    MultiReceptiveField,
)
from dl_speech_enhancement_tpu_torch.ops import _cuda
from dl_speech_enhancement_tpu_torch.ops.mega_kernel import (
    BadCodeWord,
    StreamHalf,
    _bias,
    _check_half_dtype,
    _leaky,
    causal_conv,
    causal_conv_transpose,
    codebook_lookup,
    conv_transpose_weight,
    conv_weight,
    init_half_cache,
    vq_tables,
)
from dl_speech_enhancement_tpu_torch.ops.stream_kernel import (
    _MAX_SMEM,
    _N_SM,
    ACT_DTYPES,
    _check_operands,
    act_types,
    check_boundary_dtype,
    mma_operand,
    tail,
)
from dl_speech_enhancement_tpu_torch.utils.trace import spanned

# ---------------------------------------------------------------- kernel


def hifigan_unit_plain(cache1, cache2, x, w1, b1, w2, b2, dilation: int, groups: int,
                       slope: float = 0.1, acc=None, out_scale: float = 1.0):
    """Plain PyTorch version of :func:`hifigan_unit`, in f32, on (time, C)
    or (B, time, C). Returns (out in x's dtype, new cache2 f32). With bf16
    weights each conv's operand, leaky(x_ext1) and leaky(h_ext) with the
    cache rows, is rounded to bf16 (JAX ops/vocoder_kernel.py:383,387); the
    new cache2, the biases, the residual and the sums stay f32."""
    taps, c, gc = w1.shape
    s = 0 if x.shape[-1] != gc else c  # tiled first unit: every group reads x
    wd, w1, w2 = w1.dtype, w1.float(), w2.float()
    dtype, x = x.dtype, x.float()
    T = x.shape[-2]
    a = mma_operand(_leaky(torch.cat([cache1, x], dim=-2), slope), wd)
    hs = []
    for g in range(groups):
        a_g, cols = a[..., g * s: g * s + c], slice(g * c, (g + 1) * c)
        part = a_g[..., 0:T, :] @ w1[0, :, cols]
        for j in range(1, taps):
            part = part + a_g[..., j * dilation: j * dilation + T, :] @ w1[j, :, cols]
        hs.append(part)
    h = torch.cat(hs, dim=-1)
    h = _leaky(h if b1 is None else h + b1, slope)
    h_ext = mma_operand(torch.cat([cache2, h], dim=-2), wd)
    ys = []
    for g in range(groups):
        cols = slice(g * c, (g + 1) * c)
        part = h_ext[..., 0:T, cols] @ w2[0, :, cols]
        for j in range(1, taps):
            part = part + h_ext[..., j: j + T, cols] @ w2[j, :, cols]
        ys.append(part)
    y = torch.cat(ys, dim=-1)
    y = y if b2 is None else y + b2
    res = x if s else x.repeat(*([1] * (x.dim() - 1)), groups)
    out = res + y
    if acc is not None:
        out = acc.float() + out
    return (out * out_scale).to(dtype), tail(cache2, h, taps - 1)


# csrc/tile_mma.cuh and csrc/hifigan_unit.cu, as the planner needs them
_UNIT_CLUSTERS = (1, 2, 4, 8)  # blocks splitting a group's columns
_UNIT_STAGES, _UNIT_KC = 4, 64  # W ring depth, input channels per ring stage
_UNIT_BLOCKS_PER_SM = 2  # of 256 threads: 65,536 registers at up to 128 a thread


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def _unit_fragments(nc: int) -> int:
    """8-column mma fragments across a block computing ``nc`` columns (NF)."""
    return 1 if nc <= 8 else 2 if nc <= 16 else 4 if nc <= 32 else 8


def _unit_clusters(c: int) -> list[int]:
    """Cluster sizes the kernel takes for ``c`` columns a group: each block's
    share a multiple of 4 columns (16-byte weight copies), at most 64."""
    return [n for n in _UNIT_CLUSTERS if c % n == 0 and (c // n) % 4 == 0 and c // n <= 64]


def _unit_fit_error(c: int, taps: int, dilation: int) -> str | None:
    """Why no (tile, cluster) plan of the unit kernel fits ``c`` columns a
    group at kernel ``taps`` and ``dilation``, or None: the planner's own
    test at its shortest tile, one row, with f32 weights (the larger ring)."""
    if not _unit_clusters(c):
        return (f"the unit kernel takes a multiple of 4 channels per group, at most "
                f"{64 * _UNIT_CLUSTERS[-1]}, not {c}")
    if not any(unit_smem_bytes(1, c, taps, dilation, n, False) <= _MAX_SMEM
               for n in _unit_clusters(c)):
        return (f"{c} channels per group at kernel {taps}, dilation {dilation} do not fit "
                "the unit kernel's shared memory")
    return None


def unit_smem_bytes(tile: int, c: int, taps: int, dilation: int, cluster: int,
                    bf16: bool, x_bf16: bool = False) -> int:
    """Shared memory of one hifigan_unit block (csrc/hifigan_unit.cu::
    dse_hifigan_unit_smem, whose ``types`` are ``bf16 | x_bf16 << 1``): the
    W ring; the input window of ``tile + taps - 1`` h rows (rounded up to
    16) reaching back ``(taps - 1) * dilation`` rows, or, if larger, the
    residual tile (``tile`` rows of the block's ``c / cluster`` columns of x,
    f32 or bf16), rounded up to 16 bytes; and the h window of ``tile`` rows
    (rounded up to 16) plus ``taps - 1``. Window rows are ``c`` elements in
    the weights' dtype, rounded up to 8 plus 4 (f32) or to 16 plus 8
    (bf16)."""
    nf = _unit_fragments(c // cluster)
    e = 2 if bf16 else 4  # bytes of a window element
    ring = _UNIT_STAGES * _UNIT_KC * (8 * nf + 8) * e
    lda = -(-c // 16) * 16 + 8 if bf16 else -(-c // 8) * 8 + 4
    window = (_round16(tile + taps - 1) + (taps - 1) * dilation) * lda * e
    residual = tile * (c // cluster) * (2 if x_bf16 else 4)
    return ring + -(-max(window, residual) // 16) * 16 + (_round16(tile) + taps - 1) * lda * e


def _unit_warp_rows(tile: int, taps: int, nf: int, bf16: bool = False) -> int:
    """16-row fragments per warp (csrc/hifigan_unit.cu::unit_wm): 2 once GEMM
    1's window outgrows one block chunk of 1; with bf16 weights 4 once it
    outgrows two."""
    rows, chunk = _round16(tile + taps - 1), 16 * (8 // min(nf, 4))
    return 1 if rows <= chunk else 4 if bf16 and rows > 2 * chunk else 2


@functools.lru_cache(maxsize=512)
def _unit_plan(batch: int, rows: int, c: int, groups: int, taps: int, dilation: int,
               bf16: bool, x_bf16: bool = False) -> tuple[int, int]:
    """(tile, cluster) for the unit kernel: output rows per block, and blocks
    per cluster splitting a group's ``c`` columns, for ``batch`` streams of
    ``rows`` rows. Each cluster recomputes the ``taps - 1`` h rows before its
    tile, so long tiles waste less, but fewer tiles fill fewer SMs; a wider
    cluster spreads a tile over more SMs, each with fewer columns. As
    ops/stream_kernel.py::_chain_plan does, the model counts the serial work of
    one block times the blocks an SM runs in turn or side by side, over the
    grid of ``batch * ceil(rows / tile) * groups * cluster`` blocks. A block's
    work is a barrier per (tap, 64-channel) step and, per 8-channel slice, 3 +
    the mma fragments a warp holds in eighths (a step is mostly latency: a warp
    with twice the fragments takes ~1.2x as long; half that with bf16 weights,
    whose bf16 ``mma`` takes 16 channels at once), and its staging and gather
    copies (half the bytes with bf16 weights). Among the plans whose shared
    memory fits it takes the one with the fewest blocks within 5 % of the
    cheapest (the model is no finer than that, and every extra block reads its
    weights again). Pure Python, so the CPU tests hold it."""
    plans = []
    slices, k8 = -(-c // _UNIT_KC), -(-c // 8)
    kp = 8 * k8
    for cluster in _unit_clusters(c):
        nc = c // cluster
        nf = _unit_fragments(nc)
        warps_n = min(nf, 4)
        wn = nf // warps_n
        candidates = {1, 4, 8, 16, 32, 64, 128, 256, rows}
        for wm in (1, 2, 4) if bf16 else (1, 2):
            candidates |= {m * 16 * wm * (8 // warps_n) - (taps - 1) for m in range(1, 9)}
        for tile in sorted(t for t in candidates if 0 < t <= rows):
            smem = unit_smem_bytes(tile, c, taps, dilation, cluster, bf16, x_bf16)
            if smem > _MAX_SMEM:
                continue
            wm = _unit_warp_rows(tile, taps, nf, bf16)
            bm = 16 * wm * (8 // warps_n)
            chunks = -(-(tile + taps - 1) // bm) + -(-tile // bm)
            copies = ((_round16(tile + taps - 1) + (taps - 1) * dilation) * kp
                      + (tile + taps - 1) * (c - nc)) / 256 / (2 if bf16 else 1)
            work = chunks * taps * (2 * slices + k8 * (3 + wm * wn) / (16 if bf16 else 8)) + copies
            blocks = batch * -(-rows // tile) * groups * cluster
            per_sm = max(1, min(_UNIT_BLOCKS_PER_SM, (_MAX_SMEM + 1024) // (smem + 1024)))
            waves = -(-blocks // (_N_SM * per_sm))
            sharing = min(per_sm, -(-blocks // _N_SM))
            plans.append((waves * sharing * work, blocks, (tile, cluster)))
    if not plans:
        raise ValueError(f"hifigan_unit: no plan fits at {c} columns a group, kernel {taps}, "
                         f"dilation {dilation}")
    cheapest = min(p[0] for p in plans)
    return min((blocks, cost, plan) for cost, blocks, plan in plans
               if cost <= 1.05 * cheapest)[2]


@spanned("launch.hifigan_unit")
def hifigan_unit(cache1: torch.Tensor, cache2: torch.Tensor, x: torch.Tensor,
                 w1: torch.Tensor, b1: torch.Tensor | None, w2: torch.Tensor,
                 b2: torch.Tensor | None, dilation: int, groups: int, slope: float = 0.1,
                 acc: torch.Tensor | None = None, out_scale: float = 1.0):
    """One grouped HiFiGAN dilation unit for B streams, ``x + conv2(leaky(
    conv1(leaky(x))))`` (csrc/hifigan_unit.cu), optionally added to a
    running sum and scaled: ``(acc + unit) * out_scale``, a
    MultiReceptiveField stage's block sum and mean.

    x (B, T, Cin) f32 or bf16 with Cin = groups * c, or Cin = c for the
    first unit of a MultiGroupConv1d (every group reads x); cache1 (B, (k-1)
    * dilation, Cin) f32, the tail of the raw unit input (any stream stride);
    cache2 (B, k-1, groups * c) f32, conv2's activated window rows; w1, w2
    (k, c, groups * c) f32 or bf16, 16-byte aligned, c a multiple of 4; b1,
    b2 (groups * c,) f32 or None; acc None or x's batch and time by groups *
    c, in x's dtype. 2-D tensors are one stream. Returns (out (B, T, groups *
    c) in x's dtype, new cache2 (B, k-1, groups * c) f32). On the card the
    products are tensor-core passes in a fixed order (split TF32 with f32
    weights; bf16 ``mma`` on the bf16-rounded operands with bf16 weights),
    so a stream's bits do not depend on B or the plan."""
    if x.device.type == "cpu":
        return hifigan_unit_plain(cache1, cache2, x, w1, b1, w2, b2, dilation, groups, slope,
                                  acc, out_scale)
    if x.device.type != "cuda":
        raise ValueError(f"hifigan_unit: unsupported device {x.device}")
    if x.dim() == 2 and cache1.dim() == 2 and cache2.dim() == 2:
        out, new2 = hifigan_unit(cache1[None], cache2[None], x[None], w1, b1, w2, b2,
                                 dilation, groups, slope,
                                 None if acc is None else acc[None], out_scale)
        return out[0], new2[0]
    if x.dim() != 3:
        raise ValueError(f"hifigan_unit: x must be (B, T, Cin), got {tuple(x.shape)}")
    B, T, cin = x.shape
    taps, c, gc = w1.shape
    if gc != groups * c or cin not in (c, gc) or w2.shape != w1.shape or taps < 2:
        raise ValueError(f"hifigan_unit: weights {tuple(w1.shape)}, {tuple(w2.shape)} do "
                         f"not fit {groups} groups at input {tuple(x.shape)}")
    if (cache1.shape != (B, (taps - 1) * dilation, cin)
            or cache2.shape != (B, taps - 1, gc)):
        raise ValueError(f"hifigan_unit: caches {tuple(cache1.shape)}, {tuple(cache2.shape)} "
                         f"do not fit input {tuple(x.shape)} at dilation {dilation}")
    for b in (b1, b2):
        if b is not None and b.shape != (gc,):
            raise ValueError(f"hifigan_unit: bias {tuple(b.shape)} does not fit {gc}")
    if acc is not None and acc.shape != (B, T, gc):
        raise ValueError(f"hifigan_unit: running sum {tuple(acc.shape)} does not fit "
                         f"output {(B, T, gc)}")
    if acc is not None and acc.dtype != x.dtype:
        raise ValueError(f"hifigan_unit: the running sum is {acc.dtype}, x {x.dtype}")
    _check_operands("hifigan_unit", x.device, {"x": x}, (w1, w2), b1, cache=cache1,
                    act_dtypes=ACT_DTYPES)
    _check_operands("hifigan_unit", x.device, {"x": x, **({} if acc is None else {"acc": acc})},
                    (w1, w2), b2, cache=cache2, act_dtypes=ACT_DTYPES)
    out = torch.empty((B, T, gc), device=x.device, dtype=x.dtype)
    new2 = torch.empty((B, taps - 1, gc), device=x.device)
    if B * T == 0:
        return out, cache2.clone()
    if c % 4 or any(w.data_ptr() % 16 for w in (w1, w2)):
        raise ValueError(f"hifigan_unit: {c} columns a group must be a multiple of 4, and "
                         "the weights 16-byte aligned")
    bf16 = w1.dtype == torch.bfloat16
    tile, cluster = _unit_plan(B, T, c, groups, taps, dilation, bf16, x.dtype == torch.bfloat16)
    lib = _cuda.load("hifigan_unit")
    _cuda.launch(lib, "dse_hifigan_unit", "hifigan_unit", x, cache1.data_ptr(),
                 cache1.stride(0), cache2.data_ptr(), cache2.stride(0), x.data_ptr(),
                 w1.data_ptr(), None if b1 is None else b1.data_ptr(), w2.data_ptr(),
                 None if b2 is None else b2.data_ptr(),
                 None if acc is None else acc.data_ptr(), out_scale, out.data_ptr(),
                 new2.data_ptr(), B, T, c, groups, int(cin != gc), taps, dilation, tile,
                 cluster, slope, act_types(bf16, x.dtype == torch.bfloat16))
    hifigan_unit.launches += 1
    return out, new2


hifigan_unit.launches = 0

# ---------------------------------------------------------------- receiver


def vocoder_topology_error(voc, chunk: int, hop: int | None = None) -> str | None:
    """Why the vocoder's kernel route cannot run ``voc`` at ``chunk`` audio
    samples per frame (behind a transmitter of hop ``hop``, if given), or
    None. The routes ask this before they build anything, in place of the
    JAX package's ``except AssertionError`` fallback."""
    if not isinstance(voc, HiFiGANGenerator):
        return f"the vocoder route takes a HiFiGANGenerator, got {type(voc).__name__}"
    for si, blk in enumerate(voc.blocks):
        c = voc.upsamples[si].out_channels
        resblocks = blk.blocks if isinstance(blk, MultiReceptiveField) else [blk.block]
        for bi, rb in enumerate(resblocks):
            if not rb.use_additional_convs:
                return "the unit kernel needs the residual blocks' additional convs (conv2)"
            taps = rb.convs1[0].kernel_size
            if isinstance(blk, MultiReceptiveField) and (rb.convs1[0].in_channels != c
                                                         or rb.convs1[0].groups != 1):
                return (f"stage {si} block {bi}: a MultiReceptiveField block must take the "
                        f"stage's {c} channels, ungrouped")
            for conv in rb.convs1:
                reason = _unit_fit_error(c, taps, conv.dilation)
                if reason:
                    return f"stage {si}: {reason}"
    for name, conv in (("input", voc.input_conv), ("output", voc.output_conv)):
        if conv.stride != 1 or conv.dilation != 1 or conv.groups != 1:
            return f"the {name} conv must be unstrided, undilated and ungrouped"
    if hop is not None and voc.total_upsample != hop:
        return (f"the vocoder's total upsample {voc.total_upsample} must equal the "
                f"transmitter's hop {hop}")
    if chunk <= 0 or chunk % voc.total_upsample:
        return (f"chunk {chunk} must be a positive multiple of the vocoder's total upsample "
                f"{voc.total_upsample}")
    return None


def _folded_input_conv(voc, weight_dtype):
    """The input conv's (k, in, out) weight and bias with the statistics
    normalisation folded in, in f64: ``W' = W / scale``, ``b' = b - sum_j
    (mean / scale) @ W[j]``."""
    w = voc.input_conv.weight.detach().permute(2, 1, 0).double()
    b = voc.input_conv.bias
    b = w.new_zeros(w.shape[2]) if b is None else b.detach().double()
    if voc.norm:
        mean, scale = voc.mean.double(), voc.scale.double()
        b = b - torch.einsum("i,kio->o", mean / scale, w)
        w = w / scale[None, :, None]
    return w.to(weight_dtype).contiguous(), b.float().contiguous()


def _stage_blocks(si, blk, c, wd):
    """A fusion block's residual blocks as the kernel runs them: ``(blocks,
    fuse weight or None, groups, {cache name: (rows, channels)})``, each
    block a list of ``(w1, b1, w2, b2, dilation, raw cache, act cache)``.
    MultiGroupConv1d: one grouped block over the tiled input, then the 1x1
    fuse; names ``v{si}r{ui}a/b``. MultiReceptiveField: ungrouped blocks
    over the same entrance, averaged; names ``v{si}b{bi}r{ui}a/b``."""
    mrf = isinstance(blk, MultiReceptiveField)
    resblocks = blk.blocks if mrf else [blk.block]
    groups = 1 if mrf else blk.groups
    blocks, shapes = [], {}
    for bi, rb in enumerate(resblocks):
        units = []
        for ui, (c1, c2) in enumerate(zip(rb.convs1, rb.convs2)):
            name = f"v{si}b{bi}r{ui}" if mrf else f"v{si}r{ui}"
            shapes[f"{name}a"] = (c1.pad_length, c if ui == 0 else groups * c)
            shapes[f"{name}b"] = (c2.pad_length, groups * c)
            units.append((conv_weight(c1, wd), _bias(c1), conv_weight(c2, wd), _bias(c2),
                          c1.dilation, f"{name}a", f"{name}b"))
        blocks.append(units)
    return blocks, None if mrf else conv_weight(blk.conv_out, wd), groups, shapes


def vocoder_half(voc, weight_dtype=torch.bfloat16, vq_state=None,
                 boundary_dtype=torch.float32, upsample_rounding="product") -> StreamHalf:
    """The HiFiGAN receiver as a stream half: with PQC (``vq_state``, the
    transmitter's ``VQState``) codebook_lookup first, then the input conv,
    per stage the upsample and the fusion block, and the output conv.

    - MultiGroupConv1d (v1, v2): 3 hifigan_unit launches and the 1x1 fuse
      a stage, 23 launches a dispatch, 22 without PQC.
    - MultiReceptiveField (v0, v3): per block 3 hifigan_unit launches, every
      block from the stage's entrance; the last unit of block 0 writes the
      running sum, of each later block adds to it, of the last also scales
      by 1 / blocks (the kernel's epilogue), so the stage's mean costs no
      launch: 43 launches a dispatch with 3 blocks, 42 without PQC.

    ``run(cache, wire) -> (audio (B, rows * total_upsample, 1) f32, new cache
    entries)`` takes int32 wire codes (B, rows, L) (a code outside its book
    raises ValueError, on the card at the half's next ``run`` after its
    dispatch has finished: the half owns a ``BadCodeWord``), or features (B,
    rows, in_channels) without PQC, f32 or ``boundary_dtype``. Activations
    cross launches in ``boundary_dtype`` (float32 or bfloat16).
    Cache names start with ``v``, apart from the codec halves' names.
    ``upsample_rounding`` (bf16 weights) is ``"product"`` as in JAX K4 (the
    streaming entry points' receiver) or ``"output"`` as in JAX K5."""
    reason = vocoder_topology_error(voc, voc.total_upsample)
    if reason:
        raise ValueError(reason)
    _check_half_dtype(weight_dtype)
    check_boundary_dtype(boundary_dtype)
    wd, slope = weight_dtype, voc.negative_slope
    ci, co = voc.input_conv, voc.output_conv
    w_in, b_in = _folded_input_conv(voc, wd)
    w_in, b_in = w_in.to(voc.device), b_in.to(voc.device)
    if vq_state is not None:
        _, _, books_t = vq_tables(vq_state, voc.device)
        word = BadCodeWord()
        if books_t.shape[2] != ci.in_channels:
            raise ValueError(f"code dim {books_t.shape[2]} does not fit the vocoder's "
                             f"{ci.in_channels} input channels")
    shapes = {"v_in": (ci.pad_length, ci.in_channels)}
    stages = []
    for si, (up, blk) in enumerate(zip(voc.upsamples, voc.blocks)):
        shapes[f"v{si}u"] = (1, up.in_channels)
        blocks, w_f, groups, unit_shapes = _stage_blocks(si, blk, up.out_channels, wd)
        shapes.update(unit_shapes)
        stages.append((conv_transpose_weight(up, wd), _bias(up), up.stride, blocks, w_f,
                       groups))
    shapes["v_out"] = (co.pad_length, co.in_channels)
    w_out, b_out = conv_weight(co, wd), _bias(co)
    fills = {"v_in": voc.mean.detach().float()} if voc.norm else None

    def run(cache, wire):
        new, h = {}, wire
        if vq_state is not None:
            batch, rows, n_books = wire.shape
            h = codebook_lookup(wire.reshape(batch * rows, n_books), books_t, word,
                                boundary_dtype).reshape(batch, rows, -1)
        # without PQC the wire may be the caller's tensor: keep the cache off it
        new["v_in"] = tail(cache["v_in"], h, shapes["v_in"][0]).clone()
        h = causal_conv(cache["v_in"], h, w_in, b_in, out_dtype=boundary_dtype)
        for si, (w_up, b_up, s, blocks, w_f, groups) in enumerate(stages):
            new[f"v{si}u"] = tail(cache[f"v{si}u"], h, 1)
            h = causal_conv_transpose(cache[f"v{si}u"], h, w_up, b_up, s, leaky=slope,
                                      rounding=upsample_rounding)
            total = None  # the running sum of the blocks (MultiReceptiveField)
            for bi, units in enumerate(blocks):
                y = h
                for ui, (w1, b1, w2, b2, d, raw, act) in enumerate(units):
                    new[raw] = tail(cache[raw], y, shapes[raw][0])
                    sums = w_f is None and ui == len(units) - 1
                    scale = 1.0 / len(blocks) if sums and bi == len(blocks) - 1 else 1.0
                    y, new[act] = hifigan_unit(cache[raw], cache[act], y, w1, b1, w2, b2, d,
                                               groups, slope, total if sums else None, scale)
                total = y
            # the 1x1 fuse reads no cache: an empty f32 one
            h = total if w_f is None else causal_conv(
                total.new_empty((total.shape[0], 0, total.shape[2]), dtype=torch.float32),
                total, w_f)
        new["v_out"] = tail(cache["v_out"], h, shapes["v_out"][0])
        # upstream uses LeakyReLU(0.01) before the output conv (HiFiGAN.py:116)
        return causal_conv(cache["v_out"], h, w_out, b_out, leaky=0.01, tanh=True,
                           out_dtype=torch.float32), new

    return StreamHalf(shapes, run, voc.total_upsample, vq_state is not None, fills,
                      boundary_dtype, "receiver")


def conv_sites(model, frame: int) -> list:
    """``(site, layer, output rows a frame)`` of every causal_conv launch of
    one dispatch of a codec generator (the sites of ``mega_encoder`` and
    ``mega_decoder``) or of a HiFiGAN receiver (those of
    :func:`vocoder_half`), at ``frame`` input samples a frame."""
    if isinstance(model, HiFiGANGenerator):
        t = frame // model.total_upsample
        out = [("v_in", model.input_conv, t)]
        for si, (up, blk) in enumerate(zip(model.upsamples, model.blocks)):
            t *= up.stride
            if not isinstance(blk, MultiReceptiveField):
                out.append((f"v{si}f", blk.conv_out, t))
        return out + [("v_out", model.output_conv, t)]
    t, enc, dec = frame, model.encoder, model.decoder
    out = [("enc_in", enc.conv, t)]
    for bi, blk in enumerate(enc.blocks):
        t //= blk.conv.stride
        out.append((f"e{bi}d", blk.conv, t))
    if model.use_pqc:
        out += [("prj", model.projector.conv, t), ("dec_in", dec.conv1, t)]
    return out + [("dec_out", dec.conv2, frame)]


def make_stacked_vocoder(voc, chunk: int, batch: int, weight_dtype=torch.bfloat16,
                         vq_state=None, boundary_dtype=torch.float32,
                         upsample_rounding="output"):
    """The receiver alone for ``batch`` streams, the counterpart of JAX
    ops/vocoder_stacked.py::make_stacked_vocoder (K5; re-exported from
    ops/vocoder_stacked.py): ``init_cache() -> {name: (B, ctx, C)}`` and
    ``run(cache, wire (N, B, chunk / total_upsample, L or in_channels)) ->
    (audio (N, B, chunk) f32, new_cache)``; per stream and frame it matches
    ``voc.step`` (after the codebook lookup with PQC) from zero caches.
    ``boundary_dtype`` (float32 or bfloat16) is the activations' dtype
    between launches (JAX's, :120); at bf16 weights each upsample rounds its
    output as K5 does (``upsample_rounding``, :func:`vocoder_half`)."""
    reason = vocoder_topology_error(voc, chunk)
    if reason:
        raise ValueError(reason)
    if batch < 1:
        raise ValueError(f"batch must be at least 1, got {batch}")
    half = vocoder_half(voc, weight_dtype, vq_state, boundary_dtype, upsample_rounding)
    rows = chunk // voc.total_upsample

    def init_cache():
        return init_half_cache((half,), batch, voc.device)

    def run(cache, wire):
        if wire.dim() != 4 or wire.shape[1:3] != (batch, rows):
            raise ValueError(f"wire must be (N, {batch}, {rows}, C), got {tuple(wire.shape)}")
        n = wire.shape[0]
        y, new = half.run(cache, wire.transpose(0, 1).reshape(batch, n * rows, -1).contiguous())
        return y.reshape(batch, n, chunk).transpose(0, 1).contiguous(), new

    return init_cache, run


def make_mega_vocoder(voc, chunk: int, weight_dtype=torch.bfloat16, vq_state=None):
    """One stream of :func:`make_stacked_vocoder` in the JAX package's
    single-stream layout: ``init_cache() -> {name: (ctx, C)}``, ``run(cache,
    zq (n, chunk / total_upsample, in_channels) f32, or int32 codes (n,
    rows, L) with ``vq_state``) -> (audio (n, chunk), new_cache)``."""
    init_b, run_b = make_stacked_vocoder(voc, chunk, 1, weight_dtype, vq_state,
                                         upsample_rounding="product")

    def init_cache():
        return {name: t[0] for name, t in init_b().items()}

    def run(cache, x):
        if x.dim() != 3:
            raise ValueError(f"input must be (n, rows, C), got {tuple(x.shape)}")
        y, new = run_b({name: t[None] for name, t in cache.items()}, x[:, None])
        return y[:, 0], {name: t[0] for name, t in new.items()}

    return init_cache, run
