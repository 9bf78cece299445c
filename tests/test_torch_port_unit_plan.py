"""hifigan_unit's planner, shared-memory formula and split-TF32 arithmetic,
on the CPU.

The planner (ops/vocoder_kernel.py::_unit_plan) and its shared-memory
formula (unit_smem_bytes, equal to csrc/hifigan_unit.cu's
dse_hifigan_unit_smem; tests/test_torch_port_cuda.py holds the two equal on
the card) are plain Python, so they are held here at every unit site of the
v0, v1 and v2 receivers at the (streams, frames per dispatch) the paths
dispatch. The kernel's products are split-TF32 tensor-core passes; an
emulation of their arithmetic in numpy (TF32 rounding by bit masking, as
cvt.rna rounds; each mma an exact 8-product sum rounded to f32 into its
chain; the chains folded into the f32 running sum per (tap, 64-channel)
step in the kernel's order) shows the error of a stage-0 unit's 2,816-term
sums against f64 well under chip_smoke.py's KERNEL_ATOL_F32 (1e-4), which
is why that tolerance did not move, while a single TF32 pass would not meet
it. With bf16 weights the kernel multiplies the bf16-rounded operands (the
leaky input window and the leaky h window, as JAX rounds them) on bf16
``mma.m16n8k16``; its emulation (each mma an exact 16-product sum added to
its fragment and rounded to f32, a (tap, 64-channel) chunk's four slices
in even and odd fragments folded in chunk order) gives the same bits for
every (tile, cluster) split and stays within 1e-6 of the largest |output| of
the exact sums of the same operands.
"""

import os

import numpy as np
import pytest

from dl_speech_enhancement_tpu_torch.models.hifigan import (
    HiFiGANGenerator,
    MultiReceptiveField,
)
from dl_speech_enhancement_tpu_torch.ops.stream_kernel import _MAX_SMEM, _N_SM
from dl_speech_enhancement_tpu_torch.ops.vocoder_kernel import (
    _unit_clusters,
    _unit_fit_error,
    _unit_plan,
    unit_smem_bytes,
    vocoder_topology_error,
)
from dl_speech_enhancement_tpu_torch.utils.config import load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAME = 1200
KERNEL_ATOL_F32 = 1e-4  # chip_smoke.py's kernel-vs-plain tolerance with f32 weights
SHAPES = ((1, 1), (1, 100), (1, 400), (16, 1), (16, 16), (64, 16))


def _receiver(version):
    gp = dict(load_config(os.path.join(
        REPO, "configs", "vocoder", f"AudioDec_{version}_symAD_vctk_48000_hop300_clean.yaml"))
        ["generator_params"])
    gp.pop("nonlinear_activation")
    gp["negative_slope"] = gp.pop("nonlinear_activation_params")["negative_slope"]
    for key in ("use_weight_norm", "stats"):
        gp.pop(key)
    return HiFiGANGenerator(**gp, device="cpu")


@pytest.fixture(scope="module")
def receivers():
    return {version: _receiver(version) for version in ("v0", "v1", "v2")}


def _unit_sites(voc, n_frames):
    """(stage, c, groups, taps, dilation, rows a stream) of every unit launch."""
    rows, sites = n_frames * FRAME // voc.total_upsample, []
    for si, (up, blk) in enumerate(zip(voc.upsamples, voc.blocks)):
        rows *= up.stride
        mrf = isinstance(blk, MultiReceptiveField)
        for rb in blk.blocks if mrf else [blk.block]:
            for conv in rb.convs1:
                sites.append((si, up.out_channels, 1 if mrf else blk.groups, conv.kernel_size,
                              conv.dilation, rows))
    return sites


@pytest.mark.parametrize("version", ["v0", "v1", "v2"])
@pytest.mark.parametrize("batch,n_frames", SHAPES)
def test_every_unit_plan_fits_shared_memory(receivers, version, batch, n_frames):
    voc = receivers[version]
    assert vocoder_topology_error(voc, FRAME) is None
    for _, c, groups, taps, dilation, rows in _unit_sites(voc, n_frames):
        for bf16 in (False, True):
            tile, cluster = _unit_plan(batch, rows, c, groups, taps, dilation, bf16)
            assert 0 < tile <= rows and cluster in _unit_clusters(c)
            assert unit_smem_bytes(tile, c, taps, dilation, cluster, bf16) <= _MAX_SMEM == 232448


@pytest.mark.parametrize("version,min_sms", [("v0", 8), ("v1", 24)])
def test_stage0_spreads_over_the_card_at_one_frame(receivers, version, min_sms):
    """One stream, one frame per dispatch: stage 0 has 20 rows at c = 256;
    its units' grids (streams x tiles x groups x cluster blocks, one SM
    each) cover at least 8 SMs (v0, groups 1) and 24 (v1, groups 3)."""
    for si, c, groups, taps, dilation, rows in _unit_sites(receivers[version], 1):
        if si == 0:
            tile, cluster = _unit_plan(1, rows, c, groups, taps, dilation, True)
            blocks = -(-rows // tile) * groups * cluster
            assert cluster > 1 and min_sms <= blocks <= _N_SM


def test_topology_error_and_planner_agree_on_what_fits():
    """vocoder_topology_error asks the planner's own formula
    (_unit_fit_error): a unit it accepts has a plan at every row count, and
    one it refuses has none."""
    for c in (4, 6, 32, 64, 256, 512, 1024):
        for taps, dilation in ((3, 1), (11, 5), (11, 40), (14, 9), (31, 9), (31, 200)):
            fits = _unit_fit_error(c, taps, dilation) is None
            for rows in (1, 3, 4, 400, 8000):
                try:
                    _unit_plan(1, rows, c, 1, taps, dilation, False)
                    planned = True
                except ValueError:
                    planned = False
                assert planned == fits, (c, taps, dilation, rows)
    for channels, taps, dilation, reason in ((12, 3, 1, "multiple of 4"),
                                             (128, 31, 200, "shared memory"),
                                             (128, 31, 9, None)):
        voc = HiFiGANGenerator(in_channels=8, channels=channels, upsample_scales=(2,),
                               upsample_kernel_sizes=(4,), resblock_kernel_sizes=(taps,),
                               resblock_dilations=((1, dilation),), groups=1, device="cpu")
        got = vocoder_topology_error(voc, 2)
        assert got is None if reason is None else reason in got


# ---------------------------------------------------------------- split TF32


def _tf32(a):
    """cvt.rna.tf32.f32: the magnitude rounded to 10 mantissa bits, ties away."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _emulated_tap_gemm(windows, w, passes):
    """out[m, n] = sum_{j, ci} windows[m, j, ci] * w[j, ci, n] as the kernel
    computes it (csrc/tile_mma.cuh): ``passes`` 1 (single TF32, for
    comparison), 2 (a_hi*w + a_lo*w, bf16 weights) or 3 (a_hi*w_hi +
    a_lo*w_hi + a_hi*w_lo, f32 weights)."""
    m, taps, k = windows.shape
    n = w.shape[2]
    kp = -(-k // 64) * 64  # zeros past k add nothing to a chain
    a = np.zeros((m, taps, kp), np.float32)
    a[:, :, :k] = windows
    wp = np.zeros((taps, kp, n), np.float32)
    wp[:, :k] = w
    a_hi = _tf32(a)
    a_lo = _tf32(a - a_hi)
    w_hi = wp if passes == 2 else _tf32(wp)
    w_lo = _tf32(wp - w_hi)
    steps = kp // 64

    def mma8(x, y):  # (m, taps, steps, 8 slices, n): one mma's 8 exact products each
        xs = x.reshape(m, taps, steps, 8, 8).astype(np.float64)
        ys = y.reshape(taps, steps, 8, 8, n).astype(np.float64)
        return np.einsum("mtskc,tskcn->mtskn", xs, ys)

    big = mma8(a_hi, w_hi)
    small = [mma8(a_lo, w_hi)] + ([mma8(a_hi, w_lo)] if passes == 3 else [])
    chains = {}
    for name, terms in (("big", [big]), ("small", small if passes > 1 else [])):
        for parity in (0, 1):
            d = np.zeros((m, taps, steps, n), np.float32)
            for kk in range(parity, 8, 2):
                for t in terms:
                    d = (d.astype(np.float64) + t[:, :, :, kk]).astype(np.float32)
            chains[name, parity] = d
    step = ((chains["big", 0] + chains["big", 1])
            + (chains["small", 0] + chains["small", 1]))  # f32 adds, the kernel's order
    acc = np.zeros((m, n), np.float32)
    for j in range(taps):
        for s in range(steps):
            acc = acc + step[:, j, s]
    return acc


def _stage0_unit(rng, weight_bf16):
    """A v0 stage-0 unit (c = 256, k = 11, dilation 5, 20 rows, groups 1):
    the leaky input windows of its 30 h rows, its weights (bf16-rounded for
    bf16 weights) and biases, N(0, 1) activations and unit-gain weights."""
    c, k, d, rows = 256, 11, 5, 20
    x_ext = rng.standard_normal(((k - 1) * d + rows + k - 1, c)).astype(np.float32)
    a = np.where(x_ext >= 0, x_ext, np.float32(0.1) * x_ext)
    w1, w2 = (rng.standard_normal((k, c, c)).astype(np.float32) / np.float32(np.sqrt(k * c))
              for _ in range(2))
    if weight_bf16:
        w1, w2 = (((ww.view(np.uint32) + np.uint32(0x8000)) & np.uint32(0xFFFF0000))
                  .view(np.float32) for ww in (w1, w2))
    b1 = rng.standard_normal(c).astype(np.float32) * np.float32(0.3)
    cache2 = rng.standard_normal((k - 1, c)).astype(np.float32)
    windows1 = np.stack([a[j * d: j * d + rows + k - 1] for j in range(k)], axis=1)
    return windows1, w1, b1, w2, cache2, k, rows


@pytest.mark.parametrize("weight_bf16,passes", [(True, 2), (False, 3)])
def test_split_tf32_stage0_unit_error_is_far_under_the_kernel_tolerance(weight_bf16, passes):
    rng = np.random.default_rng(7)
    windows1, w1, b1, w2, cache2, k, rows = _stage0_unit(rng, weight_bf16)
    exact1 = np.einsum("mjc,jcn->mn", windows1.astype(np.float64), w1.astype(np.float64))
    got1 = _emulated_tap_gemm(windows1, w1, passes)
    assert windows1.shape[1] * windows1.shape[2] == 2816
    err1 = float(np.abs(got1 - exact1).max())
    assert err1 < KERNEL_ATOL_F32 / 20, err1
    # the whole unit: conv2 over [cache2; h] from each route's own h
    outs = []
    for h_sum in (exact1, got1):
        h = (h_sum + b1).astype(np.float32)
        h = np.where(h >= 0, h, np.float32(0.1) * h)[k - 1:]
        h_ext = np.concatenate([cache2, h])
        windows2 = np.stack([h_ext[j: j + rows] for j in range(k)], axis=1)
        outs.append(windows2)
    exact2 = np.einsum("mjc,jcn->mn", outs[0].astype(np.float64), w2.astype(np.float64))
    got2 = _emulated_tap_gemm(outs[1], w2, passes)
    err2 = float(np.abs(got2 - exact2).max())
    assert err2 < KERNEL_ATOL_F32 / 20, err2
    # a single TF32 pass would not hold the tolerance
    single = float(np.abs(_emulated_tap_gemm(windows1, w1, 1) - exact1).max())
    assert single > KERNEL_ATOL_F32, single


# ---------------------------------------------------------------- bf16 mma


def _bf16(a):
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x7FFF) + ((bits >> 16) & np.uint32(1)))
            & np.uint32(0xFFFF0000)).view(np.float32)


def _emulated_tap_gemm_bf16(windows, w):
    """The bf16 arm of mma_tap_gemm on bf16 operands: per (tap, 64-channel)
    chunk, 16-channel slices 0 and 2 into one fresh fragment and 1 and 3
    into another (each mma an exact 16-product sum added and rounded to f32),
    the chunk's (even + odd) added to the f32 running sum in chunk order."""
    m, taps, k = windows.shape
    n = w.shape[2]
    kp = -(-k // 64) * 64
    a = np.zeros((m, taps, kp), np.float64)
    a[:, :, :k] = windows
    wp = np.zeros((taps, kp, n), np.float64)
    wp[:, :k] = w
    steps = kp // 64
    sums = np.einsum("mtskc,tskcn->mtskn", a.reshape(m, taps, steps, 4, 16),
                     wp.reshape(taps, steps, 4, 16, n))
    frag = []
    for parity in (0, 1):
        f = np.zeros((m, taps, steps, n), np.float32)
        for kk in (parity, parity + 2):
            f = (f.astype(np.float64) + sums[:, :, :, kk]).astype(np.float32)
        frag.append(f)
    step = frag[0] + frag[1]
    acc = np.zeros((m, n), np.float32)
    for j in range(taps):
        for s in range(steps):
            acc = acc + step[:, j, s]
    return acc


def test_bf16_stage0_unit_gemms_are_within_1e6_of_their_exact_sums():
    """A v0 stage-0 unit on bf16 operands: both GEMMs (2,816-term sums)
    within 1e-6 of their largest |output| of the exact sums of the same
    operands."""
    rng = np.random.default_rng(7)
    windows1, w1, b1, w2, cache2, k, rows = _stage0_unit(rng, True)
    windows1 = _bf16(windows1)
    got1 = _emulated_tap_gemm_bf16(windows1, w1)
    exact1 = np.einsum("mjc,jcn->mn", windows1.astype(np.float64), w1.astype(np.float64))
    assert float(np.abs(got1 - exact1).max()) < 1e-6 * float(np.abs(exact1).max())
    h = (got1 + b1).astype(np.float32)
    h = np.where(h >= 0, h, np.float32(0.1) * h)[k - 1:]
    h_ext = _bf16(np.concatenate([cache2, h]))
    windows2 = np.stack([h_ext[j: j + rows] for j in range(k)], axis=1)
    got2 = _emulated_tap_gemm_bf16(windows2, w2)
    exact2 = np.einsum("mjc,jcn->mn", windows2.astype(np.float64), w2.astype(np.float64))
    assert float(np.abs(got2 - exact2).max()) < 1e-6 * float(np.abs(exact2).max())


@pytest.mark.parametrize("tile,cluster", [(20, 1), (8, 2), (3, 8), (16, 4)])
def test_the_bf16_unit_gives_the_same_bits_for_every_plan(tile, cluster):
    """Tiles split the rows and clusters the columns; neither touches a sum's
    order, so every plan gives the planned (one tile, one block) bits."""
    rng = np.random.default_rng(9)
    windows1, w1, _, _, _, _, _ = _stage0_unit(rng, True)
    windows1 = _bf16(windows1)
    whole = _emulated_tap_gemm_bf16(windows1, w1)
    c, m = w1.shape[2], windows1.shape[0]
    nc = c // cluster
    split = np.concatenate([
        np.concatenate([_emulated_tap_gemm_bf16(windows1[t0:t0 + tile],
                                                w1[:, :, r * nc:(r + 1) * nc])
                        for r in range(cluster)], axis=1)
        for t0 in range(0, m, tile)])
    assert np.array_equal(split, whole)
