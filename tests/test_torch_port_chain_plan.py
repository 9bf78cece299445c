"""residual_chain's planner, shared-memory formula and split-TF32 arithmetic,
on the CPU.

The planner (ops/stream_kernel.py::_chain_plan) and its shared-memory
formula (chain_smem_bytes, equal to csrc/residual_chain.cu's
dse_residual_chain_smem; tests/test_torch_port_cuda.py holds the two equal
on the card) are plain Python and load no library, so they are held here at
every chain site of the denoiser, the codec (whose encoder is the v0, v1 and
v2 receivers' transmitter) and the universal codec, for 1, 16 and 64 streams
of 1, 16, 100 and 400 frames a dispatch. With f32 weights the kernel's
products are split-TF32 tensor-core passes; an emulation of its arithmetic
in numpy (TF32 rounding by bit masking, as cvt.rna rounds; each mma an exact
8-product sum rounded to f32 into its chain; a (tap, 64-channel) chunk's
even and odd chains folded into the f32 running sum in chunk order) runs a
whole chain tile by tile with its halo recomputed and its columns split as a
plan splits them. It shows two plans give the same bits, and the error of
the one-frame C = 256 chain (e3ch) against f64 and against the plain version
far under 2e-6, where a single TF32 pass would not be. With bf16 weights the
operands are rounded to bf16 (ELU(x) and ELU(conv1), as the JAX kernel
rounds them) and each product is a bf16 ``mma.m16n8k16``; its emulation
(each mma an exact 16-product sum added to its fragment and rounded to f32,
a chunk's four 16-channel slices in even and odd fragments, folded in chunk
order) shows every plan gives the same bits and each GEMM within 1e-6 of
the largest |output| of its exact sum on the same operands.
"""

import os

import numpy as np
import pytest
import torch

from dl_speech_enhancement_tpu_torch.models import AudioDecGenerator
from dl_speech_enhancement_tpu_torch.ops.stream_kernel import (
    _MAX_SMEM,
    _chain_clusters,
    _chain_plan,
    chain_fit_error,
    chain_halo,
    chain_lda,
    chain_plans,
    chain_scratch_floats,
    chain_smem_bytes,
    chain_topology_error,
    chain_window_rows,
    residual_chain,
    residual_chain_plain,
)
from dl_speech_enhancement_tpu_torch.utils.checks import exact_sum_weights, rounding_held
from dl_speech_enhancement_tpu_torch.utils.config import load_config

CHAIN_ATOL = 2e-6  # chip_smoke.py's tolerance of the chain kernel against its plain version

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAME = 1200
DILATIONS = (1, 3, 9)
SHAPES = [(b, n) for b in (1, 16, 64) for n in (1, 16, 100, 400)]


def _generator(kind, config):
    gp = load_config(os.path.join(REPO, "configs", kind, config))["generator_params"]
    return AudioDecGenerator(**gp, use_pqc=kind == "autoencoder", device="cpu")


@pytest.fixture(scope="module")
def sites():
    """(name, C, rows a frame) of every chain launch of a dispatch, by path."""
    out = {}
    for path, kind, config in (("denoiser", "denoise", "symAD_vctk_48000_hop300.yaml"),
                               ("codec", "autoencoder", "symAD_vctk_48000_hop300.yaml"),
                               ("univ", "autoencoder", "symADuniv_vctk_48000_hop300.yaml")):
        gen = _generator(kind, config)
        assert chain_topology_error(gen) is None
        found, t = [], FRAME
        for bi, blk in enumerate(gen.encoder.blocks):
            found.append((f"e{bi}ch", blk.conv.in_channels, t))
            t //= blk.conv.stride
        for bi, blk in enumerate(gen.decoder.blocks):
            t *= blk.conv.stride
            found.append((f"d{bi}ch", blk.conv.out_channels, t))
        out[path] = found
    return out


@pytest.mark.parametrize("path", ["denoiser", "codec", "univ"])
@pytest.mark.parametrize("batch", [1, 16, 64])
def test_every_chain_plan_fits(sites, path, batch):
    """Every chain site has a plan at every shape: shared memory within the
    card's 227 KB, a cluster that splits C into shares of 4 to 64 channels,
    tiles that cover every row, and a grid the launch takes."""
    assert {c for _, c, _ in sites[path]} == {32, 64, 128, 256}
    for name, c, rows_a_frame in sites[path]:
        for n in (1, 16, 100, 400):
            rows = rows_a_frame * n
            for bf16 in (False, True):
                tile, cluster = _chain_plan(batch, rows, c, DILATIONS, bf16)
                assert chain_smem_bytes(tile, c, cluster, DILATIONS, bf16) <= _MAX_SMEM == 232448
                assert c % cluster == 0 and cluster in _chain_clusters(c), (name, cluster)
                assert (c // cluster) % 4 == 0 and c // cluster <= 64
                assert 0 < tile <= rows and -(-rows // tile) * tile >= rows
                assert (tile, cluster) in [p[:2] for p in chain_plans(rows, c, DILATIONS, bf16)]
                assert batch * -(-rows // tile) * cluster < 2 ** 31


def test_chain_shared_memory_formula():
    """The formula is the kernel's layout: at e3ch's one-frame tile (20 rows,
    C = 256, 16 blocks of 16 channels) a 4 x 64 x 24 W ring, an f32 X slice
    of 98 rows by 16, an H slice of 92 rows by 16 and a window of 102 rows
    (unit 0's 92 conv1 rows rounded up to 96, plus its reach 6) by 260
    floats with f32 weights; with bf16 weights the ring, the H slice and the
    window hold bf16, the window's rows 264 wide (C rounded up to 16, plus
    8)."""
    assert chain_halo(DILATIONS) == 78 and chain_lda(256) == 260 and chain_lda(20) == 28
    assert chain_lda(256, True) == 264 and chain_lda(20, True) == 40
    assert chain_window_rows(20, DILATIONS) == 102
    assert chain_window_rows(1, DILATIONS) == max(80 + 6, 64 + 18, 16 + 54)
    assert chain_smem_bytes(20, 256, 16, DILATIONS, True) == (
        4 * 64 * 24 * 2 + 4 * 98 * 16 + 2 * (92 * 16 + 102 * 264))
    assert chain_smem_bytes(20, 256, 16, DILATIONS, False) == (
        4 * 64 * 24 * 4 + 4 * ((98 + 92) * 16 + 102 * 260))
    # 64 channels a block: the ring holds 8 fragments' width plus 8
    assert chain_smem_bytes(1, 64, 1, DILATIONS, True) == (
        4 * 64 * 72 * 2 + 4 * 79 * 64 + 2 * (73 * 64 + 86 * 72))
    # the scratch holds the E and H rows in the weights' dtype
    assert chain_scratch_floats(20, 256, DILATIONS) == (2 * 98 - 6) * 256
    assert chain_scratch_floats(20, 256, DILATIONS, True) == (2 * 98 - 6) * 256 // 2


def test_fit_check_and_planner_agree_on_what_fits():
    """chain_fit_error (which chain_topology_error and the wrapper ask) holds
    a channel count to the planner's own test: one it accepts has a plan at
    every row count and batch, one it refuses has none."""
    fitting = {4, 8, 12, 20, 32, 48, 64, 128, 256}
    for c in (4, 6, 8, 12, 20, 32, 48, 64, 100, 128, 256, 512, 1028):
        fits = chain_fit_error(c) is None
        assert fits == (c in fitting), c
        for batch, rows in ((1, 1), (1, 20), (3, 1200), (64, 100)):
            try:
                _chain_plan(batch, rows, c, DILATIONS, False)
                planned = True
            except ValueError:
                planned = False
            assert planned == fits, (c, batch, rows)
    gen = AudioDecGenerator(encode_channels=6, decode_channels=6, code_dim=16,
                            codebook_num=3, codebook_size=32, enc_ratios=(2, 4),
                            dec_ratios=(4, 2), enc_strides=(3, 4), dec_strides=(4, 3),
                            use_pqc=False, device="cpu")
    assert "multiple of 4" in chain_topology_error(gen)
    assert "multiple of 4" in chain_fit_error(100)  # 25 channels a block at best
    assert "shared memory" in chain_fit_error(512)  # the f32 window alone is 178 KB


def test_one_stream_at_one_frame_spreads_the_deep_chains(sites):
    """At one stream of one frame the C = 128 and C = 256 chains have 100 and
    20 rows; their grids use clusters of more than one block."""
    for name, c, rows in sites["denoiser"]:
        if c >= 128:
            tile, cluster = _chain_plan(1, rows, c, DILATIONS, True)
            assert cluster > 1 and -(-rows // tile) * cluster >= 8, (name, tile, cluster)


def test_the_wrapper_runs_the_plain_version_on_the_cpu():
    rng = np.random.default_rng(3)
    cache, x = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                for s in ((2, 78, 8), (2, 5, 8)))
    w1 = torch.from_numpy(rng.standard_normal((3, 7, 8, 8)).astype(np.float32)) / 8
    w2 = torch.from_numpy(rng.standard_normal((3, 8, 8)).astype(np.float32)) / 8
    before = residual_chain.launches
    assert torch.equal(residual_chain(cache, x, w1, w2), residual_chain_plain(cache, x, w1, w2))
    assert residual_chain.launches == before


# ---------------------------------------------------------------- split TF32


def _tf32(a):
    """cvt.rna.tf32.f32: the magnitude rounded to 10 mantissa bits, ties away."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _bf16(a):
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x8000)) & np.uint32(0xFFFF0000)).view(np.float32)


def _elu(a):
    return np.where(a > 0, a, np.exp(np.minimum(a, 0)) - np.float32(1)).astype(np.float32)


def _emulated_conv(a, w, d, passes):
    """out[m, n] = sum_{j, c} a[m + j*d, c] * w[j, c, n] for the rows m that
    every tap reaches, as tile_mma.cuh's mma_tap_gemm computes it: the
    (tap, 64-channel) chunks in order (one tap's C channels when C < 64),
    each an 8-channel slice at a time into fresh even and odd chains of
    a_hi*w_hi (big) and the other passes (small: a_lo*w_hi, and a_hi*w_lo
    with f32 weights; ``passes`` 1 is a single TF32 pass for comparison),
    the chunk's ((big_even + big_odd) + (small_even + small_odd)) added to
    the f32 running sum."""
    taps, k, n = w.shape
    m = a.shape[0] - (taps - 1) * d
    kp = -(-k // 64) * 64  # zeros past k add exact zeros to a chain
    windows = np.zeros((m, taps, kp), np.float32)
    for j in range(taps):
        windows[:, j, :k] = a[j * d: j * d + m]
    wp = np.zeros((taps, kp, n), np.float32)
    wp[:, :k] = w
    a_hi = _tf32(windows)
    a_lo = _tf32(windows - a_hi)
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
            acc = np.zeros((m, taps, steps, n), np.float32)
            for kk in range(parity, 8, 2):
                for t in terms:
                    acc = (acc.astype(np.float64) + t[:, :, :, kk]).astype(np.float32)
            chains[name, parity] = acc
    step = ((chains["big", 0] + chains["big", 1])
            + (chains["small", 0] + chains["small", 1]))
    out = np.zeros((m, n), np.float32)
    for j in range(taps):
        for s in range(steps):
            out = out + step[:, j, s]
    return out


def _emulated_chain(x_ext, w1, w2, passes, tile, cluster):
    """The kernel's chain over one stream's ``x_ext`` (halo + T rows) at the
    plan (tile, cluster): each tile of output rows recomputes its halo, and
    each of the cluster's blocks computes its own C / cluster columns of
    every GEMM from the full-width window, as csrc/residual_chain.cu does."""
    c = x_ext.shape[1]
    halo = chain_halo(DILATIONS)
    nc = c // cluster
    t_out = x_ext.shape[0] - halo
    out = np.zeros((t_out, c), np.float32)
    for t0 in range(0, t_out, tile):
        h = x_ext[t0: t0 + min(tile, t_out - t0) + halo].copy()
        for u, d in enumerate(DILATIONS):
            e = _elu(h)
            conv1 = np.concatenate([_emulated_conv(e, w1[u][:, :, r * nc:(r + 1) * nc], d,
                                                   passes) for r in range(cluster)], axis=1)
            hh = _elu(conv1)
            conv2 = np.concatenate([_emulated_conv(hh, w2[u][None, :, r * nc:(r + 1) * nc], 0,
                                                   passes) for r in range(cluster)], axis=1)
            h = h[6 * d:] + conv2
        out[t0: t0 + h.shape[0]] = h
    return out


def _chain_operands(rng, c, rows, weight_bf16):
    x_ext = (rng.standard_normal((chain_halo(DILATIONS) + rows, c)) * 0.3).astype(np.float32)
    w1 = (rng.standard_normal((3, 7, c, c)) / np.sqrt(7 * c)).astype(np.float32)
    w2 = (rng.standard_normal((3, c, c)) / np.sqrt(c)).astype(np.float32)
    if weight_bf16:
        w1, w2 = _bf16(w1), _bf16(w2)
    return x_ext, w1, w2


def _exact_chain(x_ext, w1, w2):
    h = x_ext.astype(np.float64)
    for u, d in enumerate(DILATIONS):
        e = np.where(h > 0, h, np.expm1(np.minimum(h, 0)))
        m = h.shape[0] - 6 * d
        acc = sum(e[j * d: j * d + m] @ w1[u, j].astype(np.float64) for j in range(7))
        hh = np.where(acc > 0, acc, np.expm1(np.minimum(acc, 0)))
        h = h[6 * d:] + hh @ w2[u].astype(np.float64)
    return h


@pytest.mark.parametrize("c,rows,plans", [
    (32, 40, [(40, 1), (7, 4), (16, 8)]),   # one tap's 32 channels a chunk
    (64, 30, [(30, 1), (4, 16), (13, 2)]),
])
def test_the_chain_gives_the_same_bits_for_every_plan(c, rows, plans):
    """Tiles recompute their halo and clusters split the columns, yet every
    output element is the same sequence of f32 operations: the bits do not
    depend on the plan (nor on B, each stream being its own tiles)."""
    rng = np.random.default_rng(5)
    x_ext, w1, w2 = _chain_operands(rng, c, rows, True)
    outs = [_emulated_chain(x_ext, w1, w2, 2, tile, cluster) for tile, cluster in plans]
    for other in outs[1:]:
        assert np.array_equal(outs[0], other)


@pytest.mark.parametrize("weight_bf16,passes", [(True, 2), (False, 3)])
def test_split_tf32_e3_chain_error_is_far_under_2e6(weight_bf16, passes):
    """e3ch at one frame (C = 256, 20 rows, 1,792-term conv1 sums): the
    emulated kernel against f64 and against the plain version (f32 on the
    CPU) stays far under 2e-6, and a single TF32 pass would not."""
    rng = np.random.default_rng(7)
    x_ext, w1, w2 = _chain_operands(rng, 256, 20, weight_bf16)
    got = _emulated_chain(x_ext, w1, w2, passes, 20, 16)
    exact = _exact_chain(x_ext, w1, w2)
    err = float(np.abs(got - exact).max())
    assert err < 1e-6, err
    plain = residual_chain_plain(torch.from_numpy(x_ext[:78]), torch.from_numpy(x_ext[78:]),
                                 torch.from_numpy(w1), torch.from_numpy(w2)).numpy()
    assert float(np.abs(got - plain).max()) < 2e-6
    single = float(np.abs(_emulated_chain(x_ext, w1, w2, 1, 20, 16) - exact).max())
    assert single > 2e-6 * 10, single


# ---------------------------------------------------------------- bf16 mma


def _emulated_conv_bf16(a, w, d):
    """The bf16 arm of mma_tap_gemm (csrc/tile_mma.cuh) on bf16 operands
    ``a`` and ``w`` (held in f32): the (tap, 64-channel) chunks in order,
    each chunk's four 16-channel slices into fresh even (0, 2) and odd (1, 3)
    fragments, each mma an exact 16-product sum added to its fragment and
    rounded to f32, and the chunk's (even + odd) added to the f32 running
    sum."""
    taps, k, n = w.shape
    m = a.shape[0] - (taps - 1) * d
    kp = -(-k // 64) * 64  # zero slices add exact zeros to a fragment
    windows = np.zeros((m, taps, kp), np.float64)
    for j in range(taps):
        windows[:, j, :k] = a[j * d: j * d + m]
    wp = np.zeros((taps, kp, n), np.float64)
    wp[:, :k] = w
    steps = kp // 64
    sums = np.einsum("mtskc,tskcn->mtskn", windows.reshape(m, taps, steps, 4, 16),
                     wp.reshape(taps, steps, 4, 16, n))  # one mma's 16 exact products
    frag = []
    for parity in (0, 1):
        f = np.zeros((m, taps, steps, n), np.float32)
        for kk in (parity, parity + 2):
            f = (f.astype(np.float64) + sums[:, :, :, kk]).astype(np.float32)
        frag.append(f)
    step = frag[0] + frag[1]
    out = np.zeros((m, n), np.float32)
    for j in range(taps):
        for s in range(steps):
            out = out + step[:, j, s]
    return out


def _bf16_rne(a):
    """f32 -> bf16, to nearest even (as torch's .to(torch.bfloat16), JAX's
    astype and the kernels' __float2bfloat16_rn round), in f32."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x7FFF) + ((bits >> 16) & np.uint32(1)))
            & np.uint32(0xFFFF0000)).view(np.float32)


def _emulated_chain_bf16(x_ext, w1, w2, tile, cluster, gemm_errors=None):
    """The bf16-weight chain at the plan (tile, cluster): E = bf16(ELU(X))
    and H = bf16(ELU(conv1)) the windows, each block's columns from the
    full-width window, X f32. ``gemm_errors`` collects each GEMM's largest
    distance from its exact sum on the same operands, over its largest
    |output|."""
    c = x_ext.shape[1]
    halo = chain_halo(DILATIONS)
    nc = c // cluster
    t_out = x_ext.shape[0] - halo
    out = np.zeros((t_out, c), np.float32)

    def gemm(a, w, d):
        y = np.concatenate([_emulated_conv_bf16(a, w[:, :, r * nc:(r + 1) * nc], d)
                            for r in range(cluster)], axis=1)
        if gemm_errors is not None:
            m = a.shape[0] - (w.shape[0] - 1) * d
            exact = sum(a[j * d: j * d + m].astype(np.float64) @ w[j].astype(np.float64)
                        for j in range(w.shape[0]))
            gemm_errors.append(float(np.abs(y - exact).max() / np.abs(exact).max()))
        return y

    for t0 in range(0, t_out, tile):
        h = x_ext[t0: t0 + min(tile, t_out - t0) + halo].copy()
        for u, d in enumerate(DILATIONS):
            hh = _bf16_rne(_elu(gemm(_bf16_rne(_elu(h)), w1[u], d)))
            h = h[6 * d:] + gemm(hh, w2[u][None], 0)
        out[t0: t0 + h.shape[0]] = h
    return out


@pytest.mark.parametrize("c,rows,plans", [
    (32, 40, [(40, 1), (7, 4), (16, 8)]),   # one tap's 32 channels a chunk
    (64, 30, [(30, 1), (4, 16), (13, 2)]),
])
def test_the_bf16_chain_gives_the_same_bits_for_every_plan(c, rows, plans):
    """The bf16 arm's fold order depends on (tap, channel) alone, so tiles
    that recompute their halo and clusters that split the columns give the
    same bits."""
    rng = np.random.default_rng(5)
    x_ext, w1, w2 = _chain_operands(rng, c, rows, True)
    outs = [_emulated_chain_bf16(x_ext, w1, w2, tile, cluster) for tile, cluster in plans]
    for other in outs[1:]:
        assert np.array_equal(outs[0], other)


def test_bf16_e3_chain_gemms_are_within_1e6_of_their_exact_sums():
    """e3ch at one frame (C = 256, 20 rows, 1,792-term conv1 sums, 16
    blocks): each of the six GEMMs within 1e-6 of its largest |output| of
    the exact sum of the same bf16 operands. The chain against the plain
    version, which rounds at the same points but sums in another order, is
    further apart: where the two sums of an operand straddle a bf16
    rounding midpoint it rounds one bf16 step apart, and the step reaches
    the later units, whose operands then straddle other midpoints (1.6e-3
    of the largest |output| here, beyond CHAIN_ATOL). So on these dense
    weights chip_smoke.py holds the bf16-weight chain to its plain version
    by utils/checks.py::rounding_held, which this emulation meets, and at
    CHAIN_ATOL on exact-sum weights (the next test)."""
    rng = np.random.default_rng(7)
    x_ext, w1, w2 = _chain_operands(rng, 256, 20, True)
    errors = []
    got = _emulated_chain_bf16(x_ext, w1, w2, 20, 16, errors)
    assert len(errors) == 6 and max(errors) < 1e-6, errors
    ops = (torch.from_numpy(x_ext[:78]), torch.from_numpy(x_ext[78:]),
           torch.from_numpy(w1).to(torch.bfloat16), torch.from_numpy(w2).to(torch.bfloat16))
    plain = residual_chain_plain(*ops)
    held = rounding_held(torch.from_numpy(got), plain,
                         residual_chain_plain(*ops[:2], ops[2].float(), ops[3].float()))
    assert held["held"] and held["max_err"] > 2e-6, held


@pytest.mark.parametrize("c,rows,tile,cluster", [(256, 20, 20, 16), (64, 30, 13, 2)])
def test_bf16_chain_on_exact_sums_equals_the_plain_version(c, rows, tile, cluster):
    """On utils/checks.py::exact_sum_weights every sum is exact in any
    order, so the emulated bf16 arm rounds every operand to the same bits as
    the plain version: the two agree within CHAIN_ATOL (measured 0), where
    the plain version on unrounded operands lies far beyond it."""
    rng = np.random.default_rng(7)
    x_ext = (rng.standard_normal((chain_halo(DILATIONS) + rows, c)) * 0.3).astype(np.float32)
    w1 = exact_sum_weights(torch.empty(3, 7, c, c, dtype=torch.bfloat16), 1)
    w2 = exact_sum_weights(torch.empty(3, 1, c, c, dtype=torch.bfloat16), 2)[:, 0]
    got = _emulated_chain_bf16(x_ext, w1.float().numpy(), w2.float().numpy(), tile, cluster)
    xt = torch.from_numpy(x_ext)
    plain = residual_chain_plain(xt[:78], xt[78:], w1, w2).numpy()
    loose = residual_chain_plain(xt[:78], xt[78:], w1.float(), w2.float()).numpy()
    assert float(np.abs(got - plain).max()) <= CHAIN_ATOL
    assert float(np.abs(loose - plain).max()) >= 10 * CHAIN_ATOL
