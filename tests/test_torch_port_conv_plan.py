"""causal_conv's and causal_conv_transpose's planners, shared-memory
formulas and arithmetic, on the CPU.

The planner (ops/mega_kernel.py::_conv_plan) and its shared-memory formula
(conv_smem_bytes, equal to csrc/causal_conv.cu's dse_causal_conv_smem;
tests/test_torch_port_cuda.py holds the two equal on the card) are plain
Python, so they are held here at every causal_conv site of the denoiser, the
codec and the v0, v1 and v2 receivers, at every (streams, frames per
dispatch) chip_smoke.py dispatches. The GEMM arm's arithmetic is emulated in
numpy: split-TF32 products (TF32 rounding by bit masking, as cvt.rna
rounds; each mma an exact 8-product sum rounded to f32 into its step's
fresh chain), each 64-term chunk's value folded into the f32 running sum in
chunk order, whatever the blocks of a cluster each took. The emulation
shows the fold's bits do not depend on the split, and the error of e3d's
2,560-term sums against f64 well under chip_smoke.py's KERNEL_ATOL_F32
(1e-4), where a single TF32 pass would not meet it; the Cout = 1 arm's
224-term serial sums (v_out) likewise.

With bf16 x the arm stages bf16 rows and a few f32 side rows (the streams'
first rows, which may read the cache) and skips the a_lo pass of widened
bf16 values, which is zero: the bf16-x plans are held at every site, with
their shared memory; the f32-x picks to a table written out (the bf16-x
arm leaves them alone); the emulation shows a widened bf16 value's low TF32
part is zero (an activated one's is not) and that skipping the zero passes
keeps every chunk's bits.

causal_conv_transpose runs each of its s phases on the same GEMM arm, a
2-tap conv over the one-row cache whose rows land at s*r + p: its planner
(_upsample_plan, the GEMM arm's cost model with the phases in the grid) and
formula (the GEMM arm's at 2 taps, equal to dse_causal_conv_transpose_smem) are
held at every upsample site of the five models at every shape, and the
phase GEMM is emulated in numpy against causal_conv_transpose_plain at
d0u's 1,024-term sums (and v0u's, LeakyReLU on load).
"""

import os

import numpy as np
import pytest
import torch

from dl_speech_enhancement_tpu_torch.models import AudioDecGenerator, HiFiGANGenerator
from dl_speech_enhancement_tpu_torch.ops.mega_kernel import (
    _CONV_MAX_CLUSTER,
    _CONV_TILES,
    _CONV_TILES_F32X,
    _conv_plan,
    _gemm_cost,
    _upsample_plan,
    causal_conv_transpose_plain,
    conv_cache_rows,
    conv_chunks,
    conv_gemm_plans,
    conv_side_rows,
    conv_smem_bytes,
    conv_tile_dims,
)
from dl_speech_enhancement_tpu_torch.ops.stream_kernel import _MAX_SMEM
from dl_speech_enhancement_tpu_torch.ops.vocoder_kernel import conv_sites
from dl_speech_enhancement_tpu_torch.utils.config import load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAME = 1200
KERNEL_ATOL_F32 = 1e-4  # chip_smoke.py's kernel-vs-plain tolerance with f32 weights
# (streams, frames per dispatch): chip_smoke.py's one-stream sizes, its batch
# checks and timed shapes, the receivers' fleets, the v2 route and the CLI
SHAPES = [(b, n) for b in (1, 4, 16, 64) for n in (1, 8, 16, 100, 400)]


def _sites(model):
    """(name, Cin, Cout, taps, stride, output rows a frame) of every
    causal_conv launch of one dispatch of ``model``."""
    return [(n, c.in_channels, c.out_channels, c.kernel_size, c.stride, rows)
            for n, c, rows in conv_sites(model, FRAME)]


def _receiver(version):
    gp = dict(load_config(os.path.join(
        REPO, "configs", "vocoder", f"AudioDec_{version}_symAD_vctk_48000_hop300_clean.yaml"))
        ["generator_params"])
    gp.pop("nonlinear_activation")
    gp["negative_slope"] = gp.pop("nonlinear_activation_params")["negative_slope"]
    for key in ("use_weight_norm", "stats"):
        gp.pop(key)
    return HiFiGANGenerator(**gp, device="cpu")


def _upsamples(model):
    """(name, Cin, Cout, stride, input rows a frame) of every
    causal_conv_transpose launch of one dispatch of ``model``: a codec
    generator's decoder upsamples, or a HiFiGAN receiver's."""
    if isinstance(model, HiFiGANGenerator):
        prefix, layers, t = "v", list(model.upsamples), FRAME // model.total_upsample
    else:
        prefix, layers, t = "d", [blk.conv for blk in model.decoder.blocks], FRAME // model.hop
    out = []
    for i, layer in enumerate(layers):
        out.append((f"{prefix}{i}u", layer.in_channels, layer.out_channels, layer.stride, t))
        t *= layer.stride
    return out


@pytest.fixture(scope="module")
def models():
    gp = load_config(os.path.join(REPO, "configs", "autoencoder",
                                  "symAD_vctk_48000_hop300.yaml"))["generator_params"]
    out = {"denoiser": AudioDecGenerator(**gp, use_pqc=False, device="cpu"),
           "codec": AudioDecGenerator(**gp, use_pqc=True, device="cpu")}
    for version in ("v0", "v1", "v2"):
        out[version] = _receiver(version)
    return out


@pytest.fixture(scope="module")
def sites(models):
    return {path: _sites(model) for path, model in models.items()}


@pytest.fixture(scope="module")
def upsamples(models):
    return {path: _upsamples(model) for path, model in models.items()}


def _blocks(plan, batch, rows, cin, cout, taps):
    arm, tile, q = plan
    if arm != "gemm":
        return None
    bm, bn, _ = conv_tile_dims(tile)
    return -(-batch * rows // bm) * -(-cout // bn) * -(-len(conv_chunks(taps, cin)) // q)


@pytest.mark.parametrize("path", ["denoiser", "codec", "v0", "v1", "v2"])
def test_every_conv_plan_fits(sites, path):
    """Every site has a plan at every shape: the arm its widths ask for,
    shared memory within the card's 227 KB, a cluster of at most 8 blocks."""
    for name, cin, cout, taps, stride, rows in sites[path]:
        for batch, n in SHAPES:
            for bf16 in (False, True):
                arm, tile, q = plan = _conv_plan(batch, rows * n, cin, cout, taps, stride, 1,
                                                 bf16)
                assert arm == ("cin1" if cin == 1 else "cout1" if cout == 1 else "gemm"), name
                assert conv_smem_bytes(arm, tile, cin, cout, taps, stride, 1, q,
                                       bf16) <= _MAX_SMEM == 232448
                if arm == "gemm":
                    steps = len(conv_chunks(taps, cin))
                    assert 1 <= q <= steps and -(-steps // q) <= _CONV_MAX_CLUSTER, plan
                    assert conv_tile_dims(tile)[1] <= max(16, 2 * cout), plan
                    assert (tile, q) in [p[:2] for p in conv_gemm_plans(
                        cin, cout, taps, stride, 1, bf16)], plan
                elif arm == "cout1":
                    assert 1 <= tile <= 256


@pytest.mark.parametrize("site", ["e3d", "prj"])
def test_deep_sites_spread_over_32_sms_at_one_frame(sites, site):
    (_, cin, cout, taps, stride, rows), = [s for s in sites["codec"] if s[0] == site]
    for bf16 in (False, True):
        plan = _conv_plan(1, rows, cin, cout, taps, stride, 1, bf16)
        assert plan[2] < len(conv_chunks(taps, cin)), plan  # a cluster splits the steps
        assert _blocks(plan, 1, rows, cin, cout, taps) >= 32, plan


def test_the_chunk_cut_depends_on_the_layer_alone(sites):
    """The chunks are the layer's taps * Cin terms 64 at a time; a plan only
    groups consecutive chunks per block, so at every shape the runs of the
    cluster's blocks cover the chunks in order, each block at least one."""
    for path in ("codec", "v1"):
        for name, cin, cout, taps, stride, rows in sites[path]:
            chunks = conv_chunks(taps, cin)
            assert chunks[0][0] == 0 and chunks[-1][1] == taps * cin
            assert all(a[1] == b[0] and 0 < a[1] - a[0] <= 64 for a, b in zip(chunks, chunks[1:]))
            for batch, n in SHAPES:
                arm, _, q = _conv_plan(batch, rows * n, cin, cout, taps, stride, 1, True)
                if arm == "gemm":
                    runs = [chunks[r * q:(r + 1) * q] for r in range(-(-len(chunks) // q))]
                    assert [c for run in runs for c in run] == chunks and all(runs)


# ---------------------------------------------------------------- arithmetic


def _tf32(a):
    """cvt.rna.tf32.f32: the magnitude rounded to 10 mantissa bits, ties away."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _bf16(a):
    return ((np.ascontiguousarray(a, np.float32).view(np.uint32) + np.uint32(0x8000))
            & np.uint32(0xFFFF0000)).view(np.float32)


def _chunk_values(a, w, passes, skip_zero_lo=False):
    """Each 64-term chunk's value as the GEMM arm computes it: a (m, K) rows
    of terms, w (K, n); per 8-term slice the mma passes (1: single TF32; 2:
    a_hi*w + a_lo*w, bf16 weights; 3: + a_hi*w_lo, f32 weights) in that
    order, each an exact 8-product sum rounded to f32 into the chunk's fresh
    chain. With ``skip_zero_lo`` a 16-row fragment's a_lo*w pass is left out
    of a slice where all its a_lo are zero, as the bf16-x arm leaves it.
    Returns (chunks, m, n) f32."""
    m, k = a.shape
    kp = -(-k // 64) * 64  # zeros past K add nothing to a chain
    ap = np.zeros((m, kp), np.float32)
    ap[:, :k] = a
    wp = np.zeros((kp, w.shape[1]), np.float32)
    wp[:k] = w
    a_hi = _tf32(ap)
    a_lo = _tf32(ap - a_hi)
    w_hi = wp if passes == 2 else _tf32(wp)
    w_lo = _tf32(wp - w_hi)
    pairs = [(a_hi, w_hi), (a_lo, w_hi), (a_hi, w_lo)][:passes]
    out = []
    for g0 in range(0, k, 64):
        d = np.zeros((m, w.shape[1]), np.float32)
        for s in range(g0, min(k, g0 + 64), 8):
            for i, (x, y) in enumerate(pairs):
                part = x[:, s:s + 8].astype(np.float64) @ y[s:s + 8].astype(np.float64)
                new = (d.astype(np.float64) + part).astype(np.float32)
                if skip_zero_lo and i == 1:  # the fragments whose a_lo run the pass
                    runs = np.repeat((a_lo[:, s:s + 8] != 0).reshape(-1, 16, 8).any(axis=(1, 2)),
                                     16)
                    new = np.where(runs[:m, None], new, d)
                d = new
        out.append(d)
    return np.stack(out)


def _fold(values, q):
    """The kernel's fold for a cluster whose blocks take ``q`` chunks each:
    block 0's running sum of its run, then every later chunk's value, in
    chunk order (f32 adds)."""
    t = np.zeros(values.shape[1:], np.float32)
    for v in values[:q]:
        t = t + v
    for v in values[q:]:
        t = t + v
    return t


def _e3d_terms(rng, weight_bf16):
    """e3d (256 -> 512, k = 10, stride 5) at 16 rows: each output row's
    2,560 terms [x_ext[5t + j] for j < 10] (N(0, 1) activations) and the
    (2560, 512) weight at unit gain (bf16-rounded for bf16 weights)."""
    cin, cout, k, s, rows = 256, 512, 10, 5, 16
    x_ext = rng.standard_normal((s * (rows - 1) + k, cin)).astype(np.float32)
    a = np.stack([x_ext[s * t: s * t + k].reshape(-1) for t in range(rows)])
    w = (rng.standard_normal((k * cin, cout)) / np.sqrt(k * cin)).astype(np.float32)
    return a, _bf16(w) if weight_bf16 else w


@pytest.mark.parametrize("weight_bf16,passes", [(True, 2), (False, 3)])
def test_split_tf32_e3d_error_is_far_under_the_kernel_tolerance(weight_bf16, passes):
    a, w = _e3d_terms(np.random.default_rng(3), weight_bf16)
    assert a.shape[1] == 2560
    exact = a.astype(np.float64) @ w.astype(np.float64)
    values = _chunk_values(a, w, passes)
    got = _fold(values, len(values))
    err = float(np.abs(got - exact).max())
    assert err < KERNEL_ATOL_F32 / 20, err
    # a single TF32 pass would not hold the tolerance
    single = float(np.abs(_fold(_chunk_values(a, w, 1), len(values)) - exact).max())
    assert single > KERNEL_ATOL_F32, single


def test_the_fold_gives_the_same_bits_for_every_split():
    """e3d's 40 chunks folded by a cluster of 1-8 blocks (every split the
    planner may take) give the bits of one block's running sum."""
    a, w = _e3d_terms(np.random.default_rng(4), True)
    values = _chunk_values(a[:4], w[:, :64], 2)
    one = _fold(values, len(values))
    for n in range(2, _CONV_MAX_CLUSTER + 1):
        q = -(-len(values) // n)
        assert np.array_equal(_fold(values, q), one), q


def test_cout1_v_out_error_is_far_under_the_kernel_tolerance():
    """v_out (32 -> 1, k = 7, LeakyReLU(0.01) on load): each output row's 224
    products summed serially in (tap, channel) order with f32 fused
    multiply-adds, against f64."""
    rng = np.random.default_rng(5)
    cin, k, rows = 32, 7, 1200
    x_ext = rng.standard_normal((rows + k - 1, cin)).astype(np.float32) * 3
    x_ext = np.where(x_ext >= 0, x_ext, np.float32(0.01) * x_ext)
    w = _bf16((rng.standard_normal((k, cin)) / np.sqrt(k * cin)).astype(np.float32))
    acc = np.zeros(rows, np.float32)
    for j in range(k):
        for c in range(cin):  # fmaf: the exact product and sum, rounded once
            acc = (x_ext[j:j + rows, c].astype(np.float64) * w[j, c] + acc).astype(np.float32)
    exact = sum(x_ext[j:j + rows].astype(np.float64) @ w[j].astype(np.float64)
                for j in range(k))
    err = float(np.abs(acc - exact).max())
    assert err < KERNEL_ATOL_F32 / 20, err


# ---------------------------------------------------------------- upsamples


@pytest.mark.parametrize("path", ["denoiser", "codec", "v0", "v1", "v2"])
def test_every_upsample_plan_fits(upsamples, path):
    """Every upsample site has a GEMM-arm plan at every shape: one of the
    arm's plans for a 2-tap layer, shared memory within the card's 227 KB
    (the library's formula), a cluster of at most 8 blocks, no tile twice
    as wide as Cout, and a grid that covers the s phases."""
    assert [name for name, *_ in upsamples[path]] == [
        f"{'d' if path in ('denoiser', 'codec') else 'v'}{i}u" for i in range(4)]
    for name, cin, cout, stride, rows in upsamples[path]:
        steps = len(conv_chunks(2, cin))
        for batch, n in SHAPES:
            for bf16 in (False, True):
                tile, q = plan = _upsample_plan(batch, rows * n, cin, cout, stride, bf16)
                smem = conv_smem_bytes("gemm", tile, cin, cout, 2, 1, 1, q, bf16)
                assert smem <= _MAX_SMEM == 232448, (name, plan)
                assert (tile, q, smem) in conv_gemm_plans(cin, cout, 2, 1, 1, bf16), plan
                assert 1 <= q <= steps and -(-steps // q) <= _CONV_MAX_CLUSTER, plan
                assert conv_tile_dims(tile)[1] <= max(16, 2 * cout), plan
                bm, bn, _ = conv_tile_dims(tile)
                blocks = -(-batch * rows * n // bm) * -(-cout // bn) * -(-steps // q) * stride
                assert _gemm_cost(batch * rows * n, cin, cout, 2, tile, q, smem,
                                  stride)[1] == blocks


def test_the_upsample_cost_counts_the_phases():
    """The cost model puts the s phases in the grid: s times the blocks, and
    at many rows (waves of blocks) about s times the time."""
    for tile, q, smem in conv_gemm_plans(512, 256, 2, 1, 1, True):
        one_us, one = _gemm_cost(400, 512, 256, 2, tile, q, smem)
        five_us, five = _gemm_cost(400, 512, 256, 2, tile, q, smem, 5)
        assert five == 5 * one and five_us >= one_us


@pytest.mark.parametrize("site", ["d0u", "d1u"])
def test_deep_upsamples_spread_over_32_sms_at_one_frame(upsamples, site):
    (_, cin, cout, stride, rows), = [u for u in upsamples["codec"] if u[0] == site]
    for bf16 in (False, True):
        tile, q = _upsample_plan(1, rows, cin, cout, stride, bf16)
        bm, bn, _ = conv_tile_dims(tile)
        steps = len(conv_chunks(2, cin))
        assert -(-rows // bm) * -(-cout // bn) * -(-steps // q) * stride >= 32, (tile, q)


def _upsample_emulated(cache, x, w, b, stride, passes, q, leaky=None):
    """The kernel's causal_conv_transpose of one stream: x_ext = [cache; x]
    (LeakyReLU on load), and per phase p the GEMM of the rows' 2 * Cin terms
    [x_ext[r]; x_ext[r + 1]] against [Wc[s-1-p]; Wc[2s-1-p]] in 64-term
    chunks of split-TF32 products folded in order by a cluster whose blocks
    take ``q`` chunks each, plus the bias, written to row s*r + p."""
    h = np.concatenate([cache, x])
    if leaky is not None:
        h = np.where(h >= 0, h, np.float32(leaky) * h)
    a = np.concatenate([h[:-1], h[1:]], axis=1)
    y = np.empty((x.shape[0] * stride, w.shape[2]), np.float32)
    for p in range(stride):
        wp = np.concatenate([w[stride - 1 - p], w[2 * stride - 1 - p]])
        y[p::stride] = _fold(_chunk_values(a, wp, passes), q) + b
    return y


@pytest.mark.parametrize("weight_bf16,passes", [(True, 2), (False, 3)])
@pytest.mark.parametrize("leaky", [None, 0.1])
def test_split_tf32_upsample_matches_the_plain_version(weight_bf16, passes, leaky):
    """d0u (v0u with LeakyReLU(0.1) on load): 512 -> 256 at stride 5 over
    one frame's 4 rows, 1,024-term sums at unit-gain weights, within
    KERNEL_ATOL_F32 of causal_conv_transpose_plain; a single TF32 pass
    would not hold it."""
    rng = np.random.default_rng(9)
    cin, cout, stride, rows = 512, 256, 5, 4
    cache = rng.standard_normal((1, cin)).astype(np.float32)
    x = rng.standard_normal((rows, cin)).astype(np.float32) * (3 if leaky else 1)
    w = (rng.standard_normal((2 * stride, cin, cout)) / np.sqrt(2 * cin)).astype(np.float32)
    w = _bf16(w) if weight_bf16 else w
    b = rng.standard_normal(cout).astype(np.float32)
    ref = causal_conv_transpose_plain(torch.from_numpy(cache), torch.from_numpy(x),
                                      torch.from_numpy(w), torch.from_numpy(b), stride,
                                      leaky).numpy()
    got = _upsample_emulated(cache, x, w, b, stride, passes, 16, leaky)
    assert got.shape == ref.shape == (rows * stride, cout)
    err = float(np.abs(got - ref).max())
    assert err < KERNEL_ATOL_F32, err
    single = float(np.abs(_upsample_emulated(cache, x, w, b, stride, 1, 16, leaky)
                          - ref).max())
    assert single > err


def test_the_upsample_fold_gives_the_same_bits_for_every_split():
    """d0u's 16 chunks folded by a cluster of 1-8 blocks (every split the
    planner may take) give the bits of one block's running sum, so a
    stream's output does not depend on the plan."""
    rng = np.random.default_rng(10)
    cin, cout, stride = 512, 64, 5
    cache = rng.standard_normal((1, cin)).astype(np.float32)
    x = rng.standard_normal((4, cin)).astype(np.float32)
    w = _bf16((rng.standard_normal((2 * stride, cin, cout)) / np.sqrt(2 * cin))
              .astype(np.float32))
    b = np.zeros(cout, np.float32)
    one = _upsample_emulated(cache, x, w, b, stride, 2, 16)
    steps = len(conv_chunks(2, cin))
    for n in range(2, _CONV_MAX_CLUSTER + 1):
        q = -(-steps // n)
        assert np.array_equal(_upsample_emulated(cache, x, w, b, stride, 2, q), one), q


# ---------------------------------------------------------------- bf16 x


# The f32-x planner's picks (the bf16-x tiles and constants leave them
# alone): "path site w" (w 1: bf16 weights, 0: f32) -> the (tile, steps
# per block) at each SHAPES entry in order, each the tile's digit then the
# steps.
F32X_PICKS = {
    "13 23 23 33 33 23 33 33 33 33 23 33 33 33 33 33 33 33 33 33":
        ("denoiser e0d 1", "denoiser e0d 0", "codec e0d 1", "codec e0d 0", "v1 v2f 1",
         "v1 v2f 0"),
    "12 24 28 28 38 22 28 38 38 38 28 38 38 38 38 38 38 38 38 38":
        ("denoiser e1d 1", "denoiser e1d 0", "codec e1d 1", "codec e1d 0"),
    "13 24 27 220 320 23 27 220 320 320 27 320 220 320 320 220 220 320 320 320":
        ("denoiser e2d 1", "codec e2d 1"),
    "13 24 27 220 320 23 37 220 320 320 27 320 220 320 320 220 220 320 320 320":
        ("denoiser e2d 0", "codec e2d 0"),
    "15 25 25 240 340 15 210 220 340 240 25 240 240 240 240 220 340 340 240 240":
        ("denoiser e3d 1", "codec e3d 1"),
    "15 25 25 240 340 15 210 240 340 240 25 240 240 240 240 240 340 340 240 240":
        ("denoiser e3d 0", "codec e3d 0"),
    "03 13 13 23 25 03 13 23 25 224 13 23 26 224 324 23 212 224 324 224":
        ("codec prj 1",),
    "03 13 13 23 212 03 13 23 212 224 13 23 26 224 324 23 212 224 324 224":
        ("codec prj 0",),
    "11 12 21 27 37 11 22 24 37 37 21 27 27 37 37 24 37 37 37 37":
        ("codec dec_in 1", "codec dec_in 0", "v0 v_in 1", "v0 v_in 0", "v1 v_in 1", "v1 v_in 0"),
    "12 22 24 212 312 22 24 212 312 312 24 312 212 312 312 212 212 312 312 312":
        ("v1 v0f 1", "v1 v0f 0"),
    "12 23 26 26 36 22 26 36 36 36 26 36 36 36 36 36 36 36 36 36":
        ("v1 v1f 1", "v1 v1f 0"),
    "12 52 52 52 52 12 52 52 52 52 52 52 52 52 52 52 52 52 52 52":
        ("v1 v3f 1", "v1 v3f 0", "denoiser d3u 1", "denoiser d3u 0", "codec d3u 1",
         "codec d3u 0", "v0 v3u 1", "v0 v3u 0", "v1 v3u 1", "v1 v3u 0"),
    "11 11 12 24 27 11 21 22 27 37 12 24 27 37 37 22 27 37 37 37":
        ("v2 v_in 1", "v2 v_in 0"),
    "11 12 21 26 36 11 22 26 36 36 21 26 36 36 36 26 26 36 36 36":
        ("v2 v0f 1", "v2 v0f 0"),
    "11 13 23 33 33 13 23 23 33 33 23 33 33 33 33 23 33 33 33 33":
        ("v2 v1f 1", "v2 v1f 0"),
    "02 12 51 52 52 12 52 52 52 52 51 52 52 52 52 52 52 52 52 52":
        ("v2 v2f 1", "v2 v2f 0", "v2 v2u 1", "v2 v2u 0"),
    "01 01 01 01 01 01 01 01 01 01 01 01 01 01 01 01 01 01 01 01":
        ("v2 v3f 1", "v2 v3f 0", "v2 v3u 1", "v2 v3u 0"),
    "23 23 26 216 316 23 26 216 316 316 26 316 216 316 316 216 216 316 316 316":
        ("denoiser d0u 1", "codec d0u 1", "v0 v0u 1", "v1 v0u 1"),
    "23 23 26 216 316 23 216 216 316 316 26 316 216 316 316 216 216 316 316 316":
        ("denoiser d0u 0", "codec d0u 0", "v0 v0u 0", "v1 v0u 0"),
    "21 24 28 28 38 22 28 38 38 38 28 38 38 38 38 38 38 38 38 38":
        ("denoiser d1u 1", "denoiser d1u 0", "codec d1u 1", "codec d1u 0", "v0 v1u 1",
         "v0 v1u 0", "v1 v1u 1", "v1 v1u 0"),
    "14 24 24 34 34 24 34 34 34 34 24 34 34 34 34 34 34 34 34 34":
        ("denoiser d2u 1", "denoiser d2u 0", "codec d2u 1", "codec d2u 0", "v0 v2u 1",
         "v0 v2u 0", "v1 v2u 1", "v1 v2u 0"),
    "12 21 22 28 38 12 23 28 38 38 22 28 38 38 38 28 28 38 38 38":
        ("v2 v0u 1", "v2 v0u 0"),
    "11 14 24 34 34 14 24 24 34 34 24 34 34 34 34 24 34 34 34 34":
        ("v2 v1u 1", "v2 v1u 0"),
}


def test_the_f32x_picks_are_unchanged(sites, upsamples):
    got = {}
    for path in sites:
        for name, cin, cout, taps, stride, rows in sites[path]:
            if cin > 1 and cout > 1:
                for bf16 in (True, False):
                    got[f"{path} {name} {int(bf16)}"] = " ".join(
                        "%d%d" % _conv_plan(b, rows * n, cin, cout, taps, stride, 1, bf16)[1:]
                        for b, n in SHAPES)
        for name, cin, cout, stride, rows in upsamples[path]:
            for bf16 in (True, False):
                got[f"{path} {name} {int(bf16)}"] = " ".join(
                    "%d%d" % _upsample_plan(b, rows * n, cin, cout, stride, bf16)
                    for b, n in SHAPES)
    assert got == {key: picks for picks, keys in F32X_PICKS.items() for key in keys}


def _bf16x_ring(tile, cin, cout, taps, stride, q, t_out):
    """The bf16-x GEMM block's shared memory, written out: per ring stage
    the tile's rows in bf16 (144-byte rows), its side rows in f32 (272-byte
    rows) and the bf16 weights' rows (BN + 16 columns, 48 at BN = 16); the
    cluster's f32 slots."""
    bm, bn, _ = conv_tile_dims(tile)
    side = conv_side_rows(bm, t_out, conv_cache_rows(taps, stride, 1))
    a_stage = 2 * bm * 72 + 4 * side * 68
    ldw = 48 if bn == 16 else bn + 16
    split = q < len(conv_chunks(taps, cin))
    return min(3, q) * (a_stage + 64 * ldw * 2) + (4 * q * bm * bn if split else 0), \
        a_stage, 4 * bm * 68


@pytest.mark.parametrize("path", ["denoiser", "codec"])
@pytest.mark.parametrize("batch,n", [(64, 16), (16, 16)])
def test_every_bf16x_site_of_the_dispatches_has_a_plan(sites, upsamples, path, batch, n):
    """At bf16 launch boundaries every GEMM site (the downsamples, with PQC
    the projector and the decoder's input conv, and the four upsamples) has
    a bf16-x plan whose block fits the card, whose shared memory counts the
    bf16 A stage (with a few f32 side rows: a stream's first rows), under
    the f32 stage it replaces."""
    cases = [(name, cin, cout, taps, stride, rows * n, 1)
             for name, cin, cout, taps, stride, rows in sites[path] if cin > 1 and cout > 1]
    cases += [(name, cin, cout, 2, 1, rows * n, stride)
              for name, cin, cout, stride, rows in upsamples[path]]
    assert len(cases) == (6 if path == "codec" else 4) + 4
    for name, cin, cout, taps, stride, t_out, phases in cases:
        if phases == 1:
            arm, tile, q = _conv_plan(batch, t_out, cin, cout, taps, stride, 1, True, True)
            assert arm == "gemm", name
        else:
            tile, q = _upsample_plan(batch, t_out, cin, cout, phases, True, True)
        smem = conv_smem_bytes("gemm", tile, cin, cout, taps, stride, 1, q, True, True, t_out)
        assert (tile, q, smem) in conv_gemm_plans(cin, cout, taps, stride, 1, True, True, t_out)
        ring, a_stage, f32_stage = _bf16x_ring(tile, cin, cout, taps, stride, q, t_out)
        assert smem == ring <= _MAX_SMEM, (name, tile, q)
        assert a_stage < f32_stage, (name, tile)


@pytest.mark.parametrize("path", ["denoiser", "codec", "v0", "v1", "v2"])
def test_every_bf16x_plan_fits(sites, upsamples, path):
    """Every GEMM site and upsample site has a bf16-x plan at every shape:
    one of the arm's plans (its own tile with bf16 weights alone) within the
    card's shared memory, a cluster of at most 8 blocks."""
    for name, cin, cout, taps, stride, rows in sites[path]:
        if cin == 1 or cout == 1:
            continue
        for batch, n in SHAPES:
            for bf16 in (False, True):
                arm, tile, q = _conv_plan(batch, rows * n, cin, cout, taps, stride, 1, bf16, True)
                assert arm == "gemm" and -(-len(conv_chunks(taps, cin)) // q) <= 8
                assert tile < (len(_CONV_TILES) if bf16 else _CONV_TILES_F32X)
                assert (tile, q) in [p[:2] for p in conv_gemm_plans(
                    cin, cout, taps, stride, 1, bf16, True, rows * n)]
    for name, cin, cout, stride, rows in upsamples[path]:
        for batch, n in SHAPES:
            for bf16 in (False, True):
                tile, q = _upsample_plan(batch, rows * n, cin, cout, stride, bf16, True)
                assert conv_smem_bytes("gemm", tile, cin, cout, 2, 1, 1, q, bf16, True,
                                       rows * n) <= _MAX_SMEM


def _side_slot(m, m0, bm, t_out, q, rows):
    """csrc/conv_gemm.cuh's side slot of row m in the tile at m0 (-1: x alone)."""
    b, t = divmod(m, t_out)
    if m >= rows or t >= q:
        return -1
    if conv_side_rows(bm, t_out, q) == bm:
        return m - m0
    return (b - m0 // t_out) * min(q, t_out) + t


def test_the_side_slots_fit_the_side_stage():
    """Every row of a tile that may read the cache (t < Q) has its own slot
    within the side stage, whatever the tile size, rows a stream and Q; the
    other rows none."""
    for bm in (16, 32, 64, 128, 256):
        for t_out in (1, 2, 3, 4, 7, 20, 64, 100, 400):
            for q in (0, 1, 2, 3, 6):
                rows = t_out * max(1, -(-3 * bm // t_out)) - (t_out > 1)
                side = conv_side_rows(bm, t_out, q)
                for m0 in range(0, rows, bm):
                    slots = [_side_slot(m, m0, bm, t_out, q, rows) for m in range(m0, m0 + bm)]
                    taken = [s for s in slots if s >= 0]
                    assert all(0 <= s < side for s in taken), (bm, t_out, q, m0)
                    assert len(set(taken)) == len(taken)
                    assert len(taken) == sum(1 for m in range(m0, min(m0 + bm, rows))
                                             if m % t_out < q)


def test_a_widened_bf16_value_has_no_low_tf32_part():
    """TF32's 10 mantissa bits hold bf16's 7: the split of a widened bf16
    value is the value and a zero low part, over many magnitudes."""
    rng = np.random.default_rng(11)
    v = _bf16(rng.standard_normal(1 << 16).astype(np.float32)
              * np.float32(2.0) ** rng.integers(-40, 40, 1 << 16).astype(np.float32))
    v = np.concatenate([v, _bf16(np.float32([0.0, -0.0, 1.0, -3.0e38, 1e-30]))])
    hi = _tf32(v)
    assert np.array_equal(hi, v)
    assert not np.any(_tf32(v - hi))


def test_a_leaky_bf16_value_keeps_its_low_tf32_part():
    """LeakyReLU(0.1) of a negative bf16 value is not bf16-exact: its low
    TF32 part is nonzero for most values (0.8 of these), so an activated
    fragment keeps its a_lo pass (the receivers' upsamples)."""
    rng = np.random.default_rng(12)
    v = -np.abs(_bf16(rng.standard_normal(4096).astype(np.float32)))
    y = np.float32(0.1) * v
    lo = _tf32(y - _tf32(y))
    assert np.mean(lo != 0) > 0.5


@pytest.mark.parametrize("weight_bf16,passes", [(True, 2), (False, 3)])
def test_skipping_zero_low_passes_keeps_the_bits(weight_bf16, passes):
    """e2d's 1,280-term sums over three 16-row fragments: widened bf16 rows
    (every slice's a_lo pass skipped), bf16 rows with two random f32 cache
    rows among them (skipped in no slice), and LeakyReLU(0.1) of bf16 rows.
    Each chunk's value with the zero passes skipped equals its value with
    them bit for bit, and so does the fold of every cluster split."""
    rng = np.random.default_rng(13)
    k, cout = 1280, 64
    a = _bf16(rng.standard_normal((48, k)).astype(np.float32))
    a[18:20] = rng.standard_normal((2, k)).astype(np.float32)  # the cache rows
    a[32:] = np.where(a[32:] >= 0, a[32:], np.float32(0.1) * a[32:])
    w = (rng.standard_normal((k, cout)) / np.sqrt(k)).astype(np.float32)
    w = _bf16(w) if weight_bf16 else w
    lo = _tf32(a - _tf32(a))
    by_slice = (lo != 0).reshape(3, 16, k // 8, 8).any(axis=(1, 3))
    assert not by_slice[0].any() and by_slice[1].all() and by_slice[2].all()
    full = _chunk_values(a, w, passes)
    skipped = _chunk_values(a, w, passes, skip_zero_lo=True)
    assert np.array_equal(full.view(np.uint32), skipped.view(np.uint32))
    for n in range(1, _CONV_MAX_CLUSTER + 1):
        q = -(-len(full) // n)
        assert np.array_equal(_fold(full, q), _fold(skipped, q)), q
