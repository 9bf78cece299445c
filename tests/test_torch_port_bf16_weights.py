"""The port at bf16 weights against the JAX package's kernels on the CPU.

The JAX kernels multiply bf16 by bf16 when their weights are bf16: every
matmul is ``jnp.dot(a.astype(wd), w, preferred_element_type=f32)``, so each
conv's activated operand is rounded to bf16 before the product and the sum
stays f32 (ops/stream_kernel.py:78,84; ops/mega_kernel.py:356-414, 562-620;
ops/vocoder_kernel.py:285-738; ops/mega_stacked.py; ops/vocoder_stacked.py).
The port's plain versions round at the same points
(ops/stream_kernel.py::mma_operand). Each test first shows the gap that an
f32 operand leaves (the port's arithmetic before it rounded: ``mma_operand``
patched to the identity in every module), then holds the port to JAX in
interpret mode at ``weight_dtype=bfloat16``, with a tolerance at least 10x
under that gap.

Tolerances, each measured at these seeds:
- a kernel alone (chain, conv, transposed conv, unit): 1e-5 of the largest
  output. With the operands rounded alike the products are the same exact
  bf16 products and only the f32 sums' order differs (measured at most
  4.8e-7 of it, the chain at C = 64, T = 100); an f32 operand leaves
  ~1e-3 of it.
- whole streams (denoiser, codec, vocoder; K3b at f32 boundaries): 1e-4 of
  the largest sample. Rounded operands are a discontinuous function of the
  sums before them: where two sum orders straddle a bf16 rounding midpoint
  the operand moves by one bf16 step, and the step reaches the layers after
  it, whose operands may then straddle other midpoints. At these sizes no
  such cascade starts (measured at most 1.2e-5 of the largest sample; an
  f32 operand leaves ~1e-2); at others one can: K3b at two streams (the
  same seed) lands 2.8e-3 of it from JAX, against the f32 operand's 4.8e-3
  (see test_rounded_operands_amplify_an_ulp, and the K5 case below).
- K3b at bf16 boundaries: the port rounds its activations at its launch
  boundaries, JAX at its stages' (tests/test_torch_port_boundary.py), and
  that difference is as large as the f32 operand's own gap. There the test
  holds the port to JAX within the boundary tests' 0.05 of the largest
  sample and requires the rounded operands to bring it closer to JAX than
  the f32 operands do.
- K5: its rounding points amplify a one-ulp change of the sums before them
  (the port's own stream moves by 1.7e-3 of the largest sample when its
  operands are jittered by one f32 ulp before they round:
  test_rounded_operands_amplify_an_ulp), and JAX's K4 and
  K5, which round their upsamples at different points, differ by 8.5e-3 of
  it. The port with K5's rounding is held within 0.05 of the largest sample
  of K5 and closer to it than the port with f32 operands or with K4's
  rounding.

What the dense-weight cases rest on: at these seeds some rounded operands
lie within an f32 ulp or two of a bf16 rounding midpoint (10 of the
chain's 59,520 at C = 64, T = 100; 6 of 18,240 at C = 32, T = 40), and
XLA's and PyTorch's CPU sums agree in the bits that decide them, so no
operand rounds apart. That agreement is the two libraries', not the
port's: one that summed in another order could move such an operand one
bf16 step and fail a dense case by ~1e-3 of the largest output with no
change to the port (test_rounded_operands_amplify_an_ulp shows how far a
step reaches). The exact-sum cases do not rest on it: on
``utils/checks.py::exact_sum_weights`` (one nonzero term a column, so every
sum is exact in any order) the chain, the unit and the vocoder's upsample
equal JAX bit for bit (measured 0) and are held within EXACT_RTOL, 1e-6 of
the largest output, against an f32 operand's gap of 2.4e-3 to 5.0e-3.

Codes (PQC): equal to JAX's up to near ties (``utils/checks.py::
rvq_near_ties`` on the port's z); the audio is held when the codes are
equal.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dl_speech_enhancement_tpu.ops.mega_kernel import (
    _rep_matrix,
    _sel_matrix,
    make_mega_stream as jax_mega,
)
from dl_speech_enhancement_tpu.ops.mega_stacked import (
    make_mega_stream_stacked as jax_stacked,
)
from dl_speech_enhancement_tpu.ops.stream_kernel import fused_residual_chain as jax_chain
from dl_speech_enhancement_tpu.ops.vocoder_kernel import (
    _dot,
    _leaky as jax_leaky,
    _tap_conv,
    make_mega_vocoder as jax_mega_vocoder,
)
from dl_speech_enhancement_tpu.ops.vocoder_stacked import (
    make_stacked_vocoder as jax_stacked_vocoder,
)
from dl_speech_enhancement_tpu_torch.ops import mega_kernel, stream_kernel, vocoder_kernel
from dl_speech_enhancement_tpu_torch.ops.mega_kernel import (
    causal_conv_plain,
    causal_conv_transpose_plain,
    make_mega_stream,
    rvq_assign_plain,
    vq_tables,
)
from dl_speech_enhancement_tpu_torch.ops.mega_stacked import make_mega_stream_stacked
from dl_speech_enhancement_tpu_torch.ops.stream_kernel import (
    chain_weights,
    fused_residual_chain_folded_plain,
    residual_chain_plain,
)
from dl_speech_enhancement_tpu_torch.ops.vocoder_kernel import (
    hifigan_unit_plain,
    make_mega_vocoder,
)
from dl_speech_enhancement_tpu_torch.ops.vocoder_stacked import make_stacked_vocoder
from dl_speech_enhancement_tpu_torch.utils.checks import exact_sum_weights, rvq_near_ties
from test_torch_port_batched import _jnp_tree, _pair
from test_torch_port_hifigan import MGC
from test_torch_port_kernels import _chain_pair
from test_torch_port_vocoder import _vocoders
from torch_port_threads import one_thread  # noqa: F401

BF16, F32 = torch.bfloat16, torch.float32
KERNEL_RTOL = 1e-5   # of the largest output: one kernel, the sums' order alone
EXACT_RTOL = 1e-6    # of the largest output: one kernel on exact-sum weights
STREAM_RTOL = 1e-4   # of the largest sample: a stream, rounding points chained
BOUNDARY_RTOL = 0.05  # tests/test_torch_port_boundary.py, tests/test_mega_stacked.py:163
GAP = 10  # each tolerance at least this far under the f32 operand's gap


@pytest.fixture
def f32_operands(monkeypatch):
    """A context in which the port multiplies f32 operands by its bf16
    weights, as it did before it rounded them: ``mma_operand`` is the
    identity in every module that calls it."""

    class Patch:
        def __enter__(self):
            for mod in (stream_kernel, mega_kernel, vocoder_kernel):
                monkeypatch.setattr(mod, "mma_operand", lambda a, wd: a)

        def __exit__(self, *exc):
            monkeypatch.undo()

    return Patch()


def _hold(got, ref, old, rtol):
    """``got`` within ``rtol`` of the largest |ref| of ``ref``, where the
    f32-operand result ``old`` is at least GAP times further."""
    got, ref, old = (np.asarray(t, np.float64) for t in (got, ref, old))
    scale = float(np.abs(ref).max())
    err, gap = float(np.abs(got - ref).max()), float(np.abs(old - ref).max())
    assert gap >= GAP * rtol * scale, (gap, rtol * scale)
    assert err <= rtol * scale, (err, rtol * scale, gap)


# ---------------------------------------------------------------- kernels


@pytest.mark.parametrize("channels,rows", [(64, 100), (32, 40)])
def test_residual_chain_plain_rounds_as_jax(rng, f32_operands, channels, rows):
    jps, tunits = _chain_pair(channels)
    x = rng.standard_normal((78 + rows, channels)).astype(np.float32)
    ref = np.asarray(jax_chain(jps, jnp.asarray(x), interpret=True, weight_dtype=jnp.bfloat16))
    w1, w2 = chain_weights(tunits, BF16)
    xt = torch.from_numpy(x)
    got = residual_chain_plain(xt[:78], xt[78:], w1, w2)
    with f32_operands:
        old = residual_chain_plain(xt[:78], xt[78:], w1, w2)
    _hold(got, ref, old, KERNEL_RTOL)
    # the folded form rounds at the same points (folding moves rows, not values)
    folded = fused_residual_chain_folded_plain(tunits, xt, 2, weight_dtype=BF16)
    np.testing.assert_allclose(folded.numpy(), got.numpy(), atol=KERNEL_RTOL * np.abs(ref).max())


def test_residual_chain_plain_rounds_as_jax_on_exact_sums(rng, f32_operands):
    """As above on utils/checks.py::exact_sum_weights, where every sum is
    exact in any order: the rounded operands are the same bits on both
    sides whatever order either library sums in."""
    channels, rows = 64, 100
    w1 = exact_sum_weights(torch.empty(3, 7, channels, channels, dtype=BF16), 1)
    w2 = exact_sum_weights(torch.empty(3, 1, channels, channels, dtype=BF16), 2)
    jps = [{"conv1": {"w": _jnp_w(w1[u])}, "conv2": {"w": _jnp_w(w2[u])}} for u in range(3)]
    x = rng.standard_normal((78 + rows, channels)).astype(np.float32)
    ref = np.asarray(jax_chain(jps, jnp.asarray(x), interpret=True, weight_dtype=jnp.bfloat16))
    xt = torch.from_numpy(x)
    got = residual_chain_plain(xt[:78], xt[78:], w1, w2[:, 0])
    with f32_operands:
        old = residual_chain_plain(xt[:78], xt[78:], w1, w2[:, 0])
    _hold(got, ref, old, EXACT_RTOL)


def _bf16_weights(rng, *shape, scale):
    w = (rng.standard_normal(shape) * scale).astype(np.float32)
    return torch.from_numpy(w).to(BF16)


def _jnp_w(w):
    return jnp.asarray(w.float().numpy()).astype(jnp.bfloat16)


@pytest.mark.parametrize("cin,cout,k,dilation,leaky", [(24, 40, 7, 1, None), (32, 16, 7, 3, 0.1),
                                                        (16, 1, 7, 1, 0.01), (1, 32, 7, 1, None)])
def test_causal_conv_plain_rounds_as_jax_tap_conv(rng, f32_operands, cin, cout, k, dilation,
                                                  leaky):
    """The stride-1 sites (input, projector, decoder input, fuse and output
    convs) as JAX K4's ``_tap_conv(v.astype(wd), ...)`` computes them
    (ops/vocoder_kernel.py:285, 738)."""
    pad, rows = (k - 1) * dilation, 30
    v = rng.standard_normal((pad + rows, cin)).astype(np.float32)
    w = _bf16_weights(rng, k, cin, cout, scale=(k * cin) ** -0.5)
    b = torch.from_numpy(rng.standard_normal(cout).astype(np.float32))
    a = jnp.asarray(v) if leaky is None else jax_leaky(jnp.asarray(v), leaky)
    ref = _tap_conv(a.astype(jnp.bfloat16), _jnp_w(w), rows, k, dilation, jnp.asarray(b))
    vt = torch.from_numpy(v)
    got = causal_conv_plain(vt[:pad], vt[pad:], w, b, 1, dilation, leaky)
    with f32_operands:
        old = causal_conv_plain(vt[:pad], vt[pad:], w, b, 1, dilation, leaky)
    _hold(got, ref, old, KERNEL_RTOL)


@pytest.mark.parametrize("stride", [2, 5])
def test_strided_conv_plain_rounds_the_selected_rows_as_jax(rng, f32_operands, stride):
    """A downsample: JAX selects the rows of each phase with a 0/1 matmul in
    f32, then rounds them (``dot(d_sel, v).astype(wd)``,
    ops/mega_kernel.py:405); rounding the selected rows equals rounding the
    input rows, which the port does."""
    cin, cout, t_out = 16, 24, 12
    k, ctx = 2 * stride, 2 * stride - 1
    v = rng.standard_normal((ctx + stride * t_out, cin)).astype(np.float32)
    w = _bf16_weights(rng, k, cin, cout, scale=(k * cin) ** -0.5)
    b = torch.from_numpy(rng.standard_normal(cout).astype(np.float32))
    d_sel, wj = jnp.asarray(_sel_matrix(t_out, stride)), _jnp_w(w)
    ref = None
    for p in range(stride):
        g = _dot(d_sel, jnp.asarray(v)[p: p + stride * t_out + 1]).astype(jnp.bfloat16)
        t = _dot(g[0:t_out], wj[p]) + _dot(g[1:t_out + 1], wj[stride + p])
        ref = t if ref is None else ref + t
    ref = ref + jnp.asarray(b)
    vt = torch.from_numpy(v)
    got = causal_conv_plain(vt[:ctx], vt[ctx:], w, b, stride)
    with f32_operands:
        old = causal_conv_plain(vt[:ctx], vt[ctx:], w, b, stride)
    _hold(got, ref, old, KERNEL_RTOL)


@pytest.mark.parametrize("vocoder", [False, True])
def test_causal_conv_transpose_plain_rounds_as_jax(rng, f32_operands, vocoder):
    """An upsample as JAX computes it per phase (ops/mega_kernel.py:575-590,
    ops/vocoder_kernel.py:316-326): the input rows rounded, the phase's
    product ``yp`` replicated by a 0/1 matmul, and in the vocoder (K4) ``yp``
    rounded to bf16 first, before the bias (``rounding="product"``)."""
    _upsample_case(rng, f32_operands, vocoder, False)


def test_causal_conv_transpose_product_rounds_as_jax_on_exact_sums(rng, f32_operands):
    """The vocoder's upsample as above on exact_sum_weights (one term of each
    phase's tap pair a column): ``yp`` is exact on both sides, so its
    rounding is the same bits whatever order either library sums in."""
    _upsample_case(rng, f32_operands, True, True)


def _upsample_case(rng, f32_operands, vocoder, exact):
    cin, cout, s, t_in = 24, 16, 4, 10
    v = rng.standard_normal((1 + t_in, cin)).astype(np.float32)
    w = _bf16_weights(rng, 2 * s, cin, cout, scale=(2 * cin) ** -0.5)
    if exact:
        w = exact_sum_weights(w, 5, [(s - 1 - p, 2 * s - 1 - p) for p in range(s)])
    b = torch.from_numpy(rng.standard_normal(cout).astype(np.float32))
    slope = 0.1 if vocoder else None
    a = jnp.asarray(v) if slope is None else jax_leaky(jnp.asarray(v), slope)
    vw, wj, urep = a.astype(jnp.bfloat16), _jnp_w(w), jnp.asarray(_rep_matrix(t_in, s))
    ref = 0.0
    for p in range(s):
        yp = _dot(vw[0:t_in], wj[s - 1 - p]) + _dot(vw[1:t_in + 1], wj[2 * s - 1 - p])
        rp = _dot(urep.astype(jnp.bfloat16), yp.astype(jnp.bfloat16)) if vocoder \
            else _dot(urep, yp)
        ref = ref + jnp.where((jnp.arange(s * t_in)[:, None] % s) == p, rp, 0.0)
    ref = ref + jnp.asarray(b)
    vt = torch.from_numpy(v)
    rounding = "product" if vocoder else None
    got = causal_conv_transpose_plain(vt[:1], vt[1:], w, b, s, slope, rounding)
    with f32_operands:
        old = causal_conv_transpose_plain(vt[:1], vt[1:], w, b, s, slope, rounding)
    _hold(got, ref, old, EXACT_RTOL if exact else KERNEL_RTOL)
    if vocoder:  # the product's rounding is a point of its own
        plain = causal_conv_transpose_plain(vt[:1], vt[1:], w, b, s, slope)
        assert float((plain - got).abs().max()) > 0


@pytest.mark.parametrize("groups,tiled,dilation", [(3, True, 1), (3, False, 3), (1, False, 5)])
def test_hifigan_unit_plain_rounds_as_jax(rng, f32_operands, groups, tiled, dilation):
    """One unit as JAX K4's add_resunit body computes it, group by group
    (ops/vocoder_kernel.py:379-390): ``_tap_conv(leaky(x_ext1).astype(wd))``,
    then ``_tap_conv(leaky(h_ext).astype(wd))`` over conv2's cached rows."""
    _unit_case(rng, f32_operands, groups, tiled, dilation, False)


@pytest.mark.parametrize("groups,tiled,dilation", [(3, True, 1), (1, False, 5)])
def test_hifigan_unit_plain_rounds_as_jax_on_exact_sums(rng, f32_operands, groups, tiled,
                                                        dilation):
    """As above on exact_sum_weights: conv1's sums are exact on both sides,
    so leaky(h) rounds to the same bits whatever order either library sums
    in."""
    _unit_case(rng, f32_operands, groups, tiled, dilation, True)


def _unit_case(rng, f32_operands, groups, tiled, dilation, exact):
    c, k, rows, slope = 16, 5, 24, 0.1
    cin = c if tiled else groups * c
    p1, p2 = (k - 1) * dilation, k - 1
    x_ext = rng.standard_normal((p1 + rows, cin)).astype(np.float32)
    cache2 = jax_leaky(jnp.asarray(rng.standard_normal((p2, groups * c)).astype(np.float32)),
                       slope)
    w1 = _bf16_weights(rng, k, c, groups * c, scale=(k * c) ** -0.5)
    w2 = _bf16_weights(rng, k, c, groups * c, scale=(k * c) ** -0.5)
    if exact:
        w1, w2 = exact_sum_weights(w1, 3), exact_sum_weights(w2, 4)
    b1, b2 = (torch.from_numpy(rng.standard_normal(groups * c).astype(np.float32))
              for _ in range(2))
    a = jax_leaky(jnp.asarray(x_ext), slope)
    outs = []
    for g in range(groups):
        cols = slice(g * c, (g + 1) * c)
        a_g = a if tiled else a[:, cols]
        xt = _tap_conv(a_g.astype(jnp.bfloat16), _jnp_w(w1)[:, :, cols], rows, k, dilation,
                       jnp.asarray(b1)[cols])
        v2 = jnp.concatenate([cache2[:, cols], jax_leaky(xt, slope)])
        y = _tap_conv(v2.astype(jnp.bfloat16), _jnp_w(w2)[:, :, cols], rows, k, 1,
                      jnp.asarray(b2)[cols])
        outs.append(y + (jnp.asarray(x_ext[p1:]) if tiled else jnp.asarray(x_ext[p1:, cols])))
    ref = jnp.concatenate(outs, axis=-1)
    xt_ = torch.from_numpy(x_ext)
    c2 = torch.from_numpy(np.array(cache2))
    args = (xt_[:p1], c2, xt_[p1:], w1, b1, w2, b2, dilation, groups, slope)
    got, new2 = hifigan_unit_plain(*args)
    with f32_operands:
        old, _ = hifigan_unit_plain(*args)
    _hold(got, ref, old, EXACT_RTOL if exact else KERNEL_RTOL)
    # the next conv2 cache is the activated h in f32, not its rounded copy
    assert not torch.equal(new2, new2.to(BF16).float())


# ---------------------------------------------------------------- streams


def _recording_search(monkeypatch, seen):
    def recording(z, *tables):
        seen.append(z)
        return rvq_assign_plain(z, *tables[:2])

    monkeypatch.setattr(mega_kernel, "rvq_assign", recording)


@pytest.mark.parametrize("use_pqc", [False, True])
def test_mega_stream_bf16_weights_match_jax_interpret(rng, monkeypatch, f32_operands, use_pqc):
    """The small denoiser and codec, three frames of one stream, against
    JAX K2 at bf16 weights in interpret mode."""
    jgen, params, vq, tgen, tvq = _pair(use_pqc, seed=31 + use_pqc)
    chunk = jgen.hop * 2
    frames = (rng.standard_normal((3, chunk)) * 0.3).astype(np.float32)
    jinit, jrun = jax_mega(jgen, params, chunk, weight_dtype=jnp.bfloat16, interpret=True,
                           vq_state=_jnp_tree(vq) if use_pqc else None)
    ref, _, *ref_codes = jrun(jinit(), jnp.asarray(frames))
    seen = []
    _recording_search(monkeypatch, seen)
    init, run = make_mega_stream(tgen, chunk, BF16, tvq)
    got, _, *codes = run(init(), torch.from_numpy(frames))
    with f32_operands:
        _recording_search(monkeypatch, [])
        old = run(init(), torch.from_numpy(frames))[0]
    if use_pqc:
        books, sqnorm, _ = vq_tables(tvq, "cpu")
        z = torch.cat(seen)
        held = rvq_near_ties(z, books, sqnorm, codes[0].reshape(z.shape[0], -1),
                             torch.from_numpy(np.asarray(ref_codes[0])).reshape(z.shape[0], -1))
        assert held["mismatches"] == 0, held
        assert held["ties"] == 0, "a near tie moved a frame's audio: compare the codes only"
    _hold(got, ref, old, STREAM_RTOL)


def test_mega_vocoder_bf16_weights_match_jax_interpret(rng, f32_operands):
    """The small MultiGroupConv1d receiver, four frames in two dispatches,
    against JAX K4 at bf16 weights in interpret mode."""
    jv, p, tv = _vocoders(MGC, seed=33)
    chunk = 3 * jv.total_upsample
    zq = rng.standard_normal((4, 3, 8)).astype(np.float32)
    jinit, jrun = jax_mega_vocoder(jv, p, chunk, weight_dtype=jnp.bfloat16, interpret=True)
    ref, _ = jrun(jinit(), jnp.asarray(zq))

    def port():
        init, run = make_mega_vocoder(tv, chunk, BF16)
        first, cache = run(init(), torch.from_numpy(zq[:2]))
        return torch.cat([first, run(cache, torch.from_numpy(zq[2:]))[0]])

    got = port()
    with f32_operands:
        old = port()
    _hold(got, ref, old, STREAM_RTOL)


@pytest.mark.parametrize("boundary", [F32, BF16])
def test_stacked_codec_bf16_weights_match_jax_interpret(rng, monkeypatch, f32_operands,
                                                        boundary):
    """K3b: three streams of the small denoiser, two frames, at bf16 weights
    and each boundary dtype, against JAX K3b in interpret mode."""
    jgen, params, _, tgen, _ = _pair(False, seed=35)
    batch, chunk = 3, jgen.hop * 4
    frames = (rng.standard_normal((2, batch, chunk)) * 0.3).astype(np.float32)
    jinit, jrun = jax_stacked(jgen, params, chunk, batch=batch, weight_dtype=jnp.bfloat16,
                              interpret=True, vmem_budget=1,
                              boundary_dtype=jnp.bfloat16 if boundary == BF16 else jnp.float32)
    ref = np.asarray(jrun(jinit(), jnp.asarray(frames))[0])

    def port():
        init, run = make_mega_stream_stacked(tgen, chunk, batch, BF16, boundary_dtype=boundary)
        return run(init(), torch.from_numpy(frames))[0]

    got = port()
    with f32_operands:
        old = port()
    _hold_boundary(got, ref, old, boundary)


def _hold_boundary(got, ref, old, boundary):
    if boundary == F32:
        _hold(got, ref, old, STREAM_RTOL)
        return
    got, old = got.numpy(), old.numpy()
    scale = float(np.abs(ref).max())
    err, gap = float(np.abs(got - ref).max()), float(np.abs(old - ref).max())
    assert err <= BOUNDARY_RTOL * scale, (err, scale)
    assert err < gap, (err, gap)


@pytest.mark.parametrize("boundary", [F32, BF16])
def test_stacked_vocoder_bf16_weights_match_jax_interpret(rng, monkeypatch, f32_operands,
                                                          boundary):
    """K5: three streams of tests/test_vocoder_stacked.py's topology, two
    frames in two dispatches, at bf16 weights and each boundary dtype,
    against JAX K5 in interpret mode. JAX K5 rounds an upsample's output,
    after its bias (ops/vocoder_stacked.py:253), where K4 rounds its product
    before the bias; the port's K5 builder rounds as K5 does."""
    topology = dict(in_channels=12, out_channels=1, channels=32, kernel_size=7,
                    upsample_scales=(5, 4, 3), upsample_kernel_sizes=(10, 8, 6),
                    resblock_kernel_sizes=(5,), resblock_dilations=((1, 3),), groups=3)
    jv, p, tv = _vocoders(topology, seed=37)
    batch, chunk = 3, 2 * jv.total_upsample
    zs = (rng.standard_normal((2, batch, 2, 12)) * 0.5).astype(np.float32)
    jinit, jrun = jax_stacked_vocoder(
        jv, p, chunk, batch=batch, weight_dtype=jnp.bfloat16, interpret=True, vmem_budget=1,
        boundary_dtype=jnp.bfloat16 if boundary == BF16 else jnp.float32)
    ref = np.asarray(jrun(jinit(), jnp.asarray(zs))[0])

    def port(rounding="output"):
        init, run = make_stacked_vocoder(tv, chunk, batch, BF16, boundary_dtype=boundary,
                                         upsample_rounding=rounding)
        first, cache = run(init(), torch.from_numpy(zs[:1]))
        return torch.cat([first, run(cache, torch.from_numpy(zs[1:]))[0]]).numpy()

    got, k4_rounding = port(), port("product")
    with f32_operands:
        old = port()
    scale = float(np.abs(ref).max())
    err = float(np.abs(got - ref).max())
    assert err <= BOUNDARY_RTOL * scale, (err, scale)
    assert err < float(np.abs(old - ref).max()) and err < float(np.abs(k4_rounding - ref).max())


def test_rounded_operands_amplify_an_ulp(rng, monkeypatch):
    """Why a stream at bf16 weights is held no tighter than its sums' order
    allows: the K5 test's receiver moves by more than STREAM_RTOL of its
    largest sample when each operand is jittered by about one f32 ulp before
    it rounds, where the same jitter without the rounding moves it by less
    than 1e-5 of it."""
    topology = dict(in_channels=12, out_channels=1, channels=32, kernel_size=7,
                    upsample_scales=(5, 4, 3), upsample_kernel_sizes=(10, 8, 6),
                    resblock_kernel_sizes=(5,), resblock_dilations=((1, 3),), groups=3)
    _, _, tv = _vocoders(topology, seed=37)
    batch, chunk = 3, 2 * tv.total_upsample
    zs = torch.from_numpy((rng.standard_normal((2, batch, 2, 12)) * 0.5).astype(np.float32))
    gen = torch.Generator().manual_seed(1)

    def run():
        init, run_ = make_stacked_vocoder(tv, chunk, batch, BF16)
        return run_(init(), zs)[0]

    def jittered(round_it):
        def operand(a, wd):
            a = a * (1 + 1.2e-7 * torch.randn(a.shape, generator=gen))
            return a.to(BF16).float() if round_it else a
        for mod in (stream_kernel, mega_kernel, vocoder_kernel):
            monkeypatch.setattr(mod, "mma_operand", operand)
        return run()

    base = run()
    scale = float(base.abs().max())
    assert float((jittered(True) - base).abs().max()) > STREAM_RTOL * scale
    monkeypatch.undo()
    for mod in (stream_kernel, mega_kernel, vocoder_kernel):
        monkeypatch.setattr(mod, "mma_operand", lambda a, wd: a)
    unrounded = run()
    assert float((jittered(False) - unrounded).abs().max()) < 1e-5 * scale
