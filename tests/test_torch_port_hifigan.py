"""The port's HiFiGAN generator modules and the plain versions of the
vocoder's kernels against the JAX package (CPU, f32).

Same params (drawn with numpy in the tree of the JAX ``init``,
:func:`seeded_init`, then every weight-norm ``g`` set, seeded, to about unit
gain and so unlike ``||v||``, and the biases drawn larger, so a wrong norm
axis, group or bias shows) and the same numpy inputs go through
both packages; params cross with ``vocoder_from_jax_params``. Residual
blocks get inputs whose groups differ. Tolerance: atol 2e-5 (f32 convs
summed in another order), the JAX package's own at small topologies
(tests/test_vocoder_kernel.py).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from dl_speech_enhancement_tpu.models import hifigan as jhifi
from dl_speech_enhancement_tpu.nn import conv as jconv
from dl_speech_enhancement_tpu_torch.models import hifigan as thifi
from dl_speech_enhancement_tpu_torch.nn import conv as tconv
from dl_speech_enhancement_tpu_torch.ops.mega_kernel import (
    causal_conv_plain,
    causal_conv_transpose_plain,
    conv_transpose_weight,
    conv_weight,
)
from dl_speech_enhancement_tpu_torch.ops.stream_kernel import tail
from dl_speech_enhancement_tpu_torch.ops.vocoder_kernel import hifigan_unit_plain
from dl_speech_enhancement_tpu_torch.utils.jax_params import (
    _load_resblock,
    load_conv,
    vocoder_from_jax_params,
)
from torch_port_threads import one_thread  # noqa: F401

ATOL = 2e-5
SMALL = dict(in_channels=8, out_channels=1, channels=16, kernel_size=7,
             upsample_scales=(2, 3), upsample_kernel_sizes=(4, 6), bias=True,
             use_additional_convs=True)
MGC = dict(SMALL, resblock_kernel_sizes=(3,), resblock_dilations=((1, 2),), groups=2)
MRF = dict(SMALL, resblock_kernel_sizes=(3, 5), resblock_dilations=((1, 2), (1, 2)), groups=1)


def seeded_init(model, seed):
    """The params of ``model.init`` (with the codec's VQ state), drawn with
    numpy in the tree and shapes that ``jax.eval_shape(model.init)`` gives,
    so no init is compiled: a conv weight ``w`` and its bias from U(+-1 /
    sqrt(fan_in)) (the JAX init's bound, fan_in the weight's taps x input
    channels), a weight-norm ``v`` from N(0, 1) with ``g = ||v||`` over the
    layer's norm axes, codebooks from N(0, 1) with zero cluster sizes."""
    rng = np.random.default_rng(seed)

    def draw(p):
        if p is None:
            return None
        if hasattr(p, "_fields"):  # VQState
            embed = rng.standard_normal(p.embed.shape).astype(np.float32)
            return type(p)(embed, np.zeros(p.cluster_size.shape, np.float32), embed)
        if isinstance(p, (list, tuple)):
            return type(p)(draw(q) for q in p)
        out = {k: draw(v) for k, v in p.items() if k not in ("w", "v", "g", "b")}
        w = p.get("w", p.get("v"))
        bound = 1.0 / np.sqrt(np.prod(w.shape[:-1])) if w is not None else 1.0
        if "w" in p:
            out["w"] = rng.uniform(-bound, bound, w.shape).astype(np.float32)
        if "v" in p:
            out["v"] = rng.standard_normal(w.shape).astype(np.float32)
            axes = tuple(i for i, n in enumerate(p["g"].shape) if n == 1)
            out["g"] = np.sqrt((out["v"] ** 2).sum(axis=axes, keepdims=True))
        if "b" in p:
            out["b"] = rng.uniform(-bound, bound, p["b"].shape).astype(np.float32)
        return out

    return draw(jax.eval_shape(model.init, jax.random.PRNGKey(0)))


def rescaled(params, seed):
    """``params`` (numpy) with each weight-norm ``g`` set to the conv's unit
    gain times U(0.8, 1.25) and each bias drawn from N(0, 0.1^2), seeded."""
    rng = np.random.default_rng(seed)

    def walk(p):
        if isinstance(p, list):
            return [walk(q) for q in p]
        if not isinstance(p, dict):
            return p
        out = {k: walk(v) for k, v in p.items()}
        if "v" in p:
            v, g = np.asarray(p["v"]), np.asarray(p["g"])
            k, cin, cout = v.shape
            transposed = g.shape[2] == 1 and cout != 1  # (1, in, 1): norm per input channel
            gain = np.sqrt(k * cout / (2.0 * cin)) if transposed else 1.0
            out["g"] = (gain * rng.uniform(0.8, 1.25, g.shape)).astype(np.float32)
        if "b" in p:
            out["b"] = (0.1 * rng.standard_normal(np.shape(p["b"]))).astype(np.float32)
        return out

    return walk(jax.tree_util.tree_map(np.asarray, params))


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _stream(module_step, cache, chunks):
    outs = []
    for x in chunks:
        y, cache = module_step(cache, x)
        outs.append(np.asarray(y))
    return np.concatenate(outs, axis=1)


def _both_streams(jmod, p, tmod, x, n_chunks):
    """(JAX step over the chunks, port step over them) of one module."""
    jy = _stream(lambda c, v: jmod.step(p, c, jnp.asarray(v)), jmod.init_cache(x.shape[0]),
                 np.split(x, n_chunks, axis=1))
    with torch.no_grad():
        ty = _stream(lambda c, v: tmod.step(c, _t(v)), tmod.init_cache(x.shape[0]),
                     np.split(x, n_chunks, axis=1))
    return jy, ty


# ---------------------------------------------------------------- weight norm


@pytest.mark.parametrize("groups", [1, 2])
def test_weight_norm_conv_matches_jax(rng, groups):
    """Conv weight norm runs per output channel: with g not ||v|| the
    effective weights and outputs agree (a wrong axis would only pass at
    init, where g = ||v||)."""
    jl = jconv.CausalConv1d(6, 8, 5, dilation=2, groups=groups, weight_norm=True,
                            w_init="normal")
    p = rescaled(seeded_init(jl, 0), seed=1)
    tl = tconv.CausalConv1d(6, 8, 5, dilation=2, groups=groups, weight_norm=True,
                            w_init="normal", device="cpu")
    load_conv(tl, p)
    assert tuple(tl.g.shape) == (8, 1, 1)
    np.testing.assert_allclose(conv_weight(tl).numpy(), np.asarray(jl.weight(_jnp(p))),
                               rtol=1e-6, atol=1e-7)
    x = rng.standard_normal((2, 20, 6)).astype(np.float32)
    with torch.no_grad():
        got = tl(_t(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jl(_jnp(p), jnp.asarray(x))), atol=ATOL)


def test_weight_norm_transposed_conv_matches_jax(rng):
    """Transposed-conv weight norm runs per input channel."""
    jl = jconv.CausalConvTranspose1d(8, 4, 6, 3, weight_norm=True, w_init="normal")
    p = rescaled(seeded_init(jl, 2), seed=3)
    tl = tconv.CausalConvTranspose1d(8, 4, 6, 3, weight_norm=True, w_init="normal",
                                     device="cpu")
    load_conv(tl, p, transposed=True)
    assert tuple(tl.g.shape) == (8, 1, 1)
    np.testing.assert_allclose(conv_transpose_weight(tl).numpy(),
                               np.asarray(jl.weight(_jnp(p))), rtol=1e-6, atol=1e-7)
    x = rng.standard_normal((2, 9, 8)).astype(np.float32)
    jy, ty = _both_streams(jl, _jnp(p), tl, x, 3)
    np.testing.assert_allclose(ty, jy, atol=ATOL)


def test_weight_norm_init_and_param_checks():
    tl = tconv.Conv1d(4, 6, 3, weight_norm=True, w_init="normal", device="cpu",
                      generator=torch.Generator().manual_seed(0))
    assert sorted(n for n, _ in tl.named_parameters()) == ["bias", "g", "v"]
    torch.testing.assert_close(tl.weight, tl.v)  # g starts at ||v||
    assert float(tl.v.detach().std()) < 0.02  # N(0, 0.01)
    with pytest.raises(ValueError, match="weight_norm"):
        load_conv(tl, {"w": np.zeros((3, 4, 6), np.float32), "b": np.zeros(6, np.float32)})
    with pytest.raises(ValueError, match="w_init"):
        tconv.Conv1d(4, 6, 3, w_init="xavier", device="cpu")


# ---------------------------------------------------------------- modules


@pytest.mark.parametrize("groups,tiled", [(1, False), (2, False), (3, True)])
def test_residual_block_matches_jax(rng, groups, tiled):
    jb = jhifi.HiFiGANResidualBlock(3, 6 * groups, (1, 3), groups)
    p = rescaled(seeded_init(jb, 4), seed=5)
    tb = thifi.HiFiGANResidualBlock(3, 6 * groups, (1, 3), groups)
    _load_resblock(tb, p)
    x = rng.standard_normal((3, 12, 6 * groups)).astype(np.float32)
    if tiled:  # every group sees the same input, as in MultiGroupConv1d
        x = np.tile(x[..., :6], (1, 1, groups))
    with torch.no_grad():
        offline = tb(_t(x)).numpy()
    np.testing.assert_allclose(offline, np.asarray(jb(_jnp(p), jnp.asarray(x))), atol=ATOL)
    jy, ty = _both_streams(jb, _jnp(p), tb, x, 4)
    np.testing.assert_allclose(ty, jy, atol=ATOL)
    np.testing.assert_allclose(ty, offline, atol=ATOL)


@pytest.mark.parametrize("name", ["MultiGroupConv1d", "MultiReceptiveField"])
def test_fusion_blocks_match_jax(rng, name):
    kw = dict(channels=8, resblock_kernel_sizes=(3,), resblock_dilations=((1, 2),), groups=3)
    if name == "MultiReceptiveField":
        kw.update(resblock_kernel_sizes=(3, 5), resblock_dilations=((1, 2), (1, 3)), groups=1)
    jb = getattr(jhifi, name)(**kw)
    p = rescaled(seeded_init(jb, 6), seed=7)
    tb = getattr(thifi, name)(**kw)
    if name == "MultiGroupConv1d":
        _load_resblock(tb.block, p["block"])
        load_conv(tb.conv_out, p["conv_out"])
    else:
        for sub, sp in zip(tb.blocks, p["blocks"]):
            _load_resblock(sub, sp)
    x = rng.standard_normal((2, 10, 8)).astype(np.float32)
    with torch.no_grad():
        offline = tb(_t(x)).numpy()
    np.testing.assert_allclose(offline, np.asarray(jb(_jnp(p), jnp.asarray(x))), atol=ATOL)
    jy, ty = _both_streams(jb, _jnp(p), tb, x, 5)
    np.testing.assert_allclose(ty, jy, atol=ATOL)


def _generators(topology, seed, stats=None):
    jv = jhifi.HiFiGANGenerator(**topology, stats=stats)
    p = rescaled(seeded_init(jv, seed), seed=seed + 100)
    tv = vocoder_from_jax_params(thifi.HiFiGANGenerator(**topology, stats=stats, device="cpu"),
                                 p)
    return jv, _jnp(p), tv


@pytest.mark.parametrize("topology,with_stats", [(MGC, False), (MRF, False), (MGC, True)],
                         ids=["mgc", "mrf", "mgc_stats"])
def test_generator_matches_jax(rng, topology, with_stats):
    stats = (np.stack([rng.standard_normal(8), 0.5 + 1.5 * rng.random(8)]).astype(np.float32)
             if with_stats else None)
    jv, p, tv = _generators(topology, 8, stats)
    assert isinstance(tv.blocks[0], thifi.MultiGroupConv1d) == (topology is MGC)
    assert tv.total_upsample == jv.total_upsample == 6
    x = rng.standard_normal((2, 6, 8)).astype(np.float32)
    with torch.no_grad():
        offline = tv(_t(x)).numpy()
    ref = np.asarray(jv(p, jnp.asarray(x)))
    np.testing.assert_allclose(offline, ref, atol=ATOL)
    assert ref.std() > 1e-2  # unit-gain weights: the audio is not a constant
    jy, ty = _both_streams(jv, p, tv, x, 3)
    np.testing.assert_allclose(ty, jy, atol=ATOL)


def test_generator_builds_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        thifi.HiFiGANGenerator(**MGC)


def test_generator_refuses_what_the_reference_refuses():
    with pytest.raises(ValueError, match="twice its scale"):
        thifi.HiFiGANGenerator(**dict(MGC, upsample_kernel_sizes=(4, 5)), device="cpu")
    with pytest.raises(ValueError, match="odd"):
        thifi.HiFiGANGenerator(**dict(MGC, kernel_size=6), device="cpu")


# ---------------------------------------------------------------- kernels' plain versions


def _leaky(x, slope):
    return F.leaky_relu(x, slope)


@pytest.mark.parametrize("batch", [1, 3])
def test_hifigan_unit_plain_matches_the_block(rng, batch):
    """Three hifigan_unit_plain calls (the first reading its c-channel input
    for every group) equal a MultiGroupConv1d's grouped residual block, over
    two dispatches with carried caches: cache1 the tail of each unit's raw
    input (a view at the activation's stream stride), cache2 conv2's
    activated window rows."""
    jb = jhifi.MultiGroupConv1d(channels=8, resblock_kernel_sizes=(5,),
                                resblock_dilations=((1, 2, 3),), groups=3)
    p = rescaled(seeded_init(jb, 9), seed=10)
    tb = thifi.MultiGroupConv1d(channels=8, resblock_kernel_sizes=(5,),
                                resblock_dilations=((1, 2, 3),), groups=3)
    _load_resblock(tb.block, p["block"])
    load_conv(tb.conv_out, p["conv_out"])
    blk = tb.block
    units = [(conv_weight(c1), c1.bias.detach(), conv_weight(c2), c2.bias.detach(), c1.dilation)
             for c1, c2 in zip(blk.convs1, blk.convs2)]
    x = _t(rng.standard_normal((batch, 14, 8)))
    caches = [(torch.zeros(batch, 4 * d, 8 if i == 0 else 24), torch.zeros(batch, 4, 24))
              for i, (*_, d) in enumerate(units)]
    ref_cache, outs, refs = blk.init_cache(batch), [], []
    with torch.no_grad():
        for chunk in (x[:, :9], x[:, 9:]):
            h, new = chunk, []
            for (w1, b1, w2, b2, d), (c1, c2) in zip(units, caches):
                n1 = tail(c1, h, c1.shape[1])
                h, n2 = hifigan_unit_plain(c1, c2, h, w1, b1, w2, b2, d, 3)
                new.append((n1, n2))
            caches = new
            outs.append(h)
            y, ref_cache = blk.step(ref_cache, chunk.repeat(1, 1, 3))
            refs.append(y)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), torch.cat(refs, 1).numpy(),
                               atol=ATOL)
    # conv2's cache is the reference's own (activated rows, zeros at the start)
    for (_, n2), ref_c2 in zip(caches, ref_cache["convs2"]):
        np.testing.assert_allclose(n2.numpy(), ref_c2.numpy(), atol=ATOL)


def test_hifigan_unit_plain_groups_read_their_own_channels(rng):
    """A non-tiled unit whose groups see different inputs: group g reads
    channels [g*c, (g+1)*c) and writes the same columns."""
    conv1 = tconv.CausalConv1d(12, 12, 3, dilation=2, groups=3, weight_norm=True,
                               w_init="normal", device="cpu")
    conv2 = tconv.CausalConv1d(12, 12, 3, groups=3, weight_norm=True, w_init="normal",
                               device="cpu")
    with torch.no_grad():
        for c in (conv1, conv2):
            c.g.uniform_(0.8, 1.2)
            c.bias.normal_(0.0, 0.1)
    x, c1, c2 = _t(rng.standard_normal((2, 7, 12))), _t(rng.standard_normal((2, 4, 12))), \
        _t(rng.standard_normal((2, 2, 12)))
    got, new2 = hifigan_unit_plain(c1, c2, x, conv_weight(conv1), conv1.bias.detach(),
                                   conv_weight(conv2), conv2.bias.detach(), 2, 3)
    with torch.no_grad():
        h, _ = conv1.step(_leaky(c1, 0.1), _leaky(x, 0.1))
        h = _leaky(h, 0.1)
        y, ref2 = conv2.step(c2, h)
    np.testing.assert_allclose(got.numpy(), (x + y).numpy(), atol=ATOL)
    np.testing.assert_allclose(new2.numpy(), ref2.numpy(), atol=ATOL)


@pytest.mark.parametrize("slope,tanh", [(0.1, False), (0.01, True)])
def test_activated_causal_conv_plain_matches_the_modules(rng, slope, tanh):
    conv = tconv.CausalConv1d(6, 3, 7, device="cpu")
    cache, x = _t(rng.standard_normal((2, 6, 6))), _t(rng.standard_normal((2, 11, 6)))
    got = causal_conv_plain(cache, x, conv_weight(conv), conv.bias.detach(), leaky=slope,
                            tanh=tanh)
    with torch.no_grad():
        y, _ = conv.step(_leaky(cache, slope), _leaky(x, slope))
    np.testing.assert_allclose(got.numpy(), (torch.tanh(y) if tanh else y).numpy(), atol=ATOL)


def test_activated_causal_conv_transpose_plain_matches_the_module(rng):
    up = tconv.CausalConvTranspose1d(6, 4, 8, 4, device="cpu")
    cache, x = _t(rng.standard_normal((3, 1, 6))), _t(rng.standard_normal((3, 5, 6)))
    got = causal_conv_transpose_plain(cache, x, conv_transpose_weight(up), up.bias.detach(),
                                      4, leaky=0.1)
    with torch.no_grad():
        y, _ = up.step(_leaky(cache, 0.1), _leaky(x, 0.1))
    np.testing.assert_allclose(got.numpy(), y.numpy(), atol=ATOL)
