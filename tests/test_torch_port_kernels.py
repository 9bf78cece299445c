"""The port's kernel modules on the CPU, against the JAX package's Pallas
kernels run in interpret mode.

On a CPU tensor each kernel wrapper takes its plain PyTorch version, so these
tests pin the arithmetic the CUDA kernels must reproduce; chip_smoke.py holds
the kernels themselves to those plain versions on the card. Tolerances: atol
1e-5 for one residual chain or chunk step, 2e-5 for the whole small model
(the JAX package's own), 1e-6 between dispatch splits of one stream.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from conftest import SMALL_TOPOLOGY
from dl_speech_enhancement_tpu.models import AudioDecGenerator as JaxGenerator
from dl_speech_enhancement_tpu.models.autoencoder import ResidualUnit as JaxResidualUnit
from dl_speech_enhancement_tpu.nn import conv as jconv
from dl_speech_enhancement_tpu.ops.mega_kernel import make_mega_stream as jax_mega
from dl_speech_enhancement_tpu.ops.stream_kernel import (
    fused_residual_chain as jax_chain,
    make_fused_chunk_step as jax_fused_step,
)
from dl_speech_enhancement_tpu_torch.models import AudioDecGenerator
from dl_speech_enhancement_tpu_torch.models.autoencoder import ResidualUnit
from dl_speech_enhancement_tpu_torch.nn import conv as tconv
from dl_speech_enhancement_tpu_torch.ops import mega_kernel, stream_kernel
from dl_speech_enhancement_tpu_torch.ops.mega_kernel import (
    causal_conv,
    causal_conv_transpose,
    conv_transpose_weight,
    conv_weight,
    make_mega_stream,
)
from dl_speech_enhancement_tpu_torch.ops.stream_kernel import (
    _elu,
    chain_weights,
    fused_residual_chain,
    make_fused_chunk_step,
    residual_chain,
)
from dl_speech_enhancement_tpu_torch.utils.jax_params import from_jax_params, load_conv


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _small_pair(seed):
    jgen = JaxGenerator(use_pqc=False, **SMALL_TOPOLOGY)
    params = _np_tree(jgen.init(jax.random.PRNGKey(seed))[0])
    tgen = from_jax_params(AudioDecGenerator(use_pqc=False, device="cpu", **SMALL_TOPOLOGY),
                           params)
    return jgen, params, tgen


def _chain_pair(channels, seed=0):
    junits = [JaxResidualUnit(channels, dilation=d) for d in (1, 3, 9)]
    jps = [_np_tree(u.init(jax.random.PRNGKey(seed + i))) for i, u in enumerate(junits)]
    tunits = [ResidualUnit(channels, dilation=d, device="cpu") for d in (1, 3, 9)]
    for u, p in zip(tunits, jps):
        load_conv(u.conv1, p["conv1"])
        load_conv(u.conv2, p["conv2"])
    return jps, tunits


def test_elu_matches_reference_form():
    x = torch.linspace(-30, 5, 701)
    np.testing.assert_allclose(_elu(x).numpy(), torch.nn.functional.elu(x).numpy(),
                               atol=1e-7)


@pytest.mark.parametrize("channels,rows", [(32, 120), (8, 40)])
def test_fused_residual_chain_matches_jax_interpret(rng, channels, rows):
    jps, tunits = _chain_pair(channels)
    x = rng.standard_normal((78 + rows, channels)).astype(np.float32)
    ref = np.asarray(jax_chain(jps, jnp.asarray(x), interpret=True))
    got = fused_residual_chain(tunits, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)


def test_residual_chain_matches_the_modules_step(rng):
    """The plain chain equals three ResidualUnit.step calls with caches."""
    _, tunits = _chain_pair(16, seed=3)
    cache = rng.standard_normal((78, 16)).astype(np.float32)
    x = rng.standard_normal((50, 16)).astype(np.float32)
    with torch.no_grad():
        # each unit consumes the rows of [cache; x] it can still see; its
        # conv1 cache is the ELU of the first (k-1)*d of them
        h = torch.from_numpy(np.concatenate([cache, x]))[None]
        for u, d in zip(tunits, (1, 3, 9)):
            pad = 6 * d
            h, _ = u.step({"conv1": torch.nn.functional.elu(h[:, :pad])}, h[:, pad:])
        got = residual_chain(torch.from_numpy(cache), torch.from_numpy(x),
                             *chain_weights(tunits))
    np.testing.assert_allclose(got.numpy(), h[0].numpy(), atol=1e-5)


def test_bf16_weights_round_once(rng):
    """bf16 weights are widened to f32, and each conv's activated operand is
    rounded once to bf16, as the JAX kernels round it before the product;
    the residual stream and the sums stay f32. With the same values as f32
    weights nothing is rounded."""
    _, tunits = _chain_pair(8)
    cache = torch.from_numpy(rng.standard_normal((78, 8)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((30, 8)).astype(np.float32))
    w1, w2 = chain_weights(tunits, torch.bfloat16)
    got = residual_chain(cache, x, w1, w2)
    h = torch.cat([cache, x])
    for u, d in enumerate((1, 3, 9)):
        rows = h.shape[0] - 6 * d
        a = _elu(h).to(torch.bfloat16).float()
        acc = a[0:rows] @ w1[u, 0].float()
        for j in range(1, 7):
            acc = acc + a[j * d: j * d + rows] @ w1[u, j].float()
        h = h[6 * d:] + _elu(acc).to(torch.bfloat16).float() @ w2[u].float()
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), h.numpy())
    assert not torch.equal(got, residual_chain(cache, x, w1.float(), w2.float()))


@pytest.mark.parametrize("k,stride,dilation", [(7, 1, 1), (6, 3, 1), (10, 5, 1), (7, 1, 3)])
def test_causal_conv_plain_matches_jax_step(rng, k, stride, dilation):
    jl = jconv.CausalConv1d(6, 10, k, stride=stride, dilation=dilation)
    p = _np_tree(jl.init(jax.random.PRNGKey(0)))
    tl = tconv.CausalConv1d(6, 10, k, stride=stride, dilation=dilation, device="cpu")
    load_conv(tl, p)
    cache = rng.standard_normal((1, jl.pad_length, 6)).astype(np.float32)
    x = rng.standard_normal((1, stride * 8, 6)).astype(np.float32)
    ref, _ = jl.step(p, jnp.asarray(cache), jnp.asarray(x))
    got = causal_conv(torch.from_numpy(cache[0]), torch.from_numpy(x[0]), conv_weight(tl),
                      tl.bias.detach(), stride, dilation)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref)[0], atol=1e-5)


@pytest.mark.parametrize("stride", [3, 4, 5])
def test_causal_conv_transpose_plain_matches_jax_step(rng, stride):
    jl = jconv.CausalConvTranspose1d(6, 4, 2 * stride, stride)
    p = _np_tree(jl.init(jax.random.PRNGKey(1)))
    tl = tconv.CausalConvTranspose1d(6, 4, 2 * stride, stride, device="cpu")
    load_conv(tl, p, transposed=True)
    cache = rng.standard_normal((1, 1, 6)).astype(np.float32)
    x = rng.standard_normal((1, 7, 6)).astype(np.float32)
    ref, _ = jl.step(p, jnp.asarray(cache), jnp.asarray(x))
    got = causal_conv_transpose(torch.from_numpy(cache[0]), torch.from_numpy(x[0]),
                                conv_transpose_weight(tl), tl.bias.detach(), stride)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref)[0], atol=1e-5)


def test_fused_chunk_step_matches_jax_interpret(rng):
    jgen, params, tgen = _small_pair(0)
    jinit, jstep = jax_fused_step(jgen, params, interpret=True)
    tinit, tstep = make_fused_chunk_step(tgen)
    jc, tc = jinit(), tinit()
    for _ in range(4):
        x = rng.standard_normal((jgen.hop * 4, 1)).astype(np.float32) * 0.3
        jy, jc = jstep(jc, jnp.asarray(x))
        ty, tc = tstep(tc, torch.from_numpy(x))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5)
    for a, b in zip(tc["chains"], jc["chains"], strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def test_fused_chunk_step_rejects_other_topologies():
    _, _, tgen = _small_pair(0)
    tgen.encoder.blocks[0].res_units[1].conv1.dilation = 2
    with pytest.raises(ValueError, match="dilations"):
        make_fused_chunk_step(tgen)


def test_mega_stream_matches_jax_interpret(rng):
    jgen, params, tgen = _small_pair(0)
    chunk = jgen.hop * 4
    jinit, jrun = jax_mega(jgen, params, chunk, weight_dtype=jnp.float32, interpret=True)
    tinit, trun = make_mega_stream(tgen, chunk, weight_dtype=torch.float32)
    frames = rng.standard_normal((3, chunk)).astype(np.float32) * 0.3
    ref, _ = jrun(jinit(), jnp.asarray(frames))
    got, _ = trun(tinit(), torch.from_numpy(frames))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)


def test_mega_stream_cache_continues_across_dispatches(rng):
    jgen, params, tgen = _small_pair(1)
    chunk = jgen.hop * 2
    jinit, jrun = jax_mega(jgen, params, chunk, weight_dtype=jnp.float32, interpret=True)
    tinit, trun = make_mega_stream(tgen, chunk, weight_dtype=torch.float32)
    frames = rng.standard_normal((4, chunk)).astype(np.float32) * 0.3
    whole, _ = trun(tinit(), torch.from_numpy(frames))
    first, cache = trun(tinit(), torch.from_numpy(frames[:2]))
    second, _ = trun(cache, torch.from_numpy(frames[2:]))
    np.testing.assert_allclose(first.numpy(), whole.numpy()[:2], atol=1e-6)
    np.testing.assert_allclose(second.numpy(), whole.numpy()[2:], atol=1e-6)
    jfirst, jcache = jrun(jinit(), jnp.asarray(frames[:2]))
    jsecond, _ = jrun(jcache, jnp.asarray(frames[2:]))
    np.testing.assert_allclose(second.numpy(), np.asarray(jsecond), atol=2e-5)


def test_mega_stream_single_frame_dispatches(rng):
    """N = 1 per dispatch (the real-time path) equals one N-frame dispatch."""
    _, _, tgen = _small_pair(2)
    chunk = tgen.hop * 2
    init, run = make_mega_stream(tgen, chunk, weight_dtype=torch.float32)
    frames = torch.from_numpy(rng.standard_normal((3, chunk)).astype(np.float32))
    whole, _ = run(init(), frames)
    cache, outs = init(), []
    for f in frames:
        y, cache = run(cache, f[None])
        outs.append(y)
    np.testing.assert_allclose(torch.cat(outs).numpy(), whole.numpy(), atol=1e-6)


def test_mega_stream_bf16_weights_close_to_f32(rng):
    _, _, tgen = _small_pair(3)
    chunk = tgen.hop * 2
    frames = torch.from_numpy(rng.standard_normal((2, chunk)).astype(np.float32) * 0.3)
    init32, run32 = make_mega_stream(tgen, chunk, weight_dtype=torch.float32)
    init16, run16 = make_mega_stream(tgen, chunk)
    ref, _ = run32(init32(), frames)
    got, _ = run16(init16(), frames)
    err = float((got - ref).abs().max())
    assert 0 < err <= 2e-2 * float(ref.abs().max())


def test_mega_stream_refuses_what_it_does_not_cover():
    _, _, tgen = _small_pair(0)
    with pytest.raises(ValueError, match="without-PQC"):
        make_mega_stream(tgen, tgen.hop, vq_state=object())
    with pytest.raises(ValueError, match="multiple of the hop"):
        make_mega_stream(tgen, tgen.hop + 1)
    assert mega_kernel.mega_topology_error(tgen, tgen.hop) is None
    _, run = make_mega_stream(tgen, tgen.hop)
    with pytest.raises(ValueError, match="built for"):
        run({}, torch.zeros((1, 2 * tgen.hop)))


def test_wrappers_run_plain_on_cpu_and_raise_elsewhere():
    before = (stream_kernel.residual_chain.launches, causal_conv.launches,
              causal_conv_transpose.launches)
    c, x = torch.zeros(78, 4), torch.zeros(5, 4)
    w1, w2 = torch.zeros(3, 7, 4, 4), torch.zeros(3, 4, 4)
    assert residual_chain(c, x, w1, w2).shape == (5, 4)
    assert causal_conv(torch.zeros(6, 4), x, torch.zeros(7, 4, 2)).shape == (5, 2)
    assert causal_conv_transpose(torch.zeros(1, 4), x, torch.zeros(6, 4, 2),
                                 stride=3).shape == (15, 2)
    # the plain versions are not launches
    assert before == (stream_kernel.residual_chain.launches, causal_conv.launches,
                      causal_conv_transpose.launches)
    meta = {"device": "meta"}
    with pytest.raises(ValueError, match="unsupported device"):
        residual_chain(c.to(**meta), x.to(**meta), w1.to(**meta), w2.to(**meta))
    with pytest.raises(ValueError, match="unsupported device"):
        causal_conv(torch.zeros(6, 4, **meta), x.to(**meta), torch.zeros(7, 4, 2, **meta))
    with pytest.raises(ValueError, match="unsupported device"):
        causal_conv_transpose(torch.zeros(1, 4, **meta), x.to(**meta),
                              torch.zeros(6, 4, 2, **meta), stride=3)
