"""The PyTorch port's conv primitives against the JAX package's (CPU, f32).

Same params (JAX ``init`` carried across by utils/jax_params.py) and the same
numpy inputs go through both. Tolerance: atol 1e-5 (f32 convs summed in
another order by XLA and by PyTorch).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dl_speech_enhancement_tpu.nn import conv as jconv
from dl_speech_enhancement_tpu_torch.nn import conv as tconv
from dl_speech_enhancement_tpu_torch.ops.mega_kernel import conv_transpose_weight
from dl_speech_enhancement_tpu_torch.utils.jax_params import _dw_out, load_conv

ATOL = 1e-5


def _pair(name, *args, seed=0, transposed=False, **kw):
    jl = getattr(jconv, name)(*args, **kw)
    params = jax.tree_util.tree_map(np.asarray, jl.init(jax.random.PRNGKey(seed)))
    tl = getattr(tconv, name)(*args, **kw, device="cpu")
    load_conv(tl, params, transposed=transposed)
    return jl, params, tl


def _run(layer, x):
    with torch.no_grad():
        return layer(torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("k,stride,padding,dilation,bias", [
    (7, 1, -1, 1, True), (5, 2, 2, 1, False), (3, 1, 0, 3, True), (4, 3, 1, 1, True),
])
def test_conv1d_offline_matches_jax(rng, k, stride, padding, dilation, bias):
    jl, p, tl = _pair("Conv1d", 6, 10, k, stride=stride, padding=padding,
                      dilation=dilation, bias=bias)
    x = rng.standard_normal((2, 37, 6)).astype(np.float32)
    np.testing.assert_allclose(_run(tl, x), np.asarray(jl(p, jnp.asarray(x))), atol=ATOL)


def test_conv1d1x1_matches_jax(rng):
    jl, p, tl = _pair("Conv1d1x1", 12, 5)
    x = rng.standard_normal((3, 11, 12)).astype(np.float32)
    np.testing.assert_allclose(_run(tl, x), np.asarray(jl(p, jnp.asarray(x))), atol=ATOL)


@pytest.mark.parametrize("k,stride,dilation", [(7, 1, 1), (7, 1, 9), (6, 3, 1), (10, 5, 1)])
def test_causal_conv1d_offline_and_step_match_jax(rng, k, stride, dilation):
    jl, p, tl = _pair("CausalConv1d", 4, 8, k, stride=stride, dilation=dilation)
    x = rng.standard_normal((2, 6 * stride * 5, 4)).astype(np.float32)
    offline = _run(tl, x)
    np.testing.assert_allclose(offline, np.asarray(jl(p, jnp.asarray(x))), atol=ATOL)

    jc, tc = jl.init_cache(2), tl.init_cache(2)
    assert tuple(tc.shape) == tuple(jc.shape)
    outs = []
    for chunk in np.split(x, 5, axis=1):
        jy, jc = jl.step(p, jc, jnp.asarray(chunk))
        with torch.no_grad():
            ty, tc = tl.step(tc, torch.from_numpy(chunk))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=ATOL)
        outs.append(ty.numpy())
    # streaming == offline
    np.testing.assert_allclose(np.concatenate(outs, axis=1), offline, atol=ATOL)


def test_causal_conv1d_step_rejects_partial_chunk():
    jl, p, tl = _pair("CausalConv1d", 2, 2, 6, stride=3)
    x = np.zeros((1, 7, 2), np.float32)
    with pytest.raises(ValueError, match="multiple of stride 3"):
        jl.step(p, jl.init_cache(1), jnp.asarray(x))
    with pytest.raises(ValueError, match="multiple of stride 3"):
        tl.step(tl.init_cache(1), torch.from_numpy(x))


@pytest.mark.parametrize("k,stride,padding,output_padding", [
    (10, 5, -1, -1), (8, 4, -1, -1), (6, 3, 1, 0), (4, 2, 0, 1),
])
def test_conv_transpose1d_offline_matches_jax(rng, k, stride, padding, output_padding):
    jl, p, tl = _pair("ConvTranspose1d", 6, 4, k, stride, padding=padding,
                      output_padding=output_padding, transposed=True)
    x = rng.standard_normal((2, 9, 6)).astype(np.float32)
    np.testing.assert_allclose(_run(tl, x), np.asarray(jl(p, jnp.asarray(x))), atol=ATOL)


@pytest.mark.parametrize("stride", [3, 4, 5])
def test_causal_conv_transpose1d_offline_and_step_match_jax(rng, stride):
    jl, p, tl = _pair("CausalConvTranspose1d", 8, 4, 2 * stride, stride, transposed=True)
    x = rng.standard_normal((2, 12, 8)).astype(np.float32)
    offline = _run(tl, x)
    np.testing.assert_allclose(offline, np.asarray(jl(p, jnp.asarray(x))), atol=ATOL)

    jc, tc = jl.init_cache(2), tl.init_cache(2)
    outs = []
    for chunk in np.split(x, 4, axis=1):
        jy, jc = jl.step(p, jc, jnp.asarray(chunk))
        with torch.no_grad():
            ty, tc = tl.step(tc, torch.from_numpy(chunk))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=ATOL)
        outs.append(ty.numpy())
    # the first chunk's cache is zeros, not the replication pad of the
    # offline path, so streaming matches offline from the second chunk on
    np.testing.assert_allclose(np.concatenate(outs, axis=1)[:, 3 * stride:],
                               offline[:, 3 * stride:], atol=ATOL)


def test_transposed_weight_tap_flip(rng):
    """JAX stores the transposed kernel conv-ready and tap-flipped; the bridge
    un-flips it into torch's (in, out, k), and the kernels' conv-ready layout
    flips it back to exactly the JAX array."""
    jl, p, tl = _pair("CausalConvTranspose1d", 3, 5, 8, 4, transposed=True)
    w = p["w"]  # (k, in, out), flipped
    k = w.shape[0]
    tw = tl.weight.detach().numpy()  # (in, out, k)
    for kk in range(k):
        np.testing.assert_array_equal(tw[:, :, kk], w[k - 1 - kk])
    np.testing.assert_array_equal(conv_transpose_weight(tl).numpy(), w)
    np.testing.assert_array_equal(_dw_out(w), tw)
    # without the flip the layer computes something else
    flipped = tconv.CausalConvTranspose1d(3, 5, 8, 4, device="cpu")
    load_conv(flipped, {"w": w[::-1].copy(), "b": p["b"]}, transposed=True)
    x = rng.standard_normal((1, 6, 3)).astype(np.float32)
    assert np.abs(_run(flipped, x) - _run(tl, x)).max() > 1e-3


def test_grouped_conv_not_ported():
    """Grouped convs are ported (tests/test_torch_port_hifigan.py); grouped
    transposed convs are not, as in the JAX package (nn/conv.py:338-339)."""
    with pytest.raises(NotImplementedError):
        tconv.ConvTranspose1d(4, 4, 4, 2, groups=2, device="cpu")
    with pytest.raises(NotImplementedError):
        tconv.CausalConvTranspose1d(4, 4, 4, 2, groups=2, device="cpu")
