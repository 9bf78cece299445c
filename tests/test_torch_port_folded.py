"""The port's K1f (time-folded residual chain) and T1 (the fold relayout
probe) on the CPU.

K1f: ``fused_residual_chain_folded`` (the residual_chain kernel's plain
version runs here) and its folded plain version against the JAX package's
``fused_residual_chain_folded`` in interpret mode, at the denoiser's narrow
chains (C = 32 at fold 1/2/3, C = 64 at fold 2), atol 2e-5 (the JAX
package's own at small sizes; f32 sums in another order); each JAX assert is
a port ValueError. T1: ``fold_copy``'s plain version against numpy's
``reshape`` at the JAX probe's six shapes, exactly.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dl_speech_enhancement_tpu.models.autoencoder import ResidualUnit as JaxResidualUnit
from dl_speech_enhancement_tpu.ops.stream_kernel import (
    fused_residual_chain_folded as jax_folded,
)
from dl_speech_enhancement_tpu_torch.models.autoencoder import ResidualUnit
from dl_speech_enhancement_tpu_torch.ops.stream_kernel import (
    DILATIONS,
    fused_residual_chain,
    fused_residual_chain_folded,
    fused_residual_chain_folded_plain,
)
from dl_speech_enhancement_tpu_torch.tools import reshape_probe
from dl_speech_enhancement_tpu_torch.utils.jax_params import load_conv
from torch_port_threads import one_thread  # noqa: F401

ATOL = 2e-5
HALO = 78  # sum of (7 - 1) * d over dilations 1, 3, 9


def _chain_pair(channels, seed):
    """JAX params of three residual units (numpy, weights drawn at twice the
    init's bound so the chain departs from the identity) and the port's
    units holding them."""
    rng = np.random.default_rng(seed)
    jps = []
    for d in DILATIONS:
        shapes = jax.eval_shape(JaxResidualUnit(channels, dilation=d).init,
                                jax.random.PRNGKey(0))
        bound = 2.0 / np.sqrt(7 * channels)
        jps.append({name: {"w": rng.uniform(-bound, bound, p["w"].shape).astype(np.float32)}
                    for name, p in shapes.items()})
    units = [ResidualUnit(channels, dilation=d, device="cpu") for d in DILATIONS]
    for u, p in zip(units, jps):
        load_conv(u.conv1, p["conv1"])
        load_conv(u.conv2, p["conv2"])
    return jps, units


@pytest.mark.parametrize("channels,fold", [(32, 1), (32, 2), (32, 3), (64, 2)])
def test_folded_chain_matches_jax_interpret(rng, channels, fold):
    jps, units = _chain_pair(channels, seed=channels + fold)
    rows = 24 * fold
    x = rng.standard_normal((HALO + rows, channels)).astype(np.float32)
    ref = np.asarray(jax_folded(jps, jnp.asarray(x), fold, interpret=True))
    assert ref.shape == (rows, channels)
    got = fused_residual_chain_folded(units, torch.from_numpy(x), fold)
    plain = fused_residual_chain_folded_plain(units, torch.from_numpy(x), fold)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)
    np.testing.assert_allclose(plain.numpy(), ref, atol=ATOL)
    # K1f's function is K1's
    np.testing.assert_array_equal(got.numpy(), fused_residual_chain(
        units, torch.from_numpy(x)).numpy())
    assert np.abs(ref - x[HALO:]).max() > 0.1  # the chain does work


@pytest.mark.parametrize("channels,fold,t_in", [
    (64, 3, HALO + 72),   # fold * C > 128
    (32, 4, HALO + 72),   # fold does not divide the pads 6, 18, 54
    (32, 2, HALO + 71),   # fold does not divide the input length
], ids=["lanes", "pads", "length"])
def test_folded_chain_refuses_what_jax_asserts(rng, channels, fold, t_in):
    jps, units = _chain_pair(channels, seed=0)
    x = rng.standard_normal((t_in, channels)).astype(np.float32)
    with pytest.raises(AssertionError):
        jax_folded(jps, jnp.asarray(x), fold, interpret=True)
    for fn in (fused_residual_chain_folded, fused_residual_chain_folded_plain):
        with pytest.raises(ValueError):
            fn(units, torch.from_numpy(x), fold)


@pytest.mark.parametrize("shape,s,mode", reshape_probe.SHAPES,
                         ids=lambda v: str(v).replace(" ", ""))
def test_fold_copy_plain_matches_numpy(shape, s, mode):
    x = np.arange(shape[0] * shape[1], dtype=np.float32).reshape(shape)
    out_shape = (shape[0] // s, s * shape[1]) if mode == "fold" else (shape[0] * s,
                                                                      shape[1] // s)
    try:
        want = x.reshape(out_shape)
    except ValueError:
        want = None
    if want is None:
        with pytest.raises(ValueError):
            reshape_probe.fold_copy(torch.from_numpy(x), s, mode)
        return
    got = reshape_probe.fold_copy(torch.from_numpy(x), s, mode)
    np.testing.assert_array_equal(got.numpy(), want)


def test_probe_agrees_with_numpy_on_the_cpu(capsys):
    assert reshape_probe.main(device="cpu") == 0
    out = capsys.readouterr().out
    assert out.count(": OK") == 4 and out.count("REFUSED, as numpy") == 2
