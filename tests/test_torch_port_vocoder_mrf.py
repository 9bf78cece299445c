"""K4's MultiReceptiveField arm in the port (the v0 / v3 receivers) against
the JAX package, on the CPU.

- The port's ``make_mega_vocoder`` (the kernels' plain versions run here)
  against the JAX K4 in interpret mode and ``voc.step`` on a small MRF
  topology (2 stages, blocks of kernel 3 and 5), frame by frame with the
  caches carried, with and without PQC and statistics; atol 2e-5
  (tests/test_vocoder_kernel.py).
- The batch axis, which the JAX K5 refuses for MRF: each stream against its
  own ``voc.step`` run.
- ``hifigan_unit_plain``'s accumulate epilogue against a hand sum of three
  blocks.
- The full-width ``vctk_v0`` pairing (the symAD codec's transmitter and the
  AudioDec v0 receiver with seeded statistics) against JAX ``voc.step``
  through ``make_vocoder_scan_stream``; atol 2e-4, the JAX package's
  flagship tolerance, as tests/test_torch_port_vocoder_v1.py.

Params: numpy-drawn in the JAX init's tree, weight-norm ``g`` at about unit
gain (tests/test_torch_port_hifigan.py::rescaled). Weights f32.
"""

import os

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from dl_speech_enhancement_tpu.ops.vocoder_kernel import make_mega_vocoder as jax_mega_vocoder
from dl_speech_enhancement_tpu.ops.vocoder_stacked import (
    make_stacked_vocoder as jax_stacked_vocoder,
)
from dl_speech_enhancement_tpu.stream import runtime as jrt
from dl_speech_enhancement_tpu_torch.models.hifigan import MultiReceptiveField
from dl_speech_enhancement_tpu_torch.nn.vq import VQState
from dl_speech_enhancement_tpu_torch.ops.mega_kernel import (
    _bias,
    conv_weight,
    join_halves,
    mega_encoder,
)
from dl_speech_enhancement_tpu_torch.ops.vocoder_kernel import (
    hifigan_unit,
    hifigan_unit_plain,
    make_mega_vocoder,
    make_stacked_vocoder,
    vocoder_half,
    vocoder_topology_error,
)
from dl_speech_enhancement_tpu_torch.stream.runtime import (
    VocoderReceiver,
    make_vocoder_scan_stream,
)
from dl_speech_enhancement_tpu_torch.utils.config import load_config
from test_torch_port_hifigan import MRF
from test_torch_port_vocoder import (
    _codecs,
    _jax_voc_stream,
    _jnp,
    _seeded_stats,
    _vocoders,
)
from test_torch_port_vocoder_v1 import _jax_codes
from torch_port_threads import one_thread  # noqa: F401

REPO = os.path.join(os.path.dirname(__file__), "..")
ATOL_SMALL = 2e-5
ATOL_FLAGSHIP = 2e-4


@pytest.mark.parametrize("wire", ["features", "stats", "codes"])
def test_mrf_vocoder_matches_jax_interpret(rng, wire):
    """4 frames of 3 code rows in two dispatches, the cache carried, through
    the port's single-stream builder, JAX ``voc.step`` and the JAX K4's MRF
    arm (interpret mode). With statistics the port is held to ``voc.step``
    only: the JAX K4 starts its folded input conv's cache at raw zeros
    (ROADMAP.md §3; tests/test_torch_port_vocoder.py)."""
    stats = _seeded_stats(rng, 8) if wire == "stats" else None
    jv, p, tv = _vocoders(MRF, seed=50, stats=stats)
    assert all(isinstance(b, MultiReceptiveField) for b in tv.blocks)
    assert vocoder_topology_error(tv, 3 * jv.total_upsample) is None
    chunk = 3 * jv.total_upsample
    if wire == "codes":
        embed = rng.standard_normal((2, 8, 12)).astype(np.float32)
        x = (rng.integers(0, 12, (4, 3, 2)) + np.arange(2) * 12).astype(np.int32)
        zq = np.stack([embed[l].T[x[..., l] - l * 12] for l in range(2)]).sum(0)
        tvq = VQState(torch.from_numpy(embed), torch.zeros(2, 12), torch.from_numpy(embed))
    else:
        embed, tvq = None, None
        x = zq = rng.standard_normal((4, 3, 8)).astype(np.float32)
    jinit, jrun = jax_mega_vocoder(jv, p, chunk, weight_dtype=jnp.float32, interpret=True,
                                   vq_embed=None if embed is None else jnp.asarray(embed))
    ref, _ = jrun(jinit(), jnp.asarray(x))
    steps = _jax_voc_stream(jv, p, zq)
    init, run = make_mega_vocoder(tv, chunk, torch.float32, tvq)
    first, cache = run(init(), torch.from_numpy(x[:2]))
    second, _ = run(cache, torch.from_numpy(x[2:]))
    got = torch.cat([first, second]).numpy()
    assert got.shape == (4, chunk)
    assert steps.std() > 1e-2
    np.testing.assert_allclose(got, steps, atol=ATOL_SMALL)
    if stats is None:
        np.testing.assert_allclose(got, np.asarray(ref), atol=ATOL_SMALL)
    else:
        assert np.abs(np.asarray(ref) - steps).max() > 1e-2


def test_mrf_batch_axis_serves_what_jax_k5_refuses(rng):
    """Three streams of the MRF receiver in one builder, two dispatches:
    each stream equals its own JAX ``voc.step`` run; the JAX K5 refuses the
    topology."""
    jv, p, tv = _vocoders(MRF, seed=51)
    batch, chunk = 3, 2 * jv.total_upsample
    zs = rng.standard_normal((3, batch, 2, 8)).astype(np.float32)
    with pytest.raises(AssertionError, match="MultiGroupConv1d"):
        jax_stacked_vocoder(jv, p, chunk, batch=batch, weight_dtype=jnp.float32,
                            interpret=True)
    init, run = make_stacked_vocoder(tv, chunk, batch, torch.float32)
    first, cache = run(init(), torch.from_numpy(zs[:1]))
    rest, _ = run(cache, torch.from_numpy(zs[1:]))
    got = torch.cat([first, rest]).numpy()
    for b in range(batch):
        np.testing.assert_allclose(got[:, b], _jax_voc_stream(jv, p, zs[:, b]),
                                   atol=ATOL_SMALL, err_msg=f"stream {b}")


def test_unit_epilogue_sums_and_averages_the_blocks(rng):
    """Three blocks over one entrance: block 0's last unit writes the sum,
    block 1's adds to it, block 2's adds and scales by 1/3; against the
    blocks run without the epilogue and averaged by hand, and the module's
    streaming step from zero caches. The wrapper (its plain version on the
    CPU) gives the same."""
    _, _, tv = _vocoders(dict(MRF, resblock_kernel_sizes=(3, 5, 7),
                              resblock_dilations=((1, 2),) * 3), seed=52)
    mrf, c = tv.blocks[0], tv.upsamples[0].out_channels
    x = torch.from_numpy(rng.standard_normal((2, 9, c)).astype(np.float32))

    def block(rb, acc=None, scale=1.0, unit=hifigan_unit_plain):
        y = x
        for ui, (c1, c2) in enumerate(zip(rb.convs1, rb.convs2)):
            last = ui == len(rb.convs1) - 1
            cache1, cache2 = (torch.zeros((2, conv.pad_length, c)) for conv in (c1, c2))
            y, _ = unit(cache1, cache2, y, conv_weight(c1, torch.float32), _bias(c1),
                        conv_weight(c2, torch.float32), _bias(c2), c1.dilation, 1,
                        tv.negative_slope, acc if last else None, scale if last else 1.0)
        return y

    ys = [block(rb) for rb in mrf.blocks]
    want = (ys[0] + ys[1] + ys[2]) / 3
    for unit in (hifigan_unit_plain, hifigan_unit):
        total = block(mrf.blocks[0], unit=unit)
        total = block(mrf.blocks[1], total, unit=unit)
        got = block(mrf.blocks[2], total, 1 / 3, unit=unit)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)
    with torch.no_grad():
        ref, _ = mrf.step(mrf.init_cache(2), x)
    np.testing.assert_allclose(want.numpy(), ref.numpy(), atol=ATOL_SMALL)


# ---------------------------------------------------------------- full width


@pytest.fixture(scope="module")
def flagship_v0():
    """The vctk_v0 pairing at full width: the symAD codec and the AudioDec v0
    receiver (MultiReceptiveField, resblock kernels 3/7/11) with seeded
    statistics, rescaled weight-norm gains."""
    cgp = load_config(os.path.join(REPO, "configs", "autoencoder",
                                   "symAD_vctk_48000_hop300.yaml"))["generator_params"]
    vgp = dict(load_config(os.path.join(
        REPO, "configs", "vocoder",
        "AudioDec_v0_symAD_vctk_48000_hop300_clean.yaml"))["generator_params"])
    for key in ("nonlinear_activation", "nonlinear_activation_params", "use_weight_norm",
                "stats"):
        vgp.pop(key)
    stats = _seeded_stats(np.random.default_rng(60), vgp["in_channels"])
    jc, cparams, cvq, tc, tvq = _codecs(cgp, seed=61)
    jv, vparams, tv = _vocoders(vgp, seed=62, stats=stats)
    return jc, cparams, cvq, tc, tvq, jv, vparams, tv


def test_flagship_v0_matches_jax(rng, flagship_v0):
    """Two 25 ms frames of the vctk_v0 pairing through JAX 'xla' (the
    codec's steps and ``voc.step``), the port's 'eager' route, its joined
    halves (the kernels' plain versions; 43 + 11 launches on the card) and
    ``VocoderReceiver`` on the joined halves' wire codes."""
    jc, cparams, cvq, tc, tvq, jv, vparams, tv = flagship_v0
    assert vocoder_topology_error(tv, 1200, hop=tc.hop) is None
    frames = rng.standard_normal((2, 1200)).astype(np.float32) * 0.3
    jrun = jrt.make_vocoder_scan_stream(jc, _jnp(cparams), _jnp(cvq), jv, vparams, 1200,
                                        backend="xla")
    ref, _ = jrun(jrun.init_cache(), jnp.asarray(frames))
    ref = np.asarray(ref)
    assert 0.01 < ref.std() < 0.9  # neither near constant nor saturated
    run = make_vocoder_scan_stream(tc, tvq, tv, 1200, backend="eager", device="cpu")
    got, _ = run(run.init_cache(), torch.from_numpy(frames))
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL_FLAGSHIP)
    init, joined = join_halves(mega_encoder(tc, torch.float32, tvq),
                               vocoder_half(tv, torch.float32, tvq), 1, "cpu", 1200)
    first, cache, c1 = joined(init(), torch.from_numpy(frames[:1, None]))
    rest, _, c2 = joined(cache, torch.from_numpy(frames[1:, None]))
    np.testing.assert_allclose(torch.cat([first, rest])[:, 0].numpy(), ref,
                               atol=ATOL_FLAGSHIP)
    codes = torch.cat([c1, c2])[:, 0]
    np.testing.assert_array_equal(codes.numpy(), _jax_codes(jc, cparams, cvq, frames))
    rx = VocoderReceiver(tc, tv, tvq, device="cpu")
    wire = codes.reshape(-1, codes.shape[-1]).t()[:, None].contiguous()  # (L, 1, N * T)
    np.testing.assert_allclose(rx.decode(wire).reshape(2, 1200).numpy(), ref,
                               atol=ATOL_FLAGSHIP)
