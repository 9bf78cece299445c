"""bf16 activations at the launch boundaries (``boundary_dtype``) of the port's
multi-stream codec (K3b) and vocoder (K5), against the JAX package on the
CPU.

The port's ``make_mega_stream_stacked`` and ``make_stacked_vocoder`` with
``boundary_dtype=torch.bfloat16`` (the kernels' plain versions run here,
rounding where the kernels store) against JAX ``make_mega_stream_stacked``
/ ``make_stacked_vocoder`` in interpret mode with ``vmem_budget=1`` (every
stage its own segment) and ``boundary_dtype=jnp.bfloat16``, as
tests/test_mega_stacked.py:143-163 holds JAX's own. Weights f32.

Tolerance: the JAX test's own, 0.05 of the largest |sample| of the f32
stream (the port's, which other test files hold to JAX's f32 at 2e-5). The
port rounds at other points than JAX's stages (a residual chain is one
launch where JAX rounds after each unit; the PQC projector's z and the
lookup's zq cross launches where JAX keeps them inside a stage), so the two
bf16 streams differ from each other by about as much as each differs from
f32. Measured at these seeds, of the largest sample: without
PQC port against JAX 4.8e-3, the port from its f32 stream 4.7e-3, JAX from
its 4.3e-3; with PQC 9.5e-3, 5.2e-3 and 6.7e-3; the vocoder 7.0e-3, 7.1e-3
and 6.5e-3.

Codes: int32, equal to the f32 run's except where the rounded z moved the
pick across a near tie (``utils/checks.py::moved_near_ties``: the two
picks' f32 distances within 2 |dz| |E_bf16 - E_f32| plus 1e-5 of the
distance). The f32 default is bit for bit the build without the argument.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dl_speech_enhancement_tpu.ops.mega_stacked import (
    make_mega_stream_stacked as jax_stacked,
)
from dl_speech_enhancement_tpu.ops.vocoder_stacked import (
    make_stacked_vocoder as jax_stacked_vocoder,
)
from dl_speech_enhancement_tpu_torch.ops import mega_kernel, vocoder_kernel
from dl_speech_enhancement_tpu_torch.ops.mega_kernel import (
    causal_conv,
    codebook_lookup,
    join_halves,
    mega_decoder,
    mega_encoder,
    rvq_assign_plain,
    vq_tables,
)
from dl_speech_enhancement_tpu_torch.ops.mega_stacked import make_mega_stream_stacked
from dl_speech_enhancement_tpu_torch.ops.stream_kernel import (
    residual_chain,
    residual_chain_plain,
    tail,
)
from dl_speech_enhancement_tpu_torch.ops.vocoder_kernel import hifigan_unit
from dl_speech_enhancement_tpu_torch.ops.vocoder_stacked import make_stacked_vocoder
from dl_speech_enhancement_tpu_torch.utils.checks import moved_near_ties
from test_torch_port_batched import _jnp_tree, _pair
from test_torch_port_hifigan import MGC, MRF
from test_torch_port_vocoder import _vocoders
from torch_port_threads import one_thread  # noqa: F401

BF16, F32 = torch.bfloat16, torch.float32
BOUNDARY_RTOL = 0.05  # tests/test_mega_stacked.py:163


def _port_run(tgen, tvq, chunk, batch, frames, boundary_dtype, monkeypatch):
    """(audio, cache, codes or None, the z the search was given) of one
    dispatch of the port's stacked builder."""
    seen = []

    def recording(z, *tables):
        seen.append(z)
        return rvq_assign_plain(z, *tables[:2])

    monkeypatch.setattr(mega_kernel, "rvq_assign", recording)
    init, run = make_mega_stream_stacked(tgen, chunk, batch, F32, tvq,
                                         boundary_dtype=boundary_dtype)
    out, cache, *codes = run(init(), torch.from_numpy(frames))
    return out, cache, (codes[0] if codes else None), (seen[0] if seen else None)


@pytest.mark.parametrize("use_pqc,hops,n", [(False, 4, 2), (True, 3, 2)])
def test_stacked_bf16_boundaries_match_jax_interpret(rng, monkeypatch, use_pqc, hops, n):
    batch = 3
    jgen, params, vq, tgen, tvq = _pair(use_pqc, seed=11 + use_pqc)
    chunk = jgen.hop * hops
    frames = rng.standard_normal((n, batch, chunk)).astype(np.float32) * 0.3
    jinit, jrun = jax_stacked(jgen, params, chunk, batch=batch, weight_dtype=jnp.float32,
                              interpret=True, vmem_budget=1,
                              vq_state=_jnp_tree(vq) if use_pqc else None,
                              boundary_dtype=jnp.bfloat16)
    ref = np.asarray(jrun(jinit(), jnp.asarray(frames))[0])
    # the f32 stream: JAX's f32 K3b within 2e-5 (tests/test_torch_port_batched.py)
    got32, _, codes32, z32 = _port_run(tgen, tvq, chunk, batch, frames, F32, monkeypatch)
    got, cache, codes, z16 = _port_run(tgen, tvq, chunk, batch, frames, BF16, monkeypatch)
    assert got.dtype == F32 and tuple(got.shape) == frames.shape
    assert all(t.dtype == F32 for t in cache.values())
    scale = float(got32.abs().max())
    np.testing.assert_allclose(got.numpy(), ref, atol=BOUNDARY_RTOL * scale)
    np.testing.assert_allclose(got.numpy(), got32.numpy(), atol=BOUNDARY_RTOL * scale)
    assert not torch.equal(got, got32)
    if use_pqc:
        assert codes.dtype == torch.int32 and z16.dtype == BF16 and z32.dtype == F32
        books = vq_tables(tvq, "cpu")[0]
        # the search's rows: stream by stream, then time
        rows = (lambda c: c.transpose(0, 1).reshape(-1, c.shape[-1]))
        held = moved_near_ties(z32, z16, books, rows(codes), rows(codes32))
        assert held["beyond"] == 0 and held["moved"] <= rows(codes).shape[0] // 4


@pytest.mark.parametrize("use_pqc", [False, True])
def test_stacked_f32_default_is_bit_for_bit(rng, use_pqc):
    _, _, _, tgen, tvq = _pair(use_pqc, seed=13)
    chunk, batch = tgen.hop * 2, 2
    frames = torch.from_numpy(rng.standard_normal((2, batch, chunk)).astype(np.float32) * 0.3)
    init, run = make_mega_stream_stacked(tgen, chunk, batch, F32, tvq)
    init32, run32 = make_mega_stream_stacked(tgen, chunk, batch, F32, tvq,
                                             boundary_dtype=torch.float32)
    for a, b in zip(run(init(), frames), run32(init32(), frames)):
        if isinstance(a, dict):
            assert all(torch.equal(a[k], b[k]) for k in a)
        else:
            assert torch.equal(a, b)


def test_stacked_vocoder_bf16_boundaries_match_jax_interpret(rng):
    """tests/test_vocoder_stacked.py's topology at bf16 boundaries: three
    streams, two frames in two dispatches with the cache carried."""
    topology = dict(in_channels=12, out_channels=1, channels=32, kernel_size=7,
                    upsample_scales=(5, 4, 3), upsample_kernel_sizes=(10, 8, 6),
                    resblock_kernel_sizes=(5,), resblock_dilations=((1, 3),), groups=3)
    jv, p, tv = _vocoders(topology, seed=23)
    batch, chunk = 3, 2 * jv.total_upsample
    zs = rng.standard_normal((2, batch, 2, 12)).astype(np.float32) * 0.5
    jinit, jrun = jax_stacked_vocoder(jv, p, chunk, batch=batch, weight_dtype=jnp.float32,
                                      interpret=True, vmem_budget=1,
                                      boundary_dtype=jnp.bfloat16)
    ref = np.asarray(jrun(jinit(), jnp.asarray(zs))[0])
    init, run = make_stacked_vocoder(tv, chunk, batch, F32, boundary_dtype=BF16)
    first, cache = run(init(), torch.from_numpy(zs[:1]))
    rest, cache = run(cache, torch.from_numpy(zs[1:]))
    got = torch.cat([first, rest])
    assert got.dtype == F32 and all(t.dtype == F32 for t in cache.values())
    # the f32 stream: JAX's f32 K5 within 3e-5 (tests/test_torch_port_vocoder.py)
    init32, run32 = make_stacked_vocoder(tv, chunk, batch, F32)
    f32 = run32(init32(), torch.from_numpy(zs))[0]
    scale = float(f32.abs().max())
    np.testing.assert_allclose(got.numpy(), ref, atol=BOUNDARY_RTOL * scale)
    np.testing.assert_allclose(got.numpy(), f32.numpy(), atol=BOUNDARY_RTOL * scale)
    assert torch.equal(f32, make_stacked_vocoder(tv, chunk, batch, F32,
                                                 boundary_dtype=F32)[1](init32(),
                                                                        torch.from_numpy(zs))[0])
    assert not torch.equal(got, f32)


def test_mrf_vocoder_bf16_boundaries_keep_the_running_sum_in_bf16(rng, monkeypatch):
    """The MultiReceptiveField arm (which JAX K5 refuses): every unit launch
    takes and gives bf16 activations, its running sum too, and the audio
    stays within 0.05 of the f32 stream's largest sample."""
    _, _, tv = _vocoders(MRF, seed=25)
    batch, chunk = 2, 2 * tv.total_upsample
    zs = torch.from_numpy(rng.standard_normal((2, batch, 2, tv.input_conv.in_channels))
                          .astype(np.float32) * 0.5)
    seen = []

    def recording(*args, **kwargs):
        seen.append((args[2].dtype, None if args[10] is None else args[10].dtype))
        return hifigan_unit(*args, **kwargs)

    monkeypatch.setattr(vocoder_kernel, "hifigan_unit", recording)
    init, run = make_stacked_vocoder(tv, chunk, batch, F32, boundary_dtype=BF16)
    got = run(init(), zs)[0]
    assert seen and all(x == BF16 and acc in (None, BF16) for x, acc in seen)
    assert any(acc == BF16 for _, acc in seen)
    init32, run32 = make_stacked_vocoder(tv, chunk, batch, F32)
    ref = run32(init32(), zs)[0]
    assert got.dtype == F32
    assert float((got - ref).abs().max()) <= BOUNDARY_RTOL * float(ref.abs().max())


def test_caches_hold_the_rounded_activations_in_f32(rng):
    """At bf16 boundaries every cache is f32, and a layer's cache holds its
    bf16 input's rows exactly (JAX's site buffers hold the upcast segment
    input); the audio frames' own cache is f32 audio."""
    _, _, _, tgen, tvq = _pair(True, seed=17)
    chunk, batch = tgen.hop * 2, 2
    init, run = join_halves(mega_encoder(tgen, F32, tvq, BF16),
                            mega_decoder(tgen, F32, tvq, BF16), batch, "cpu", chunk)
    frames = torch.from_numpy(rng.standard_normal((2, batch, chunk)).astype(np.float32))
    _, cache, codes = run(init(), frames)
    assert codes.dtype == torch.int32
    for name, t in cache.items():
        assert t.dtype == F32, name
        if name != "enc_in":
            assert torch.equal(t.to(BF16).float(), t), name
    assert not torch.equal(cache["enc_in"].to(BF16).float(), cache["enc_in"])


def test_plain_versions_round_where_the_kernels_store(rng):
    """Each plain version takes bf16 activations, computes in f32 on their
    widened values and rounds its output once."""
    g = torch.Generator().manual_seed(0)
    cache, x = torch.randn(2, 78, 8, generator=g), torch.randn(2, 30, 8, generator=g)
    w1, w2 = torch.randn(3, 7, 8, 8, generator=g) * 0.1, torch.randn(3, 8, 8, generator=g) * 0.1
    xb = x.to(BF16)
    y = residual_chain(cache, xb, w1, w2)
    assert y.dtype == BF16
    assert torch.equal(y, residual_chain_plain(cache, xb.float(), w1, w2).to(BF16))
    w = torch.randn(3, 8, 4, generator=g)
    assert torch.equal(causal_conv(cache[:, :2], xb, w, out_dtype=F32),
                       causal_conv(cache[:, :2], xb.float(), w))
    assert causal_conv(cache[:, :2], x, w, out_dtype=BF16).dtype == BF16
    assert tail(cache, xb, 5).dtype == F32
    assert torch.equal(tail(cache, xb, 5), xb[:, -5:].float())
    books_t = torch.randn(2, 4, 3, generator=g)
    codes = torch.tensor([[1, 6], [3, 4]], dtype=torch.int32)
    assert torch.equal(codebook_lookup(codes, books_t, out_dtype=BF16),
                       codebook_lookup(codes, books_t).to(BF16))


def test_only_float32_and_bfloat16_boundaries(rng):
    _, _, _, tgen, tvq = _pair(True, seed=19)
    with pytest.raises(ValueError, match="boundary_dtype"):
        make_mega_stream_stacked(tgen, tgen.hop, 2, F32, tvq, boundary_dtype=torch.float16)
    with pytest.raises(ValueError, match="boundary_dtype"):
        mega_encoder(tgen, F32, tvq, torch.float64)
    _, _, tv = _vocoders(MGC, seed=27)
    with pytest.raises(ValueError, match="boundary_dtype"):
        make_stacked_vocoder(tv, tv.total_upsample, 2, F32, boundary_dtype=torch.float16)
    with pytest.raises(ValueError, match="boundary dtypes differ"):
        join_halves(mega_encoder(tgen, F32, tvq, BF16), mega_decoder(tgen, F32, tvq), 2, "cpu")
