"""The port's symAD PQC codec (projector, residual VQ, lookup, decoder input
conv) against the JAX package, on the CPU.

JAX params and ``VQState`` from ``gen.init(PRNGKey)`` cross into the port
with ``from_jax_params`` and ``vq_state_from_jax``; inputs come from numpy;
weights are f32. Tolerances: wire codes exact; audio atol 2e-5 at the small
topology (tests/test_mega_kernel.py:83-88) and 2e-4 at the flagship, the JAX
package's own; atol 1e-6 between dispatch splits of one stream. The kernel
modules run their plain versions here (CPU tensors); chip_smoke.py holds the
CUDA kernels to those plain versions on the card.
"""

import ctypes
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from conftest import SMALL_TOPOLOGY
from dl_speech_enhancement_tpu.models import AudioDecGenerator as JaxGenerator
from dl_speech_enhancement_tpu.ops.mega_kernel import make_mega_stream as jax_mega
from dl_speech_enhancement_tpu.stream import runtime as jrt
from dl_speech_enhancement_tpu_torch.models import AudioDecGenerator
from dl_speech_enhancement_tpu_torch.nn.vq import VQState
from dl_speech_enhancement_tpu_torch.ops import mega_kernel
from dl_speech_enhancement_tpu_torch.ops.mega_kernel import (
    codebook_lookup,
    make_mega_stream,
    rvq_assign,
    rvq_assign_plain,
    vq_tables,
)
from dl_speech_enhancement_tpu_torch.stream import runtime
from dl_speech_enhancement_tpu_torch.stream.runtime import make_scan_stream
from dl_speech_enhancement_tpu_torch.utils.checks import rvq_near_ties
from dl_speech_enhancement_tpu_torch.utils.config import load_config
from dl_speech_enhancement_tpu_torch.utils.jax_params import (
    from_jax_params,
    vq_state_from_jax,
)
from torch_port_threads import one_thread  # noqa: F401

PQC_TOPOLOGY = dict(SMALL_TOPOLOGY, codebook_num=3)
CODEC_CONFIG = os.path.join(os.path.dirname(__file__), "..", "configs", "autoencoder",
                            "symAD_vctk_48000_hop300.yaml")
ATOL_SMALL = 2e-5
ATOL_FLAGSHIP = 2e-4


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(seed=0, **topology):
    """(JAX generator, its params and VQState as numpy, the port's generator
    and VQState on the CPU)."""
    topology = topology or PQC_TOPOLOGY
    jgen = JaxGenerator(use_pqc=True, **topology)
    params, vq = (_np_tree(t) for t in jgen.init(jax.random.PRNGKey(seed)))
    tgen = from_jax_params(AudioDecGenerator(use_pqc=True, device="cpu", **topology), params)
    return jgen, params, vq, tgen, vq_state_from_jax(vq, tgen)


def _jax_stream(jgen, params, vq, frames):
    """The JAX per-frame PQC chain, encode_step -> quantize -> lookup ->
    decode_step: audio (N, F) and codes (N, F / hop, L)."""
    cache, flat_cb = jgen.init_cache(1), jgen.flat_codebook(vq)
    outs, codes = [], []
    for x in frames:
        z, ec = jgen.encode_step(params, cache, jnp.asarray(x[None, :, None]))
        cache.update(ec)
        idx = jgen.quantize(vq, z)
        y, dc = jgen.decode_step(params, cache, jgen.lookup(flat_cb, idx))
        cache.update(dc)
        outs.append(np.asarray(y)[0, :, 0])
        codes.append(np.asarray(idx)[:, 0, :].T)
    return np.stack(outs), np.stack(codes), cache


def _frames(rng, n, chunk):
    return rng.standard_normal((n, chunk)).astype(np.float32) * 0.3


# ---------------------------------------------------------------- kernel modules


def test_rvq_assign_plain_matches_jax_encode(rng):
    _, _, vq, tgen, tvq = _pair(seed=1)
    z = rng.standard_normal((40, PQC_TOPOLOGY["code_dim"])).astype(np.float32) * 2
    jgen = JaxGenerator(use_pqc=True, **PQC_TOPOLOGY)
    ref = np.asarray(jgen.quantize(jax.tree_util.tree_map(jnp.asarray, vq),
                                   jnp.asarray(z[None])))[:, 0].T
    got = rvq_assign(torch.from_numpy(z), *vq_tables(tvq, "cpu"))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert len(np.unique(ref[:, 0])) >= 10


def test_codebook_lookup_plain_matches_jax_lookup(rng):
    _, _, vq, tgen, tvq = _pair(seed=2)
    n_books, book_k = PQC_TOPOLOGY["codebook_num"], PQC_TOPOLOGY["codebook_size"]
    codes = (rng.integers(0, book_k, (30, n_books)) + np.arange(n_books) * book_k)
    codes = codes.astype(np.int32)
    jgen = JaxGenerator(use_pqc=True, **PQC_TOPOLOGY)
    ref = jgen.lookup(jgen.flat_codebook(jax.tree_util.tree_map(jnp.asarray, vq)),
                      jnp.asarray(codes.T[:, None]))
    got = codebook_lookup(torch.from_numpy(codes), vq_tables(tvq, "cpu")[2])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref)[0], atol=1e-6)


def test_codebook_lookup_rejects_codes_outside_their_book():
    books_t = torch.ones(2, 4, 3)
    for bad in ([[0, 3]], [[4, 4]], [[0, 8]], [[-1, 4]]):
        with pytest.raises(ValueError, match="outside its book"):
            codebook_lookup(torch.tensor(bad, dtype=torch.int32), books_t)
    got = codebook_lookup(torch.tensor([[0, 4], [3, 7]], dtype=torch.int32), books_t)
    assert got.tolist() == [[2.0] * 3] * 2


def test_bad_code_word_reports_each_recorded_call_once():
    """The host side of the card's bad-code word: nothing to report until a
    call's number is stored; each new number raises once; the word is never
    cleared, so a later check finds nothing new until another call stores
    its number. (On the card the lookup kernel makes the store.)"""
    word = mega_kernel.BadCodeWord()
    word.check()  # no call on the card yet: no word to read
    word._word = ctypes.c_longlong(0)  # the mapped word, as a kernel leaves it
    word.calls = 3
    word.check()
    word._word.value = 2  # call 2 met a code outside its book
    with pytest.raises(ValueError, match="outside its book"):
        word.check()
    word.check()
    word._word.value = 3
    with pytest.raises(ValueError, match="outside its book"):
        word.check()
    word.check()


def test_near_tie_rule_tells_ties_from_mismatches(rng):
    z = torch.from_numpy(rng.standard_normal((6, 4)).astype(np.float32))
    books = torch.from_numpy(rng.standard_normal((2, 4, 8)).astype(np.float32))
    sqnorm = (books * books).sum(1)
    ref = rvq_assign_plain(z, books, sqnorm)
    assert rvq_near_ties(z, books, sqnorm, ref, ref) == {"ties": 0, "mismatches": 0,
                                                         "max_excess": 0.0}
    # row 0 picks another codeword at stage 0 (its later stage is not held)
    wrong = ref.clone()
    wrong[0, 0] = (ref[0, 0] + 1) % 8
    wrong[0, 1] = 8
    assert rvq_near_ties(z, books, sqnorm, wrong, ref)["mismatches"] == 1
    # a duplicated codeword is an exact tie: either index passes
    books[0, :, 7] = books[0, :, int(ref[1, 0])]
    sqnorm = (books * books).sum(1)
    tied = ref.clone()
    tied[1, 0] = 7
    got = rvq_near_ties(z, books, sqnorm, tied, ref)
    assert got["ties"] == 1 and got["mismatches"] == 0


def test_pqc_wrappers_run_plain_on_cpu_and_raise_elsewhere():
    before = (rvq_assign.launches, codebook_lookup.launches)
    z, books, sqnorm = torch.zeros(5, 4), torch.zeros(2, 4, 6), torch.zeros(2, 6)
    assert rvq_assign(z, books, sqnorm, books.transpose(1, 2)).tolist() == [[0, 6]] * 5
    assert codebook_lookup(torch.zeros(5, 2, dtype=torch.int32) + torch.tensor(
        [0, 6], dtype=torch.int32), books.transpose(1, 2)).shape == (5, 4)
    assert before == (rvq_assign.launches, codebook_lookup.launches)
    meta = {"device": "meta"}
    with pytest.raises(ValueError, match="unsupported device"):
        rvq_assign(z.to(**meta), books.to(**meta), sqnorm.to(**meta),
                   books.transpose(1, 2).to(**meta))
    with pytest.raises(ValueError, match="unsupported device"):
        codebook_lookup(torch.zeros(5, 2, dtype=torch.int32, **meta),
                        books.transpose(1, 2).to(**meta))


# ---------------------------------------------------------------- generator


def test_streaming_steps_match_jax(rng):
    jgen, params, vq, tgen, tvq = _pair(seed=3)
    frames = _frames(rng, 4, jgen.hop * 3)
    jys, jcodes, jcache = _jax_stream(jgen, params, vq, frames)
    cache, flat_cb = tgen.init_cache(1), tgen.flat_codebook(tvq)
    ys, codes = [], []
    with torch.no_grad():
        for x in frames:
            z, ec = tgen.encode_step(cache, torch.from_numpy(x[None, :, None]))
            cache.update(ec)
            idx = tgen.quantize(tvq, z)
            y, dc = tgen.decode_step(cache, tgen.lookup(flat_cb, idx))
            cache.update(dc)
            ys.append(y[0, :, 0].numpy())
            codes.append(idx[:, 0].t().numpy())
    np.testing.assert_array_equal(np.stack(codes), jcodes)
    np.testing.assert_allclose(np.stack(ys), jys, atol=ATOL_SMALL)
    assert set(cache) == {"encoder", "projector", "decoder"}
    for a, b in zip(jax.tree_util.tree_leaves(cache), jax.tree_util.tree_leaves(jcache),
                    strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL_SMALL)


@pytest.mark.parametrize("train", [False, True])
def test_offline_forward_matches_jax(rng, train):
    jgen, params, vq, tgen, tvq = _pair(seed=4)
    x = rng.standard_normal((2, jgen.hop * 5, 1)).astype(np.float32) * 0.3
    ref = jgen(params, jax.tree_util.tree_map(jnp.asarray, vq), jnp.asarray(x), train=train)
    with torch.no_grad():
        got = tgen(torch.from_numpy(x), tvq, train=train)
    for r, g in zip(ref[:5], got[:5]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=ATOL_SMALL)
    for a, b in zip(got[5], ref[5], strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=ATOL_SMALL)


def test_receptive_length_walks_the_projector():
    assert AudioDecGenerator(device="cpu").receptive_length == 7209
    small = AudioDecGenerator(device="cpu", **PQC_TOPOLOGY)
    assert small.receptive_length == JaxGenerator(**PQC_TOPOLOGY).receptive_length


def test_prime_matches_jax(rng):
    jgen, params, vq, tgen, tvq = _pair(seed=5)
    jcache = jgen.prime(params, jax.tree_util.tree_map(jnp.asarray, vq))
    with torch.no_grad():
        tcache = tgen.prime(tvq)
    for a, b in zip(jax.tree_util.tree_leaves(tcache), jax.tree_util.tree_leaves(jcache),
                    strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL_SMALL)
    with pytest.raises(ValueError, match="VQState"):
        tgen.prime()


def test_a_vq_state_is_refused_by_the_denoiser(rng):
    """The without-PQC generator has no quantizer: every entry point that
    takes a VQState refuses one, where the JAX package would fail later at
    ``gen.flat_codebook``."""
    _, _, _, _, tvq = _pair(seed=0)
    denoiser = AudioDecGenerator(use_pqc=False, device="cpu", **SMALL_TOPOLOGY)
    with pytest.raises(ValueError, match="without-PQC"):
        denoiser.prime(tvq)
    with pytest.raises(ValueError, match="without-PQC"):
        make_mega_stream(denoiser, denoiser.hop, vq_state=tvq)
    with pytest.raises(ValueError, match="without-PQC"):
        make_scan_stream(denoiser, tvq, device="cpu")
    with pytest.raises(ValueError, match="without-PQC"):
        runtime.StreamingTransmitter(denoiser, tvq, device="cpu")
    with pytest.raises(ValueError, match="does not fit"):
        vq_state_from_jax(tvq, denoiser)


def test_codec_needs_its_vq_state():
    gen = AudioDecGenerator(device="cpu", **PQC_TOPOLOGY)
    with pytest.raises(ValueError, match="VQState"):
        make_mega_stream(gen, gen.hop)
    with pytest.raises(ValueError, match="VQState"):
        make_scan_stream(gen, device="cpu")
    with pytest.raises(ValueError, match="VQState"):
        runtime.StreamingReceiver(gen, None, device="cpu")


def test_codec_parameters_match_jax():
    gp = load_config(CODEC_CONFIG)["generator_params"]
    gen = AudioDecGenerator(**gp, device="cpu")
    jgen = JaxGenerator(**gp)
    params, vq = jgen.init(jax.random.PRNGKey(0))
    n_jax = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(params))
    assert gen.use_pqc and sum(p.numel() for p in gen.parameters()) == n_jax
    assert tuple(gen.projector.conv.weight.shape) == (64, 512, 3)
    assert tuple(gen.decoder.conv1.weight.shape) == (512, 64, 7)
    state = gen.quantizer.init(seed=0, device="cpu")
    assert [tuple(t.shape) for t in state] == [tuple(np.shape(t)) for t in vq] == [
        (8, 64, 1024), (8, 1024), (8, 64, 1024)]


# ---------------------------------------------------------------- streams


def test_mega_stream_matches_jax_interpret(rng):
    jgen, params, vq, tgen, tvq = _pair(seed=3)
    chunk = jgen.hop * 4
    jinit, jrun = jax_mega(jgen, params, chunk, weight_dtype=jnp.float32, interpret=True,
                           vq_state=jax.tree_util.tree_map(jnp.asarray, vq))
    tinit, trun = make_mega_stream(tgen, chunk, weight_dtype=torch.float32, vq_state=tvq)
    frames = _frames(rng, 3, chunk)
    ref, jcache, ref_codes = jrun(jinit(), jnp.asarray(frames))
    got, tcache, codes = trun(tinit(), torch.from_numpy(frames))
    assert codes.dtype == torch.int32 and tuple(codes.shape) == (3, 4, 3)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(ref_codes))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL_SMALL)
    for name in ("prj", "dc1"):
        np.testing.assert_allclose(tcache[name].numpy(), np.asarray(jcache[name]),
                                   atol=ATOL_SMALL)


def test_mega_stream_cache_continues_across_dispatches(rng):
    jgen, params, vq, tgen, tvq = _pair(seed=4)
    chunk = jgen.hop * 2
    jinit, jrun = jax_mega(jgen, params, chunk, weight_dtype=jnp.float32, interpret=True,
                           vq_state=jax.tree_util.tree_map(jnp.asarray, vq))
    tinit, trun = make_mega_stream(tgen, chunk, weight_dtype=torch.float32, vq_state=tvq)
    frames = _frames(rng, 4, chunk)
    whole, _, codes_w = trun(tinit(), torch.from_numpy(frames))
    first, cache, codes_1 = trun(tinit(), torch.from_numpy(frames[:2]))
    second, _, codes_2 = trun(cache, torch.from_numpy(frames[2:]))
    np.testing.assert_allclose(first.numpy(), whole.numpy()[:2], atol=1e-6)
    np.testing.assert_allclose(second.numpy(), whole.numpy()[2:], atol=1e-6)
    np.testing.assert_array_equal(torch.cat([codes_1, codes_2]).numpy(), codes_w.numpy())
    _, jcache, _ = jrun(jinit(), jnp.asarray(frames[:2]))
    jsecond, _, jcodes = jrun(jcache, jnp.asarray(frames[2:]))
    np.testing.assert_array_equal(codes_2.numpy(), np.asarray(jcodes))
    np.testing.assert_allclose(second.numpy(), np.asarray(jsecond), atol=ATOL_SMALL)


def test_mega_stream_single_frame_dispatches(rng):
    _, _, _, tgen, tvq = _pair(seed=6)
    chunk = tgen.hop
    init, run = make_mega_stream(tgen, chunk, weight_dtype=torch.float32, vq_state=tvq)
    frames = torch.from_numpy(_frames(rng, 3, chunk))
    whole, _, codes_w = run(init(), frames)
    cache, outs, codes = init(), [], []
    for f in frames:
        y, cache, c = run(cache, f[None])
        outs.append(y)
        codes.append(c)
    np.testing.assert_allclose(torch.cat(outs).numpy(), whole.numpy(), atol=1e-6)
    np.testing.assert_array_equal(torch.cat(codes).numpy(), codes_w.numpy())


def test_mega_stream_bf16_weights_keep_f32_codebooks(rng):
    _, _, _, tgen, tvq = _pair(seed=7)
    chunk = tgen.hop * 2
    frames = torch.from_numpy(_frames(rng, 2, chunk))
    init16, run16 = make_mega_stream(tgen, chunk, vq_state=tvq)
    init32, run32 = make_mega_stream(tgen, chunk, weight_dtype=torch.float32, vq_state=tvq)
    out16, _, codes16 = run16(init16(), frames)
    out32, _, codes32 = run32(init32(), frames)
    assert codes16.dtype == torch.int32 and codes16.shape == codes32.shape
    assert bool(torch.isfinite(out16).all())
    # the codes index the same books whatever the weights' type
    n_books, book_k = PQC_TOPOLOGY["codebook_num"], PQC_TOPOLOGY["codebook_size"]
    base = torch.arange(n_books, dtype=torch.int32) * book_k
    assert bool(((codes16 >= base) & (codes16 < base + book_k)).all())


@pytest.mark.parametrize("backend", ["eager", "auto"])
@pytest.mark.parametrize("frame_size", [None, 600])
def test_scan_stream_matches_jax_xla(rng, backend, frame_size):
    jgen, params, vq, tgen, tvq = _pair(seed=8)
    frames = _frames(rng, 4, 600)
    jrun = jrt.make_scan_stream(jgen, params, jax.tree_util.tree_map(jnp.asarray, vq),
                                backend="xla")
    ref, _ = jrun(jrun.init_cache(), jnp.asarray(frames[:, None, :, None]))
    _, ref_codes, _ = _jax_stream(jgen, params, vq, frames)
    run = make_scan_stream(tgen, tvq, backend=backend, frame_size=frame_size, device="cpu")
    assert run.backend == "eager"
    got, _, codes = run.run_with_codes(run.init_cache(),
                                       torch.from_numpy(frames[:, None, :, None]))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL_SMALL)
    np.testing.assert_array_equal(codes.numpy(), ref_codes)
    audio, _ = run(run.init_cache(), torch.from_numpy(frames[:, None, :, None]))
    np.testing.assert_array_equal(audio.numpy(), got.numpy())


def test_scan_stream_cache_continues_across_dispatches(rng):
    jgen, params, vq, tgen, tvq = _pair(seed=9)
    frames = _frames(rng, 5, 300)
    ref, ref_codes, _ = _jax_stream(jgen, params, vq, frames)
    run = make_scan_stream(tgen, tvq, device="cpu")
    x = torch.from_numpy(frames[:, None, :, None])
    first, cache, c1 = run.run_with_codes(run.init_cache(), x[:2])
    second, _, c2 = run.run_with_codes(cache, x[2:])
    np.testing.assert_allclose(torch.cat([first, second]).numpy()[:, 0, :, 0], ref,
                               atol=ATOL_SMALL)
    np.testing.assert_array_equal(torch.cat([c1, c2]).numpy(), ref_codes)


@pytest.mark.parametrize("on_cuda,batch,expected", [
    (True, 1, "cuda"), (False, 1, "eager"), (True, 4, "cuda"), (False, 4, "eager")])
def test_auto_routes_the_codec_like_jax(on_cuda, batch, expected):
    """As the JAX router, except that B > 1 on the card takes the kernel route:
    the JAX router's XLA choice there is a TPU v5e measurement."""
    got = runtime.resolve_scan_backend("auto", on_cuda=on_cuda, batch=batch, use_pqc=True)
    assert got == expected
    want_jax = "xla" if batch > 1 else {"cuda": "pallas", "eager": "xla"}[got]
    assert want_jax == jrt.resolve_scan_backend(
        "auto", on_accelerator=on_cuda, batch=batch, use_pqc=True)


def test_codec_refuses_the_chain_route_and_the_cpu_kernels():
    _, _, _, tgen, tvq = _pair()
    with pytest.raises(ValueError, match="without-PQC"):
        make_scan_stream(tgen, tvq, backend="cuda_chain", device="cpu")
    with pytest.raises(ValueError, match="CUDA kernels"):
        make_scan_stream(tgen, tvq, backend="cuda", frame_size=600, device="cpu")


@pytest.mark.parametrize("frame_size,reason", [
    (None, "no frame_size given"), (601, "multiple of the hop")])
def test_codec_cuda_route_raises_where_it_cannot_run(frame_size, reason):
    """The codec's 'cuda' route does not give way to the plain modules: it
    raises with the reason before it looks at the device."""
    _, _, _, tgen, tvq = _pair()
    with pytest.raises(ValueError, match=reason):
        make_scan_stream(tgen, tvq, backend="cuda", frame_size=frame_size, device="cpu")


# ---------------------------------------------------------------- tx / rx


def test_transmitter_and_receiver_match_jax(rng):
    jgen, params, vq, tgen, tvq = _pair(seed=10)
    chunks = rng.standard_normal((3, 1, jgen.hop * 2, 1)).astype(np.float32) * 0.3
    jtx = jrt.StreamingTransmitter(jgen, params, vq)
    jrx = jrt.StreamingReceiver(jgen, params, vq)
    ttx = runtime.StreamingTransmitter(tgen, tvq, device="cpu")
    trx = runtime.StreamingReceiver(tgen, tvq, device="cpu")
    jprime = jtx.initial_encoder(jgen.receptive_length)
    tprime = ttx.initial_encoder(tgen.receptive_length)
    np.testing.assert_array_equal(tprime.numpy(), np.asarray(jprime))
    np.testing.assert_allclose(trx.initial_decoder(tprime).numpy(),
                               np.asarray(jrx.initial_decoder(jprime)), atol=ATOL_SMALL)
    for chunk in chunks:
        jidx = jtx.encode(jnp.asarray(chunk))
        tidx = ttx.encode(torch.from_numpy(chunk))
        assert tidx.dtype == torch.int32 and tuple(tidx.shape) == (3, 1, 2)
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
        np.testing.assert_allclose(trx.decode(tidx).numpy(), np.asarray(jrx.decode(jidx)),
                                   atol=ATOL_SMALL)
    ttx.reset_buffer()
    trx.reset_buffer()
    assert not any(bool(t.any()) for t in jax.tree_util.tree_leaves(ttx.cache))


def test_transmitter_codes_equal_the_scan_streams(rng):
    _, _, _, tgen, tvq = _pair(seed=11)
    frames = _frames(rng, 3, 600)
    run = make_scan_stream(tgen, tvq, device="cpu")
    audio, _, codes = run.run_with_codes(run.init_cache(),
                                         torch.from_numpy(frames[:, None, :, None]))
    tx = runtime.StreamingTransmitter(tgen, tvq, device="cpu")
    rx = runtime.StreamingReceiver(tgen, tvq, device="cpu")
    for i, f in enumerate(frames):
        idx = tx.encode(torch.from_numpy(f[None, :, None]))
        np.testing.assert_array_equal(idx[:, 0].t().numpy(), codes[i].numpy())
        np.testing.assert_allclose(rx.decode(idx)[0, :, 0].numpy(), audio[i, 0, :, 0].numpy(),
                                   atol=1e-6)


def test_receiver_rejects_codes_outside_their_book():
    _, _, _, tgen, tvq = _pair()
    rx = runtime.StreamingReceiver(tgen, tvq, device="cpu")
    book_k = PQC_TOPOLOGY["codebook_size"]
    good = torch.tensor([[[0]], [[book_k]], [[2 * book_k]]], dtype=torch.int32)
    assert tuple(rx.decode(good).shape) == (1, tgen.hop, 1)
    for bad in ([0, 0, 2 * book_k], [0, book_k, 3 * book_k], [-1, book_k, 2 * book_k]):
        with pytest.raises(ValueError, match="outside its book"):
            rx.decode(torch.tensor(bad, dtype=torch.int32).reshape(3, 1, 1))
    with pytest.raises(ValueError, match="outside its book"):
        rx.decode(good[:2])


def test_endpoints_take_a_batch(rng):
    _, _, _, tgen, tvq = _pair(seed=12)
    x = torch.from_numpy(rng.standard_normal((2, tgen.hop, 1)).astype(np.float32))
    tx = runtime.StreamingTransmitter(tgen, tvq, batch=2, device="cpu")
    rx = runtime.StreamingReceiver(tgen, tvq, batch=2, device="cpu")
    idx = tx.encode(x)
    assert tuple(idx.shape) == (3, 2, 1)
    assert tuple(rx.decode(idx).shape) == (2, tgen.hop, 1)


# ---------------------------------------------------------------- flagship and params


def test_flagship_codec_matches_jax_xla(rng):
    """Two 25 ms frames through the full-width symAD codec."""
    gp = load_config(CODEC_CONFIG)["generator_params"]
    jgen, params, vq, tgen, tvq = _pair(seed=2, **gp)
    frames = _frames(rng, 2, 1200)
    ref, ref_codes, _ = _jax_stream(jgen, params, vq, frames)
    run = make_scan_stream(tgen, tvq, frame_size=1200, device="cpu")
    got, _, codes = run.run_with_codes(run.init_cache(),
                                       torch.from_numpy(frames[:, None, :, None]))
    assert tuple(codes.shape) == (2, 4, 8)
    np.testing.assert_array_equal(codes.numpy(), ref_codes)
    np.testing.assert_allclose(got.numpy()[:, 0, :, 0], ref, atol=ATOL_FLAGSHIP)


def test_params_bridge_rejects_mismatches():
    jgen = JaxGenerator(use_pqc=True, **PQC_TOPOLOGY)
    params, vq = (_np_tree(t) for t in jgen.init(jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match="use_pqc=False"):
        from_jax_params(AudioDecGenerator(use_pqc=False, device="cpu", **PQC_TOPOLOGY), params)
    denoiser_params = _np_tree(JaxGenerator(use_pqc=False, **PQC_TOPOLOGY).init(
        jax.random.PRNGKey(0))[0])
    with pytest.raises(ValueError, match="use_pqc=True"):
        from_jax_params(AudioDecGenerator(device="cpu", **PQC_TOPOLOGY), denoiser_params)
    wider = dict(PQC_TOPOLOGY, code_dim=8)
    with pytest.raises(ValueError, match="does not fit"):
        from_jax_params(AudioDecGenerator(device="cpu", **wider), params)
    gen = AudioDecGenerator(device="cpu", **wider)
    with pytest.raises(ValueError, match="does not fit the generator"):
        vq_state_from_jax(vq, gen)
    with pytest.raises(ValueError, match="do not fit one another"):
        vq_state_from_jax(VQState(vq.embed, vq.cluster_size[:, :5], vq.embed_avg))
    with pytest.raises(ValueError, match=r"\(L, D, K\)"):
        vq_state_from_jax(VQState(vq.embed[0], vq.cluster_size[0], vq.embed_avg[0]))
    state = vq_state_from_jax(vq)
    assert all(t.dtype == torch.float32 and t.device.type == "cpu" for t in state)


def test_mega_topology_names_the_pqc_layers():
    _, _, _, tgen, _ = _pair()
    assert mega_kernel.mega_topology_error(tgen, tgen.hop) is None
    tgen.projector.conv.dilation = 2
    assert "projector" in mega_kernel.mega_topology_error(tgen, tgen.hop)
