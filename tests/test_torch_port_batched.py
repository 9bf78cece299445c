"""The port's multi-stream path (B streams per dispatch) against the JAX
package, on the CPU.

Port ``make_mega_stream_batched`` / ``make_mega_stream_stacked`` against the
JAX package's K3a / K3b in interpret mode; ``make_scan_stream(batch=B)``
against JAX ``make_scan_stream(batch=B, backend='xla')``; the single-card
``make_sharded_stream`` against JAX ``make_sharded_stream`` on a one-device
mesh; the codec endpoints at B = 3. JAX params and ``VQState`` cross with
``from_jax_params`` / ``vq_state_from_jax``; inputs come from numpy; weights
are f32. Tolerances: wire codes exact; audio atol 2e-5 at the small
topology (tests/test_mega_kernel.py:177) and 3e-4 at the flagship with B = 2
(tests/test_mega_stacked.py:180), the JAX package's own; 1e-6 between
dispatch splits of one stream; other streams bit for bit when one stream's
input changes. The kernel modules run their plain versions here.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from conftest import SMALL_TOPOLOGY
from dl_speech_enhancement_tpu.models import AudioDecGenerator as JaxGenerator
from dl_speech_enhancement_tpu.ops.mega_kernel import (
    make_mega_stream_batched as jax_batched,
)
from dl_speech_enhancement_tpu.ops.mega_stacked import (
    make_mega_stream_stacked as jax_stacked,
)
from dl_speech_enhancement_tpu.parallel import make_mesh
from dl_speech_enhancement_tpu.parallel import make_sharded_stream as jax_sharded
from dl_speech_enhancement_tpu.stream import runtime as jrt
from dl_speech_enhancement_tpu_torch.models import AudioDecGenerator
from dl_speech_enhancement_tpu_torch.ops.mega_kernel import (
    join_halves,
    make_mega_stream,
    make_mega_stream_batched,
    mega_decoder,
    mega_encoder,
)
from dl_speech_enhancement_tpu_torch.ops.mega_stacked import make_mega_stream_stacked
from dl_speech_enhancement_tpu_torch.parallel import make_sharded_stream
from dl_speech_enhancement_tpu_torch.stream import runtime
from dl_speech_enhancement_tpu_torch.stream.runtime import (
    make_scan_stream,
    resolve_scan_backend,
)
from dl_speech_enhancement_tpu_torch.utils.config import load_config
from dl_speech_enhancement_tpu_torch.utils.jax_params import (
    from_jax_params,
    vq_state_from_jax,
)
from torch_port_threads import one_thread  # noqa: F401

PQC_TOPOLOGY = dict(SMALL_TOPOLOGY, codebook_num=3)
REPO = os.path.join(os.path.dirname(__file__), "..")
ATOL_SMALL = 2e-5
ATOL_FLAGSHIP_BATCHED = 3e-4
ATOL_SPLIT = 1e-6


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jnp_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _pair(use_pqc, seed, **topology):
    """(JAX generator, its params and VQState as numpy (VQState None without
    PQC), the port's generator and VQState on the CPU)."""
    topology = topology or (PQC_TOPOLOGY if use_pqc else SMALL_TOPOLOGY)
    jgen = JaxGenerator(use_pqc=use_pqc, **topology)
    params, vq = (_np_tree(t) for t in jgen.init(jax.random.PRNGKey(seed)))
    tgen = from_jax_params(AudioDecGenerator(use_pqc=use_pqc, device="cpu", **topology),
                           params)
    if not use_pqc:
        return jgen, params, None, tgen, None
    return jgen, params, vq, tgen, vq_state_from_jax(vq, tgen)


def _frames(rng, n, batch, chunk):
    return rng.standard_normal((n, batch, chunk)).astype(np.float32) * 0.3


def _jax_streams(jgen, params, vq, frames):
    """The JAX per-frame chain on B streams at once (XLA): audio (N, B, F)
    and, with PQC, codes (N, B, F / hop, L)."""
    cache = jgen.init_cache(frames.shape[1])
    flat_cb = jgen.flat_codebook(_jnp_tree(vq)) if vq is not None else None
    outs, codes = [], []
    for x in frames:
        z, ec = jgen.encode_step(params, cache, jnp.asarray(x[:, :, None]))
        cache.update(ec)
        if vq is not None:
            idx = jgen.quantize(_jnp_tree(vq), z)  # (L, B, T)
            codes.append(np.asarray(idx).transpose(1, 2, 0))
            z = jgen.lookup(flat_cb, idx)
        y, dc = jgen.decode_step(params, cache, z)
        cache.update(dc)
        outs.append(np.asarray(y)[:, :, 0])
    return np.stack(outs), (np.stack(codes) if codes else None)


def _run(run, cache, frames):
    """(audio, cache, codes or None) of one dispatch of a batched builder."""
    out, new, *codes = run(cache, torch.from_numpy(frames))
    return out, new, (codes[0] if codes else None)


# ---------------------------------------------------------------- K3a / K3b


@pytest.mark.parametrize("use_pqc,batch,hops,n", [(False, 3, 3, 4), (True, 2, 2, 3)])
def test_mega_stream_batched_matches_jax_interpret(rng, use_pqc, batch, hops, n):
    """tests/test_mega_kernel.py:164-213: B streams through the JAX K3a
    kernel (interpret mode) and through the port's batched builder."""
    jgen, params, vq, tgen, tvq = _pair(use_pqc, seed=5 + use_pqc)
    chunk = jgen.hop * hops
    frames = _frames(rng, n, batch, chunk)
    jinit, jrun = jax_batched(jgen, params, chunk, batch=batch, weight_dtype=jnp.float32,
                              interpret=True,
                              vq_state=_jnp_tree(vq) if use_pqc else None)
    ref = jrun(jinit(), jnp.asarray(frames))
    tinit, trun = make_mega_stream_batched(tgen, chunk, batch, torch.float32, tvq)
    got, cache, codes = _run(trun, tinit(), frames)
    assert tuple(got.shape) == frames.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref[0]), atol=ATOL_SMALL)
    assert all(tuple(t.shape[:1]) == (batch,) for t in cache.values())
    if use_pqc:
        assert codes.dtype == torch.int32
        assert tuple(codes.shape) == (n, batch, chunk // jgen.hop, 3)
        np.testing.assert_array_equal(codes.numpy(), np.asarray(ref[2]))
    # and B single-stream XLA runs, stream by stream
    jys, jcodes = _jax_streams(jgen, params, vq, frames)
    np.testing.assert_allclose(got.numpy(), jys, atol=ATOL_SMALL)
    if use_pqc:
        np.testing.assert_array_equal(codes.numpy(), jcodes)


@pytest.mark.parametrize("use_pqc,hops,n", [(False, 4, 3), (True, 3, 3)])
def test_mega_stream_stacked_matches_jax_interpret(rng, use_pqc, hops, n):
    """tests/test_mega_stacked.py: three streams through the JAX K3b
    pipeline (interpret mode) and the port's stacked builder."""
    batch = 3
    jgen, params, vq, tgen, tvq = _pair(use_pqc, seed=7 + use_pqc)
    chunk = jgen.hop * hops
    frames = _frames(rng, n, batch, chunk)
    jinit, jrun = jax_stacked(jgen, params, chunk, batch=batch, weight_dtype=jnp.float32,
                              interpret=True, vq_state=_jnp_tree(vq) if use_pqc else None)
    ref = jrun(jinit(), jnp.asarray(frames))
    tinit, trun = make_mega_stream_stacked(tgen, chunk, batch, torch.float32, tvq)
    got, _, codes = _run(trun, tinit(), frames)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref[0]), atol=ATOL_SMALL)
    if use_pqc:
        np.testing.assert_array_equal(codes.numpy(), np.asarray(ref[2]))


@pytest.mark.parametrize("use_pqc", [False, True])
def test_batched_cache_continues_across_dispatches(rng, use_pqc):
    _, _, _, tgen, tvq = _pair(use_pqc, seed=9)
    chunk, batch = tgen.hop * 2, 3
    frames = _frames(rng, 4, batch, chunk)
    init, run = make_mega_stream_batched(tgen, chunk, batch, torch.float32, tvq)
    whole, _, codes_w = _run(run, init(), frames)
    first, cache, codes_1 = _run(run, init(), frames[:2])
    second, _, codes_2 = _run(run, cache, frames[2:])
    np.testing.assert_allclose(torch.cat([first, second]).numpy(), whole.numpy(),
                               atol=ATOL_SPLIT)
    if use_pqc:
        np.testing.assert_array_equal(torch.cat([codes_1, codes_2]).numpy(),
                                      codes_w.numpy())


@pytest.mark.parametrize("use_pqc", [False, True])
def test_streams_do_not_leak_into_each_other(rng, use_pqc):
    """Changing stream 0's audio (and its carried cache) leaves every other
    stream's audio and codes bit for bit as they were."""
    _, _, _, tgen, tvq = _pair(use_pqc, seed=10)
    chunk, batch = tgen.hop * 2, 4
    frames = _frames(rng, 3, batch, chunk)
    init, run = make_mega_stream_batched(tgen, chunk, batch, torch.float32, tvq)
    out, cache, codes = _run(run, init(), frames[:2])
    again, _, codes_a = _run(run, cache, frames[2:])
    moved = frames.copy()
    moved[:, 0] = _frames(rng, 3, 1, chunk)[:, 0]
    out_m, cache_m, codes_m = _run(run, init(), moved[:2])
    again_m, _, codes_am = _run(run, cache_m, moved[2:])
    assert not torch.equal(cache_m["enc_in"][0], cache["enc_in"][0])
    assert torch.equal(out_m[:, 1:], out[:, 1:])
    assert torch.equal(again_m[:, 1:], again[:, 1:])
    for name in cache:
        assert torch.equal(cache_m[name][1:], cache[name][1:]), name
    if use_pqc:
        assert torch.equal(codes_m[:, 1:], codes[:, 1:])
        assert torch.equal(codes_am[:, 1:], codes_a[:, 1:])


@pytest.mark.parametrize("use_pqc", [False, True])
def test_one_stream_of_the_batched_builder_is_make_mega_stream(rng, use_pqc):
    _, _, _, tgen, tvq = _pair(use_pqc, seed=11)
    chunk = tgen.hop * 2
    frames = _frames(rng, 3, 1, chunk)
    init_b, run_b = make_mega_stream_batched(tgen, chunk, 1, torch.float32, tvq)
    init_1, run_1 = make_mega_stream(tgen, chunk, torch.float32, tvq)
    got, cache, codes = _run(run_b, init_b(), frames)
    one, cache_1, *codes_1 = run_1(init_1(), torch.from_numpy(frames[:, 0]))
    assert torch.equal(got[:, 0], one)
    assert set(cache) == set(cache_1)
    assert all(torch.equal(cache[k][0], cache_1[k]) for k in cache)
    if use_pqc:
        assert torch.equal(codes[:, 0], codes_1[0])


def test_halves_join_across_generators(rng):
    """The encoder half of one codec and the decoder half of another hand
    over int32 codes; halves that disagree on the wire are refused."""
    _, _, _, tx, tx_vq = _pair(True, seed=12)
    _, _, _, rx, rx_vq = _pair(True, seed=13)
    frames = torch.from_numpy(_frames(rng, 2, 2, tx.hop))
    init, run = join_halves(mega_encoder(tx, torch.float32, tx_vq),
                            mega_decoder(rx, torch.float32, rx_vq), 2, "cpu")
    out, _, codes = run(init(), frames)
    cache = tx.init_cache(2)
    rx_cache, flat_cb = rx.init_cache(2), rx.flat_codebook(rx_vq)
    with torch.no_grad():
        for i, f in enumerate(frames):
            z, ec = tx.encode_step(cache, f[:, :, None])
            cache.update(ec)
            idx = tx.quantize(tx_vq, z)
            assert torch.equal(idx.permute(1, 2, 0), codes[i])
            y, dc = rx.decode_step(rx_cache, rx.lookup(flat_cb, idx))
            rx_cache.update(dc)
            np.testing.assert_allclose(out[i].numpy(), y[:, :, 0].numpy(), atol=ATOL_SMALL)
    _, _, _, denoiser, _ = _pair(False, seed=12)
    with pytest.raises(ValueError, match="wire codes"):
        join_halves(mega_encoder(tx, torch.float32, tx_vq),
                    mega_decoder(denoiser, torch.float32), 2, "cpu")


# ---------------------------------------------------------------- entry points


@pytest.mark.parametrize("use_pqc", [False, True])
def test_scan_stream_batched_matches_jax_xla(rng, use_pqc):
    jgen, params, vq, tgen, tvq = _pair(use_pqc, seed=14)
    batch, chunk = 3, 600
    frames = _frames(rng, 4, batch, chunk)[..., None]
    jrun = jrt.make_scan_stream(jgen, params, _jnp_tree(vq) if use_pqc else None,
                                batch=batch, backend="xla")
    ref, _ = jrun(jrun.init_cache(), jnp.asarray(frames))
    for backend in ("eager", "auto"):
        run = make_scan_stream(tgen, tvq, batch=batch, backend=backend, frame_size=chunk,
                               device="cpu")
        assert run.backend == "eager"
        got, cache = run(run.init_cache(), torch.from_numpy(frames[:2]))
        rest, _ = run(cache, torch.from_numpy(frames[2:]))
        np.testing.assert_allclose(torch.cat([got, rest]).numpy(), np.asarray(ref),
                                   atol=ATOL_SMALL)
    if use_pqc:
        _, ref_codes = _jax_streams(jgen, params, vq, frames[..., 0])
        _, _, codes = run.run_with_codes(run.init_cache(), torch.from_numpy(frames))
        assert codes.dtype == torch.int32
        np.testing.assert_array_equal(codes.numpy(), ref_codes)


@pytest.mark.parametrize("backend,on_cuda,batch,expected", [
    ("auto", True, 16, "cuda"), ("auto", True, 64, "cuda"), ("auto", False, 16, "eager"),
    ("cuda", False, 16, "cuda"), ("eager", True, 16, "eager"),
    ("cuda_chain", True, 16, "cuda_chain"),
])
@pytest.mark.parametrize("use_pqc", [False, True])
def test_resolve_scan_backend_for_many_streams(backend, on_cuda, batch, expected, use_pqc):
    assert resolve_scan_backend(backend, on_cuda=on_cuda, batch=batch,
                                use_pqc=use_pqc) == expected


@pytest.mark.parametrize("use_pqc", [False, True])
@pytest.mark.parametrize("backend,frame_size,reason", [
    ("cuda_chain", 600, "runs one stream"),
    ("cuda", None, "no frame_size given"),
    ("cuda", 601, "multiple of the hop"),
])
def test_many_streams_refuse_what_the_card_route_cannot_run(backend, frame_size, reason,
                                                           use_pqc):
    """batch > 1 does not give way to the plain modules: the chain route
    and a 'cuda' route it cannot run raise, naming the reason, before the
    device is looked at."""
    _, _, _, tgen, tvq = _pair(use_pqc, seed=0)
    if backend == "cuda_chain" and use_pqc:
        reason = "without-PQC"
    with pytest.raises(ValueError, match=reason):
        make_scan_stream(tgen, tvq, batch=3, backend=backend, frame_size=frame_size,
                         device="cpu")


def test_scan_stream_checks_the_batch_axis(rng):
    _, _, _, tgen, _ = _pair(False, seed=0)
    run = make_scan_stream(tgen, batch=3, device="cpu")
    with pytest.raises(ValueError, match=r"\(N, 3, F, C\)"):
        run(run.init_cache(), torch.zeros(2, 2, 300, 1))
    with pytest.raises(ValueError, match="at least 1"):
        make_scan_stream(tgen, batch=0, device="cpu")
    init, brun = make_mega_stream_batched(tgen, 300, 3)
    with pytest.raises(ValueError, match=r"\(N, 3, F\)"):
        brun(init(), torch.zeros(2, 2, 300))


# ---------------------------------------------------------------- fleet


def _fleet_frames(rng, batch, chunk, n):
    """(N, B, F, 1) frames cut from B streams of audio, as
    tests/test_parallel.py:252-257 does."""
    x = rng.standard_normal((batch, chunk * n, 1)).astype(np.float32) * 0.3
    return x.reshape(batch, -1, chunk, 1).transpose(1, 0, 2, 3).copy()


@pytest.mark.parametrize("use_pqc", [False, True])
def test_sharded_stream_matches_jax_on_one_device(rng, use_pqc):
    """tests/test_parallel.py:242-278 on a one-device mesh: the fleet equals
    JAX's, the cache continues across dispatches, and codes are exact (the
    fleet's audio and codes equal the batched builder's at f32)."""
    jgen, params, vq, tgen, tvq = _pair(use_pqc, seed=15)
    batch, chunk = 4, jgen.hop * 2
    frames = _fleet_frames(rng, batch, chunk, 4)
    jrun = jax_sharded(jgen, params, _jnp_tree(vq) if use_pqc else None,
                       mesh=make_mesh(1), batch=batch)
    ref, _ = jrun(jrun.init_cache(), jrun.shard_frames(frames))
    run = make_sharded_stream(tgen, tvq, batch=batch, device="cpu")
    assert run.batch == batch
    x = run.shard_frames(frames)
    assert x.dtype == torch.float32 and x.device.type == "cpu"
    got, cache = run(run.init_cache(), x[:2])
    rest, _ = run(cache, x[2:])
    np.testing.assert_allclose(torch.cat([got, rest]).numpy(), np.asarray(ref),
                               atol=ATOL_SMALL)
    init, brun = make_mega_stream_batched(tgen, chunk, batch, torch.float32, tvq)
    assert torch.equal(brun(init(), x[..., 0])[0], run(run.init_cache(), x)[0][..., 0])


def test_sharded_stream_asymmetric_codec_rx(rng):
    """tests/test_parallel.py:350-395: the tx codec quantizes with its own
    books, a different rx codec looks the codes up in its own books and
    decodes."""
    jgen, params, vq, tgen, tvq = _pair(True, seed=3)
    _, rx_params, rx_vq, rx_gen, rx_tvq = _pair(True, seed=4)
    batch, chunk = 8, jgen.hop * 2
    frames = _fleet_frames(rng, batch, chunk, 4)
    jrun = jax_sharded(jgen, params, _jnp_tree(vq), mesh=make_mesh(1), batch=batch,
                       rx_gen=jgen, rx_params=rx_params, rx_vq_state=_jnp_tree(rx_vq))
    ref, _ = jrun(jrun.init_cache(), jrun.shard_frames(frames))
    run = make_sharded_stream(tgen, tvq, batch=batch, device="cpu", rx_gen=rx_gen,
                              rx_vq_state=rx_tvq)
    got, _ = run(run.init_cache(), run.shard_frames(frames))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL_SMALL)


def test_sharded_stream_checks_its_arguments():
    """The JAX fleet's argument checks (parallel/serve.py:75-93), a vocoder
    receiver that is not a HiFiGANGenerator, and what the single-card fleet
    does not serve yet."""
    _, _, _, tgen, tvq = _pair(True, seed=0)
    _, _, _, denoiser, _ = _pair(False, seed=0)
    with pytest.raises(ValueError, match="not both"):
        make_sharded_stream(tgen, tvq, batch=2, device="cpu", vocoder=object(),
                            rx_gen=tgen, rx_vq_state=tvq)
    with pytest.raises(ValueError, match="HiFiGANGenerator"):
        make_sharded_stream(tgen, tvq, batch=2, device="cpu", vocoder=object())
    with pytest.raises(ValueError, match="requires rx_gen"):
        make_sharded_stream(tgen, tvq, batch=2, device="cpu", rx_vq_state=tvq)
    with pytest.raises(ValueError, match="rx_vq_state"):
        make_sharded_stream(tgen, tvq, batch=2, device="cpu", rx_gen=tgen)
    with pytest.raises(ValueError, match="both use PQC"):
        make_sharded_stream(denoiser, batch=2, device="cpu", rx_gen=tgen)
    with pytest.raises(NotImplementedError, match="'Parallel'"):
        make_sharded_stream(tgen, tvq, batch=2, device=["cpu", "cpu"])
    with pytest.raises(ValueError, match="at least 1"):
        make_sharded_stream(tgen, tvq, batch=0, device="cpu")
    with pytest.raises(ValueError, match="VQState"):
        make_sharded_stream(tgen, batch=2, device="cpu")
    run = make_sharded_stream(tgen, tvq, batch=2, device=["cpu"])
    with pytest.raises(ValueError, match="multiple of the hop"):
        run(run.init_cache(), torch.zeros(1, 2, tgen.hop + 1, 1))
    with pytest.raises(ValueError, match=r"\(N, 2, F, C\)"):
        run(run.init_cache(), torch.zeros(1, 3, tgen.hop, 1))


# ---------------------------------------------------------------- tx / rx


def test_transmitter_and_receiver_take_three_streams(rng):
    jgen, params, vq, tgen, tvq = _pair(True, seed=16)
    batch = 3
    chunks = rng.standard_normal((3, batch, jgen.hop * 2, 1)).astype(np.float32) * 0.3
    jtx = jrt.StreamingTransmitter(jgen, params, vq, batch=batch)
    jrx = jrt.StreamingReceiver(jgen, params, vq, batch=batch)
    ttx = runtime.StreamingTransmitter(tgen, tvq, batch=batch, device="cpu")
    trx = runtime.StreamingReceiver(tgen, tvq, batch=batch, device="cpu")
    for chunk in chunks:
        jidx = jtx.encode(jnp.asarray(chunk))
        tidx = ttx.encode(torch.from_numpy(chunk))
        assert tidx.dtype == torch.int32 and tuple(tidx.shape) == (3, batch, 2)
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
        np.testing.assert_allclose(trx.decode(tidx).numpy(), np.asarray(jrx.decode(jidx)),
                                   atol=ATOL_SMALL)


# ---------------------------------------------------------------- flagship


@pytest.mark.parametrize("config", ["denoise", "autoencoder"])
def test_flagship_batched_matches_jax_xla(rng, config):
    """Two streams of two 25 ms frames through the full-width denoiser and
    codec, against JAX make_scan_stream(batch=2, backend='xla')."""
    gp = load_config(os.path.join(REPO, "configs", config,
                                  "symAD_vctk_48000_hop300.yaml"))["generator_params"]
    use_pqc = config == "autoencoder"
    jgen, params, vq, tgen, tvq = _pair(use_pqc, seed=2, **gp)
    batch, chunk = 2, 1200
    frames = _frames(rng, 2, batch, chunk)
    jrun = jrt.make_scan_stream(jgen, params, _jnp_tree(vq) if use_pqc else None,
                                batch=batch, backend="xla")
    ref, _ = jrun(jrun.init_cache(), jnp.asarray(frames[..., None]))
    init, run = make_mega_stream_batched(tgen, chunk, batch, torch.float32, tvq)
    got, _, codes = _run(run, init(), frames)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref)[..., 0],
                               atol=ATOL_FLAGSHIP_BATCHED)
    if use_pqc:
        _, ref_codes = _jax_streams(jgen, params, vq, frames)
        assert tuple(codes.shape) == (2, batch, 4, 8)
        np.testing.assert_array_equal(codes.numpy(), ref_codes)
