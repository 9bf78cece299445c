"""The PyTorch port's vector quantizers (nn/vq.py) against the JAX package's.

The same seeded numpy codebooks and inputs go through
dl_speech_enhancement_tpu/nn/vq.py and the port, in f32. Tolerances: wire
codes exact; the codebook table and lookups atol 1e-6 (the same values summed
over the layers); one EMA training step atol 1e-5 (statistics of a few
hundred rows), and rtol 1e-6 on the new codebooks, whose unused codewords
are divided by a Laplace-smoothed count near 1e-5 and reach 1e5; so is the
EMA step with ``axis_name`` over two gloo ranks (tests/torch_port_ranks.py).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dl_speech_enhancement_tpu.nn import vq as jvq
from dl_speech_enhancement_tpu_torch.nn import vq as tvq

DIM, LAYERS, BOOK = 16, 3, 32


def _jax_state(seed=0, layers=LAYERS):
    state = jvq.ResidualVQ(DIM, layers, BOOK).init(jax.random.PRNGKey(seed))
    return jax.tree_util.tree_map(np.asarray, state)


def _port_state(state):
    return tvq.VQState(*(torch.from_numpy(np.array(x)) for x in state))


def _x(rng, *shape):
    return rng.standard_normal(shape + (DIM,)).astype(np.float32) * 1.5


@pytest.mark.parametrize("flatten_idx", [False, True])
def test_forward_index_matches_jax(rng, flatten_idx):
    state = _jax_state()
    x = _x(rng, 2, 25)
    jq, jidx = jvq.ResidualVQ(DIM, LAYERS, BOOK).forward_index(
        jax.tree_util.tree_map(jnp.asarray, state), jnp.asarray(x), flatten_idx=flatten_idx)
    tq, tidx = tvq.ResidualVQ(DIM, LAYERS, BOOK).forward_index(
        _port_state(state), torch.from_numpy(x), flatten_idx=flatten_idx)
    assert tidx.dtype == torch.int32 and tuple(tidx.shape) == (LAYERS, 2, 25)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-6)
    # the codes use many codewords, so equality says something
    assert len(np.unique(np.asarray(jidx)[0])) >= 10


def test_quantizer_encode_and_decode_match_jax(rng):
    state = _jax_state(seed=1)
    x = _x(rng, 3, 17)
    jquant = jvq.Quantizer(DIM, LAYERS, BOOK)
    tquant = tvq.Quantizer(DIM, LAYERS, BOOK)
    jstate = jax.tree_util.tree_map(jnp.asarray, state)
    _, jidx = jquant.encode(jstate, jnp.asarray(x))
    _, tidx = tquant.encode(_port_state(state), torch.from_numpy(x))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    jflat = jquant.rvq.flat_codebook(jstate)
    tflat = tquant.rvq.flat_codebook(_port_state(state))
    np.testing.assert_allclose(tflat.numpy(), np.asarray(jflat), atol=1e-6)
    assert tuple(tflat.shape) == (LAYERS * BOOK, DIM)
    jzq = jquant.decode(jflat, jidx)
    tzq = tquant.decode(tflat, tidx)
    np.testing.assert_allclose(tzq.numpy(), np.asarray(jzq), atol=1e-6)
    _, jraw = jquant.inference(jstate, jnp.asarray(x))
    _, traw = tquant.inference(_port_state(state), torch.from_numpy(x))
    np.testing.assert_array_equal(traw.numpy(), np.asarray(jraw))


@pytest.mark.parametrize("train", [True, False])
def test_residual_vq_call_matches_jax(rng, train):
    """One ``__call__``: quantized output, the new EMA state, losses and
    perplexities."""
    state = _jax_state(seed=2)
    x = _x(rng, 4, 50)
    jout = jvq.ResidualVQ(DIM, LAYERS, BOOK)(
        jax.tree_util.tree_map(jnp.asarray, state), jnp.asarray(x), train=train)
    tout = tvq.ResidualVQ(DIM, LAYERS, BOOK)(_port_state(state), torch.from_numpy(x),
                                             train=train)
    jq, jstate, jloss, jppl = jout
    tq, tstate, tloss, tppl = tout
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-5)
    for a, b in zip(tstate, jstate, strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss), atol=1e-5)
    np.testing.assert_allclose(tppl.numpy(), np.asarray(jppl), atol=1e-5)
    if not train:
        for a, b in zip(tstate, _port_state(state)):
            assert torch.equal(a, b)


def test_single_layer_ema_step_matches_jax(rng):
    jlayer, tlayer = jvq.VectorQuantizeEMA(DIM, BOOK), tvq.VectorQuantizeEMA(DIM, BOOK)
    state = jax.tree_util.tree_map(np.asarray, jlayer.init(jax.random.PRNGKey(3)))
    x = _x(rng, 300)
    _, jnew, jloss, jppl = jlayer(jax.tree_util.tree_map(jnp.asarray, state),
                                  jnp.asarray(x), train=True)
    _, tnew, tloss, tppl = tlayer(_port_state(state), torch.from_numpy(x), train=True)
    for a, b in zip(tnew, jnew, strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(float(tloss), float(jloss), atol=1e-5)
    np.testing.assert_allclose(float(tppl), float(jppl), atol=1e-5)


def test_straight_through_gradient_matches_jax(rng):
    """Only the first layer's straight-through path reaches the input."""
    state = _jax_state(seed=4)
    x = _x(rng, 2, 9)
    w = rng.standard_normal(x.shape).astype(np.float32)
    jstate = jax.tree_util.tree_map(jnp.asarray, state)
    rvq = jvq.ResidualVQ(DIM, LAYERS, BOOK)
    jgrad = jax.grad(lambda v: jnp.sum(rvq(jstate, v, train=False)[0] * w))(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    q, *_ = tvq.ResidualVQ(DIM, LAYERS, BOOK)(_port_state(state), tx, train=False)
    (q * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgrad), atol=1e-6)


def test_ties_pick_the_lowest_index():
    embed = np.zeros((DIM, 6), np.float32)
    embed[0, [1, 3, 4]] = 1.0  # three equal nearest codewords
    embed[1, 5] = 5.0
    flat = np.zeros((2, DIM), np.float32)
    flat[:, 0] = 1.0
    jind, _ = jvq._quantize_core(jnp.asarray(embed), jnp.asarray(flat))
    tind, tq = tvq._quantize_core(torch.from_numpy(embed), torch.from_numpy(flat))
    assert tind.tolist() == np.asarray(jind).tolist() == [1, 1]
    np.testing.assert_array_equal(tq.numpy(), embed.T[[1, 1]])


def test_init_is_seeded_normal():
    rvq = tvq.ResidualVQ(DIM, LAYERS, 256)
    a = rvq.init(torch.Generator().manual_seed(5), device="cpu")
    b = rvq.init(seed=5, device="cpu")
    c = rvq.init(seed=6, device="cpu")
    assert tuple(a.embed.shape) == (LAYERS, DIM, 256)
    assert tuple(a.cluster_size.shape) == (LAYERS, 256)
    assert torch.equal(a.embed, b.embed) and not torch.equal(a.embed, c.embed)
    assert torch.equal(a.embed, a.embed_avg) and not bool(a.cluster_size.any())
    assert abs(float(a.embed.mean())) < 0.05 and abs(float(a.embed.std()) - 1) < 0.05


def test_init_defaults_to_the_card():
    rvq = tvq.ResidualVQ(DIM, LAYERS, 16)
    if torch.cuda.is_available():
        assert rvq.init(seed=0).embed.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            rvq.init(seed=0)
    assert tvq.Quantizer(DIM, LAYERS, 16).init(seed=0, device="cpu").embed.device.type == "cpu"


def _jax_sharded_update(layer, state, x):
    """JAX's EMA step with ``axis_name`` over a 2-device ``shard_map``, as
    tests/test_parallel.py:149 runs it."""
    from jax.sharding import Mesh, PartitionSpec as P

    mesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))

    def local(st, xs):
        _, new, _, ppl = layer(st, xs, train=True, axis_name="data")
        return new, ppl

    return jax.shard_map(local, mesh=mesh, in_specs=(P(), P("data")), out_specs=(P(), P()))(
        jax.tree_util.tree_map(jnp.asarray, state), jnp.asarray(x))


def test_axis_name_over_two_ranks_equals_the_joined_batch(rng, tmp_path):
    """``axis_name`` the data group of two gloo ranks, each with its half of
    the rows: the EMA step (counts and codeword sums summed over the ranks)
    and the perplexity (histogram averaged before the entropy) equal one
    process's on the joined batch, and JAX's ``psum`` / ``pmean`` under a
    2-device ``shard_map``; the commitment loss is each rank's local mean."""
    from torch_port_ranks import run_here, run_ranks

    single = jax.tree_util.tree_map(
        np.asarray, jvq.VectorQuantizeEMA(DIM, BOOK).init(jax.random.PRNGKey(5)))
    cases = {"single": ("vq_update", {"kind": "single", "dim": DIM, "layers": 1, "book": BOOK,
                                      "state": single, "x": _x(rng, 8, 10)}),
             "residual": ("vq_update", {"kind": "residual", "dim": DIM, "layers": LAYERS,
                                        "book": BOOK, "state": _jax_state(seed=6),
                                        "x": _x(rng, 8, 10)})}
    ranks = run_ranks(2, cases, tmp_path)
    layers = {"single": jvq.VectorQuantizeEMA(DIM, BOOK),
              "residual": jvq.ResidualVQ(DIM, LAYERS, BOOK)}
    for key, (name, kw) in cases.items():
        one = run_here(name, **kw)
        jnew, jppl = _jax_sharded_update(layers[key], kw["state"], kw["x"])
        for got in (r[key] for r in ranks):
            for f in one["vq"]:
                np.testing.assert_allclose(got["vq"][f], one["vq"][f], rtol=1e-6, atol=1e-5,
                                           err_msg=f"{key}.{f}")
                np.testing.assert_allclose(got["vq"][f], np.asarray(getattr(jnew, f)),
                                           rtol=1e-6, atol=1e-5, err_msg=f"{key}.{f}")
            np.testing.assert_allclose(got["ppl"], one["ppl"], rtol=1e-6, atol=1e-5)
            np.testing.assert_allclose(got["ppl"], np.asarray(jppl), rtol=1e-6, atol=1e-5)
        halves = [run_here(name, **dict(kw, x=kw["x"][h * 4:(h + 1) * 4])) for h in (0, 1)]
        for r, half in zip(ranks, halves):
            np.testing.assert_allclose(r[key]["loss"], half["loss"], rtol=1e-6)
