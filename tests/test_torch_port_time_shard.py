"""Time-sharded (sequence-parallel) training of the port, parallel/time_shard.py,
over gloo ranks on the host: against the port's one-process
``blocked_reference_step`` and the JAX package's ``make_time_sharded_steps``
and ``time_sharded_forward`` on its CPU mesh.

Counterparts of tests/test_time_shard.py: the forward beyond the warm-up
(:53) and the train step against the blocked objective (:82), both with and
without PQC; ``eval`` (:134); the 2-D ``(data, time)`` layout (:152); a
shard shorter than the halo (:194); plain SGD, which a gradient off by the
number of ranks would not pass (:204). The 1-D cases run on 2 time shards
in one launch of 2 ranks, the 2-D case on 2 x 2 in one launch of 4
(tests/torch_port_ranks.py).

Tolerances, JAX's (tests/test_time_shard.py): the forward beyond the
warm-up atol 2e-5 rtol 1e-4 (against JAX's sharded forward, everywhere);
the train step's loss rtol 1e-4 each of 3 steps and the parameters and
codebooks after the first atol 1e-5 (2-D: loss rtol 2e-5, parameters atol
3e-5 rtol 1e-3); SGD loss rtol 1e-5, parameters atol 1e-6 rtol 1e-4.
The Adam steps' parameters are held against the port's blocked step (the
same sums, shard by shard); against JAX their loss and codebooks, and the
SGD step's parameters, which hold the gradient itself (Adam's first step
is about lr * g / (|g| + eps) under the clip's factor: at a gradient near
eps two packages' last bits move it by up to lr).
"""

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from dl_speech_enhancement_tpu.models import AudioDecGenerator as JaxGenerator
from dl_speech_enhancement_tpu.parallel import time_shard as jts
from dl_speech_enhancement_tpu.train import optim as joptim
from dl_speech_enhancement_tpu_torch.models import AudioDecGenerator
from dl_speech_enhancement_tpu_torch.parallel.time_shard import (
    blocked_reference_step,
    decoder_receptive_frames,
)
from dl_speech_enhancement_tpu_torch.train import optim
from dl_speech_enhancement_tpu_torch.utils.jax_params import from_jax_params, vq_state_from_jax
from test_torch_port_hifigan import seeded_init
from test_torch_port_train import MEL_TINY, SMALL
from torch_port_ranks import ADAM, run_ranks
from torch_port_threads import one_thread  # noqa: F401

CONFIG = dict(mel_loss_params=MEL_TINY, lambda_mel_loss=45.0, lambda_snr_loss=1.0,
              lambda_vq_loss=1.0)
SHARDS = 2
CLIP_ADAM = dict(ADAM, grad_norm=10.0)
SGD_LR = 1e-2


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_gen(use_pqc, seed):
    gen = JaxGenerator(**SMALL, use_pqc=use_pqc)
    params, vq = seeded_init(gen, seed)
    return gen, _np(params), (_np(vq) if use_pqc else None)


def _frames(gen):
    return max(-(-gen.receptive_length // gen.hop), decoder_receptive_frames(gen.decoder))


def _clip(rng, gen, frames, batch=2, shards=SHARDS):
    x = (0.3 * rng.standard_normal((batch, shards * frames * gen.hop, 1))).astype(np.float32)
    return x, x + (0.05 * rng.standard_normal(x.shape)).astype(np.float32)


def _port_gen(params, use_pqc):
    return from_jax_params(AudioDecGenerator(**SMALL, use_pqc=use_pqc, device="cpu"), params)


def _port_vq(vq):
    return None if vq is None else vq_state_from_jax(vq)


@pytest.fixture(scope="module")
def cases():
    rng = np.random.default_rng(0)
    out = {}
    for use_pqc in (False, True):
        gen, params, vq = _jax_gen(use_pqc, 10 + use_pqc)
        base = {"gen_kw": SMALL, "gen_params": params, "vq": vq, "use_pqc": use_pqc}
        x, _ = _clip(rng, gen, 3 * _frames(gen) + 8)
        out[f"forward{int(use_pqc)}"] = ("time_forward", dict(base, shape=(SHARDS,), x=x), gen)
        clips = [_clip(rng, gen, _frames(gen) + 6) for _ in range(3)]
        out[f"train{int(use_pqc)}"] = ("time_train", dict(
            base, shape=(SHARDS,), config=CONFIG, clips=clips, opt=dict(CLIP_ADAM, kind="adam"),
            too_short=(0.3 * rng.standard_normal((1, SHARDS * 8 * gen.hop, 1))).astype(
                np.float32)), gen)
    gen, params, _ = _jax_gen(False, 12)
    out["sgd"] = ("time_train", {"gen_kw": SMALL, "gen_params": params, "vq": None,
                                 "use_pqc": False, "shape": (SHARDS,), "config": CONFIG,
                                 "clips": [_clip(rng, gen, _frames(gen) + 6)],
                                 "opt": {"kind": "sgd", "lr": SGD_LR}}, gen)
    gen, params, vq = _jax_gen(True, 13)
    out["2d"] = ("time_train", {"gen_kw": SMALL, "gen_params": params, "vq": vq,
                                "use_pqc": True, "shape": (2, SHARDS), "config": CONFIG,
                                "clips": [_clip(rng, gen, _frames(gen) + 6, batch=4)],
                                "opt": dict(CLIP_ADAM, kind="adam")}, gen)
    return out


@pytest.fixture(scope="module")
def ranks(cases, tmp_path_factory):
    """Rank 0's results: the 1-D cases on 2 ranks, the 2-D case on 4."""
    one_d = {k: (name, kw) for k, (name, kw, _) in cases.items() if k != "2d"}
    got = run_ranks(SHARDS, one_d, tmp_path_factory.mktemp("rendezvous1"))
    name, kw, _ = cases["2d"]
    got2 = run_ranks(4, {"2d": (name, kw)}, tmp_path_factory.mktemp("rendezvous2"))
    for r in got2[1:]:  # every rank of the mesh ends with the same state
        for a, b in zip(r["2d"]["params"], got2[0]["2d"]["params"]):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    return got, got2[0]["2d"]


def _jax_mesh(shape):
    if len(shape) == 1:
        return Mesh(np.asarray(jax.devices()[:shape[0]]), ("time",))
    return Mesh(np.asarray(jax.devices()[:4]).reshape(shape), ("data", "time"))


def _jax_put(mesh, x):
    spec = P(None, "time") if "data" not in mesh.axis_names else P("data", "time")
    return jax.device_put(jnp.asarray(x), NamedSharding(mesh, spec))


def _state_np(module):
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


@pytest.mark.parametrize("use_pqc", [False, True], ids=["plain", "pqc"])
def test_forward_matches_offline_beyond_warmup(cases, ranks, use_pqc):
    """Each rank's block of the sharded forward: the offline forward beyond
    the stream-start warm-up, and JAX's sharded forward everywhere."""
    _, kw, jgen = cases[f"forward{int(use_pqc)}"]
    got = np.concatenate([r[f"forward{int(use_pqc)}"] for r in ranks[0]], axis=1)
    gen = _port_gen(kw["gen_params"], use_pqc)
    with torch.no_grad():
        full = gen(torch.from_numpy(kw["x"]), _port_vq(kw["vq"]), train=False)[0].numpy()
    he_frames = -(-gen.receptive_length // gen.hop)
    warm = (he_frames + 2 * decoder_receptive_frames(gen.decoder)) * gen.hop
    assert warm < kw["x"].shape[1] // 2, "test clip too short for the warm bound"
    assert got.shape == full.shape
    np.testing.assert_allclose(got[:, warm:], full[:, warm:], atol=2e-5, rtol=1e-4)
    mesh = _jax_mesh((SHARDS,))
    ref = jts.time_sharded_forward(jgen, mesh)(kw["gen_params"], kw["vq"],
                                               _jax_put(mesh, kw["x"]))
    np.testing.assert_allclose(got, np.asarray(ref), atol=2e-5, rtol=1e-4)


def _blocked(kw, opt_kind, lr=None):
    gen = _port_gen(kw["gen_params"], kw["use_pqc"])
    opt = (torch.optim.SGD(gen.parameters(), lr=lr) if opt_kind == "sgd"
           else optim.build_optimizer(gen.parameters(), "Adam", ADAM,
                                      grad_norm=CLIP_ADAM["grad_norm"]))
    return gen, blocked_reference_step(gen, CONFIG, opt, kw["shape"][-1])


def _jax_steps(jgen, kw, shape, opt):
    mesh = _jax_mesh(shape)
    batch_axis = "data" if len(shape) == 2 else None
    steps = jts.make_time_sharded_steps(jgen, CONFIG, opt, mesh, batch_axis=batch_axis)
    state = {"params_generator": kw["gen_params"], "opt_generator": opt.init(kw["gen_params"])}
    if kw["use_pqc"]:
        state["vq_state"] = kw["vq"]
    return mesh, steps, jax.tree_util.tree_map(jnp.array, state)


@pytest.mark.parametrize("use_pqc", [False, True], ids=["plain", "pqc"])
def test_train_step_matches_blocked_reference_and_jax(cases, ranks, use_pqc):
    """Three steps on 2 time shards (Adam, clip 10): the loss of each equals
    the blocked objective's in one process and JAX's sharded step's; after
    the first, the parameters equal the blocked step's, and (PQC) the EMA
    codebooks both."""
    _, kw, jgen = cases[f"train{int(use_pqc)}"]
    got = ranks[0][0][f"train{int(use_pqc)}"]
    gen, step = _blocked(kw, "adam")
    mesh, jsteps, jstate = _jax_steps(jgen, kw, (SHARDS,), joptim.build_optimizer(
        "Adam", ADAM, grad_norm=CLIP_ADAM["grad_norm"]))
    vq = _port_vq(kw["vq"])
    for i, (x, t) in enumerate(kw["clips"]):
        vq, loss = step(vq, torch.from_numpy(x), torch.from_numpy(t))
        jstate, jloss, jfr = jsteps["train"](jstate, _jax_put(mesh, x), _jax_put(mesh, t))
        np.testing.assert_allclose(got["losses"][i], float(loss), rtol=1e-4)
        np.testing.assert_allclose(got["losses"][i], float(jloss), rtol=1e-4)
        assert sorted(got["frags"][i]) == sorted(jfr)
        assert np.isfinite(got["frags"][i]["mel_loss"])
        if i == 0:
            for k, ref in _state_np(gen).items():
                np.testing.assert_allclose(got["params"][0][k], ref, atol=1e-5, err_msg=k)
            if use_pqc:
                for field in ("embed", "cluster_size"):
                    np.testing.assert_allclose(got["vq"][0][field],
                                               getattr(vq, field).numpy(), atol=1e-5)
                    np.testing.assert_allclose(got["vq"][0][field],
                                               np.asarray(getattr(jstate["vq_state"], field)),
                                               atol=1e-5)
    # eval: the same objective without an EMA step, as JAX's
    x, t = kw["clips"][-1]
    assert np.isfinite(got["eval"])
    np.testing.assert_allclose(got["eval"], float(jsteps["eval"](
        jstate, _jax_put(mesh, x), _jax_put(mesh, t))), rtol=1e-4)


def test_shard_too_short_raises(ranks):
    for r in ranks[0]:
        for use_pqc in (0, 1):
            assert "shorter than the halo" in r[f"train{use_pqc}"]["too_short"]


def test_train_step_gradients_exact_under_sgd(cases, ranks):
    """Plain SGD, which Adam and the clip hide a uniform gradient scale
    from: the sharded update equals the blocked one's and JAX's, so the
    gradient is not off by the number of ranks."""
    _, kw, jgen = cases["sgd"]
    got = ranks[0][0]["sgd"]
    x, t = kw["clips"][0]
    gen, step = _blocked(kw, "sgd", SGD_LR)
    _, loss = step(None, torch.from_numpy(x), torch.from_numpy(t))
    mesh, jsteps, jstate = _jax_steps(jgen, kw, (SHARDS,), optax.sgd(SGD_LR))
    jstate, jloss, _ = jsteps["train"](jstate, _jax_put(mesh, x), _jax_put(mesh, t))
    np.testing.assert_allclose(got["losses"][0], float(loss), rtol=1e-5)
    np.testing.assert_allclose(got["losses"][0], float(jloss), rtol=1e-5)
    jax_ref = _state_np(_port_gen(_np(jstate["params_generator"]), False))
    for k, ref in _state_np(gen).items():
        np.testing.assert_allclose(got["params"][0][k], ref, atol=1e-6, rtol=1e-4, err_msg=k)
        np.testing.assert_allclose(got["params"][0][k], jax_ref[k], atol=1e-6, rtol=1e-4,
                                   err_msg=k)


def test_2d_mesh_data_and_time(cases, ranks):
    """The (data 2, time 2) layout: batch and time sharded at once, the
    same step as the blocked objective in one process and as JAX's on its
    2 x 2 mesh."""
    _, kw, jgen = cases["2d"]
    got = ranks[1]
    x, t = kw["clips"][0]
    gen, step = _blocked(kw, "adam")
    vq, loss = step(_port_vq(kw["vq"]), torch.from_numpy(x), torch.from_numpy(t))
    mesh, jsteps, jstate = _jax_steps(jgen, kw, (2, SHARDS), joptim.build_optimizer(
        "Adam", ADAM, grad_norm=CLIP_ADAM["grad_norm"]))
    jstate, jloss, _ = jsteps["train"](jstate, _jax_put(mesh, x), _jax_put(mesh, t))
    np.testing.assert_allclose(got["losses"][0], float(loss), rtol=2e-5)
    np.testing.assert_allclose(got["losses"][0], float(jloss), rtol=2e-5)
    for k, ref in _state_np(gen).items():
        np.testing.assert_allclose(got["params"][0][k], ref, atol=3e-5, rtol=1e-3, err_msg=k)
    np.testing.assert_allclose(got["vq"][0]["embed"], vq.embed.numpy(), atol=1e-5)
    np.testing.assert_allclose(got["vq"][0]["embed"], np.asarray(jstate["vq_state"].embed),
                               atol=1e-5)
