"""Rank workers of the port's data- and sequence-parallel CPU tests.

The ranks are spawned processes, so this module imports torch and the port
only, never JAX. A test module builds its cases' inputs (JAX params as numpy
trees, configs, numpy batches), runs them all in one launch of gloo ranks on
the host (:func:`run_ranks`, a ``file://`` rendezvous under the test's
temporary directory, so xdist workers never race for a port), and holds each
rank's results against the JAX package and against the same case run in the
test's own process (:func:`run_here`: no process group, the one-process
path). Each case returns numpy values; a rank on the host runs torch on one
thread. The card tests run the same cases on cards (``devices``), their
networks seeded in the port where no JAX params are given.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from dl_speech_enhancement_tpu_torch.models import (
    AudioDecGenerator,
    HiFiGANDiscriminator,
    HiFiGANGenerator,
)
from dl_speech_enhancement_tpu_torch.nn.conv import ConvTranspose1d
from dl_speech_enhancement_tpu_torch.nn.vq import ResidualVQ, VectorQuantizeEMA, VQState
from dl_speech_enhancement_tpu_torch.ops.mel_kernel import log_mel, stft_magnitude
from dl_speech_enhancement_tpu_torch.parallel.mesh import (
    device_mesh,
    launch,
    mesh_from_config,
    shard_batch,
)
from dl_speech_enhancement_tpu_torch.parallel.time_shard import (
    local_shard,
    make_time_sharded_steps,
    time_sharded_forward,
)
from dl_speech_enhancement_tpu_torch.train import optim
from dl_speech_enhancement_tpu_torch.train.denoise_course import (
    make_course_steps,
    train_denoise_course,
)
from dl_speech_enhancement_tpu_torch.train.workloads import autoencoder, denoise, statistic
from dl_speech_enhancement_tpu_torch.train.workloads import vocoder
from dl_speech_enhancement_tpu_torch.utils.collectives import pmean_values
from dl_speech_enhancement_tpu_torch.utils.model_factory import build_discriminator
from dl_speech_enhancement_tpu_torch.utils.jax_params import (
    discriminator_from_jax_params,
    from_jax_params,
    vocoder_from_jax_params,
    vq_state_from_jax,
)

TIMEOUT = datetime.timedelta(seconds=120)
ADAM = {"lr": 1e-3, "betas": [0.5, 0.9]}


_PLACE = {"device": torch.device("cpu")}


def run_ranks(world: int, cases: dict, tmp_path, devices=None) -> list[dict]:
    """Every case of ``cases`` (key -> (case name, kwargs)) on ``world`` ranks
    (on the host, or on ``devices``), in order; each rank's ``{key: result}``."""
    return launch(_worker, devices or ["cpu"] * world, cases,
                  init_method=f"file://{os.path.join(str(tmp_path), 'rendezvous')}",
                  timeout=TIMEOUT)


def run_here(name: str, device="cpu", **kwargs):
    """Case ``name`` in this process on ``device``, outside any process group."""
    _PLACE["device"] = torch.device(device)
    return CASES[name](**kwargs)


def _worker(device, cases):
    _PLACE["device"] = device
    if device.type == "cpu":
        torch.set_num_threads(1)
    else:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
    return {key: CASES[name](**kwargs) for key, (name, kwargs) in cases.items()}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a)).to(_PLACE["device"])


def _launches() -> dict:
    return {"log_mel": log_mel.launches, "stft_magnitude": stft_magnitude.launches}


def _since(before: dict) -> dict:
    return {k: v - before[k] for k, v in _launches().items()}


def _mesh():
    """The data mesh over the launched ranks, None in one process."""
    return mesh_from_config({"parallel": {"data_devices": -1}}) if dist.is_initialized() else None


def _group(mesh):
    return None if mesh is None else mesh.get_group("data")


def _np(module) -> dict:
    return {k: v.detach().cpu().numpy().copy() for k, v in module.state_dict().items()}


def _vq_np(vq) -> dict:
    return {f: getattr(vq, f).cpu().numpy().copy() for f in vq._fields}


def _floats(frags) -> dict:
    return {k: float(v) for k, v in frags.items()}


def _gen(params, gen_kw, use_pqc):
    """The generator carried from JAX params, or seeded in the port (None)."""
    if params is None:
        return AudioDecGenerator(**gen_kw, use_pqc=use_pqc, seed=0, device=_PLACE["device"])
    gen = AudioDecGenerator(**gen_kw, use_pqc=use_pqc, device="cpu")
    return from_jax_params(gen, params).to(_PLACE["device"])


def _disc(params, disc_kw):
    if params is None:
        return build_discriminator("symAudioDec", disc_kw, device=_PLACE["device"], seed=1)
    disc = HiFiGANDiscriminator(**disc_kw, device="cpu")
    return discriminator_from_jax_params(disc, params).to(_PLACE["device"])


def _vq(vq):
    return VQState(*(t.to(_PLACE["device"])
                     for t in vq_state_from_jax(VQState(*(np.asarray(t) for t in vq)))))


def held_by_gradient(got: dict, ref: dict, grads: dict, atol: float, lr: float = ADAM["lr"]):
    """Parameters after an Adam step against a reference's: ``atol`` where
    the reference's gradient is above 1e-4 of its tensor's largest, within
    2 lr elsewhere (Adam's first step is about lr * g / (|g| + eps), so a
    gradient at f32's rounding floor, which two summation orders may give
    either sign, moves by lr either way)."""
    for k, g in grads.items():
        diff = np.abs(got[k] - ref[k])
        assert diff.max() <= 2 * lr * (1 + 1e-3), k
        big = np.abs(g) > 1e-4 * np.abs(g).max()
        np.testing.assert_allclose(got[k][big], ref[k][big], atol=atol, rtol=0, err_msg=k)


# ---------------------------------------------------------------- data parallel


def course_step(gen_kw, gen_params, disc_kw, disc_params, config, mixed, clean, arm):
    """One course ``arm`` step (``train`` / ``train_disc``) on the rank's rows
    of (mixed, clean)."""
    mesh = _mesh()
    gen = _gen(gen_params, gen_kw, False)
    disc = _disc(disc_params, disc_kw)
    opt_g = optim.build_optimizer(gen.parameters(), "Adam", ADAM,
                                  grad_norm=config.get("generator_grad_norm", -1))
    opt_d = optim.build_optimizer(disc.parameters(), "Adam", ADAM)
    steps = make_course_steps(gen, disc, config, opt_g, opt_d, _group(mesh))
    x, t = shard_batch(mesh, (mixed, clean), int(config.get("grad_accum", 1)))
    before = _launches()
    g, d, frags, stats = steps[arm](_t(x), _t(t))
    return {"g": float(g), "d": float(d), "frags": _floats(frags), "stats": _floats(stats),
            "gen": _np(gen), "disc": _np(disc), "launches": _since(before),
            "grads": {n: p.grad.cpu().numpy().copy() for n, p in gen.named_parameters()}}


def autoencoder_stage1(gen_kw, gen_params, vq, disc_kw, disc_params, config, x):
    """The codec's ``gen_stage1`` step (EMA codebooks, perplexity) on the
    rank's rows of ``x``."""
    mesh = _mesh()
    gen = _gen(gen_params, gen_kw, True)
    disc = _disc(disc_params, disc_kw)
    opt_g = optim.build_optimizer(gen.parameters(), "Adam", ADAM)
    opt_d = optim.build_optimizer(disc.parameters(), "Adam", ADAM)
    steps = autoencoder.make_autoencoder_steps(gen, disc, config, opt_g, opt_d, _group(mesh))
    before = _launches()
    new_vq, frags, ppl = steps["gen_stage1"](_vq(vq), _t(shard_batch(mesh, x)))
    return {"frags": _floats(pmean_values(frags, _group(mesh))), "ppl": ppl.cpu().numpy(),
            "vq": _vq_np(new_vq), "gen": _np(gen), "launches": _since(before)}


@torch.no_grad()
def _unit_gains(voc, seed: int = 3):
    """``voc`` with every weight-norm gain at its conv's unit gain times
    U(0.8, 1.25), seeded (chip_smoke.py::build_vocoder's rule): at the
    official init the output is almost all bias, where the spectral losses'
    gradients are ill-conditioned."""
    rng = np.random.default_rng(seed)
    for m in voc.modules():
        if getattr(m, "weight_norm", False):
            gain = 0.5 if m is voc.output_conv else 1.0
            if isinstance(m, ConvTranspose1d):
                gain = (m.kernel_size * m.out_channels / (2.0 * m.in_channels)) ** 0.5
            m.g.copy_(torch.from_numpy(gain * rng.uniform(0.8, 1.25, tuple(m.g.shape))))
    return voc


def vocoder_step(an_kw, an_params, vq, voc_kw, voc_params, disc_kw, disc_params, config, x):
    """The vocoder workload's ``gen`` step (spectral convergence, K7's loss)
    on the rank's rows of ``x``."""
    mesh = _mesh()
    analyzer = _gen(an_params, an_kw, True)
    analyzer.requires_grad_(False)
    voc = (_unit_gains(HiFiGANGenerator(**voc_kw, seed=2, device=_PLACE["device"]))
           if voc_params is None
           else vocoder_from_jax_params(HiFiGANGenerator(**voc_kw, device="cpu"),
                                        voc_params).to(_PLACE["device"]))
    disc = _disc(disc_params, disc_kw)
    opt_g = optim.build_optimizer(voc.parameters(), "Adam", ADAM)
    opt_d = optim.build_optimizer(disc.parameters(), "Adam", ADAM)
    steps = vocoder.make_vocoder_steps(analyzer, _vq(vq), voc, disc, config, opt_g, opt_d,
                                       _group(mesh))
    before = _launches()
    frags = steps["gen"](_t(shard_batch(mesh, x)))
    return {"frags": _floats(pmean_values(frags, _group(mesh))), "voc": _np(voc),
            "grads": {n: p.grad.cpu().numpy().copy() for n, p in voc.named_parameters()},
            "launches": _since(before)}


def statistics(an_kw, an_params, vq, clips):
    """The statistic workload's [mean; scale], the clips dealt out over the
    ranks."""
    analyzer = _gen(an_params, an_kw, True)
    return statistic.compute_statistics(analyzer, _vq(vq), clips, group=_group(_mesh()))


def ae_trainer(gen_kw, gen_params, vq, disc_kw, disc_params, config, batches, outdir):
    """The codec's ``TrainerGAN`` through ``run()`` over ``batches``; its
    averaged running losses, state, and a checkpoint written under
    ``outdir``."""
    if dist.is_initialized():
        config = dict(config, parallel={"data_devices": -1})
    tr = autoencoder.Trainer(0, 0, {"train": batches}, _gen(gen_params, gen_kw, True),
                             _disc(disc_params, disc_kw), config, vq_state=_vq(vq))
    tr.run()
    losses = tr._read(tr.total_train_loss, 1)
    tr.save_checkpoint(os.path.join(outdir, f"checkpoint-{tr.steps}steps"))
    return {"steps": tr.steps, "losses": losses, "gen": _np(tr.gen), "disc": _np(tr.disc),
            "vq": _vq_np(tr.vq_state), "loader_wait": tr.loader_wait}


def denoise_indivisible(gen_kw, gen_params, vq, config, batches):
    """The denoise trainer on batches the ranks do not divide: the error."""
    config = dict(config, parallel={"data_devices": -1})
    tr = denoise.Trainer(0, 0, {"train": batches}, _gen(gen_params, gen_kw, True), config,
                         vq_state=_vq(vq))
    try:
        tr.run()
    except ValueError as e:
        return str(e)
    return None


def course_loop(gen_kw, gen_params, disc_kw, disc_params, config, train, val):
    """``train_denoise_course`` over LAPTOP epochs; its history and the
    generator's state (``config['parallel']`` ranks in a process group)."""
    gen = _gen(gen_params, gen_kw, False)
    state, history = train_denoise_course(config, gen, _disc(disc_params, disc_kw), train, val,
                                          environment="LAPTOP")
    return {"steps": state["steps"], "history": history, "gen": _np(gen)}


def vq_update(kind, dim, layers, book, state, x):
    """One EMA step of a ``VectorQuantizeEMA`` (``kind='single'``) or a
    ``ResidualVQ`` on the rank's rows of ``x`` with ``axis_name`` the data
    group."""
    mesh = _mesh()
    vq = VectorQuantizeEMA(dim, book) if kind == "single" else ResidualVQ(dim, layers, book)
    state = VQState(*(torch.from_numpy(np.array(t)) for t in state))
    _, new, loss, ppl = vq(state, _t(shard_batch(mesh, x)), train=True,
                           axis_name=_group(mesh))
    return {"vq": _vq_np(new), "loss": np.asarray(loss), "ppl": np.asarray(ppl)}


# ---------------------------------------------------------------- time shards


def _time_mesh(shape):
    names = ("time",) if len(shape) == 1 else ("data", "time")
    return device_mesh(shape, names)


def time_forward(gen_kw, gen_params, vq, use_pqc, shape, x):
    """``time_sharded_forward`` on the rank's block; returns the block."""
    mesh = _time_mesh(shape)
    batch_axis = "data" if len(shape) == 2 else None
    gen = _gen(gen_params, gen_kw, use_pqc)
    fwd = time_sharded_forward(gen, mesh, batch_axis=batch_axis)
    block = _t(local_shard(mesh, x, batch_axis=batch_axis))
    return fwd(_vq(vq) if use_pqc else None, block).cpu().numpy()


def time_train(gen_kw, gen_params, vq, use_pqc, shape, config, clips, opt, too_short=None):
    """The time-sharded train step over ``clips`` ((x, target) pairs), then
    ``eval`` on the last; with ``too_short`` (a clip) the error its shards
    raise."""
    mesh = _time_mesh(shape)
    batch_axis = "data" if len(shape) == 2 else None
    gen = _gen(gen_params, gen_kw, use_pqc)
    optimizer = (torch.optim.SGD(gen.parameters(), lr=opt["lr"]) if opt["kind"] == "sgd"
                 else optim.build_optimizer(gen.parameters(), "Adam", ADAM,
                                            grad_norm=opt.get("grad_norm", -1)))
    steps = make_time_sharded_steps(gen, config, optimizer, mesh, batch_axis=batch_axis)
    state = _vq(vq) if use_pqc else None
    losses, frags, params, books, grads = [], [], [], [], []
    before = _launches()
    for x, t in clips:
        state, loss, fr = steps["train"](state, *(
            _t(local_shard(mesh, a, batch_axis=batch_axis)) for a in (x, t)))
        losses.append(float(loss))
        frags.append(_floats(fr))
        params.append(_np(gen))
        books.append(_vq_np(state) if use_pqc else None)
        grads.append({n: p.grad.cpu().numpy().copy() for n, p in gen.named_parameters()})
    launched = _since(before)
    x, t = (_t(local_shard(mesh, a, batch_axis=batch_axis)) for a in clips[-1])
    out = {"losses": losses, "frags": frags, "params": params, "vq": books, "grads": grads,
           "launches": launched,
           "eval": float(steps["eval"](state, x, t))}
    if too_short is not None:
        try:
            steps["train"](state, *(_t(local_shard(mesh, too_short)) for _ in range(2)))
        except ValueError as e:
            out["too_short"] = str(e)
    return out


CASES = {f.__name__: f for f in (course_step, autoencoder_stage1, vocoder_step, statistics,
                                 ae_trainer, denoise_indivisible, course_loop, vq_update,
                                 time_forward,
                                 time_train)}
