"""The course trainer's adversarial step, closed loop: one step after
another on batches already on the card.

``train/denoise_course.py::make_course_steps(...)["train_disc"]`` of the
configuration's ``course`` settings (the without-PQC denoiser, its MSD + MPD
discriminator, the mel, SNR, waveform, adversarial and feature-matching
losses, two Adams), f32, TF32 off. Each step ends in a synchronize; the
window's wall time over its steps is ``train_step_ms``.

Traffic keys: ``driver`` ("train"), ``batch``, ``samples``, ``batches`` (the
seeded noisy-speech batches the steps rotate through), ``snr_db``,
``checked_steps``, ``trace_seconds``, ``dp`` (1: one process on one card).

Set-up builds the one training object, then drives it through its first
``checked_steps`` steps on batches that all differ, through the window's
own call; those steps are the warm-up, and the window goes on with the same
object. The check (after the window, the program's state freed) runs the
plain reference (reference/course.py) through the same steps from the same
weights and compares: ``loss_gap``, the first step's generator and
discriminator losses, relative to the reference's (the later steps' losses
are reported beside it: Adam's first update moves every element by about
its learning rate whatever the size of its gradient, so elements whose
gradients are at round-off move apart between two sound implementations and
the later losses spread with them); ``grad_gap``, each leaf's first
gradient as its optimizer got it (the program's, worked out from Adam's
first moment after step 1: ``m / (1 - beta1)``), the gap between the two
norms over the larger of the reference leaf's norm and the median leaf's of
its model; ``change_gap``, the same of each leaf's change over the checked
steps, leaving out leaves whose first reference gradient is under a
thousandth of the median leaf's (round-off moves them under Adam).
"""

from __future__ import annotations

import time

import torch

from port_bench import flops, weights
from port_bench.drivers.fleet import SetupStages, sync
from port_bench.trace import profile, profiler_events, reduce_trace, span
from port_bench.traffic import noisy_speech

TINY_GRAD = 1e-3  # of the median leaf's first gradient: a leaf moved by round-off alone


def course_config(config) -> dict:
    return dict(config["course"], generator_params=config["generator_params"])


def leaf_norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.float())) for k, v in tensors.items()}


def leaf_gaps(got: dict, want: dict, keep=None) -> dict:
    """``|got - want| / max(want, median of want)`` of each leaf (``keep``:
    those to hold), each model's median apart."""
    out = {}
    for model in ("gen.", "disc."):
        names = [k for k in want if k.startswith(model) and (keep is None or k in keep)]
        if not names:
            continue
        med = sorted(want[k] for k in names)[len(names) // 2]
        out.update({k: abs(got[k] - want[k]) / max(want[k], med, 1e-30) for k in names})
    return out


def worst(gaps: dict, model: str = "") -> tuple:
    """The largest gap of ``model``'s leaves and its leaf."""
    return max(((v, k) for k, v in gaps.items() if k.startswith(model)), default=(0.0, None))


def build(cfg, seed, device):
    from dl_speech_enhancement_tpu_torch.models import AudioDecGenerator
    from dl_speech_enhancement_tpu_torch.train.denoise_course import make_course_steps
    from dl_speech_enhancement_tpu_torch.train.optim import build_optimizer
    from dl_speech_enhancement_tpu_torch.utils.model_factory import build_discriminator

    gp, dp = cfg["generator_params"], cfg["discriminator_params"]
    gstate = weights.audiodec_state(gp, False, seed, device)
    dstate = weights.discriminator_state(dp, seed + 1, device)
    gen = AudioDecGenerator(**gp, use_pqc=False, device=device)
    gen.load_state_dict(gstate)
    disc = build_discriminator("symAudioDec", dp, device=device)
    disc.load_state_dict(dstate)
    opt_g = build_optimizer(gen.parameters(), "Adam", cfg["generator_optimizer_params"],
                            grad_norm=cfg.get("generator_grad_norm", -1))
    opt_d = build_optimizer(disc.parameters(), "Adam", cfg["discriminator_optimizer_params"],
                            grad_norm=cfg.get("discriminator_grad_norm", -1))
    step = make_course_steps(gen, disc, cfg, opt_g, opt_d)["train_disc"]
    return step, (gen, disc), (opt_g, opt_d), (gstate, dstate)


def first_gradients(models, opts, cfg) -> dict:
    """Each leaf's gradient norm as its optimizer got it in step 1, from
    Adam's first moment: ``m_1 = (1 - beta1) g``."""
    out = {}
    for tag, model, opt, key in (("gen.", models[0], opts[0], "generator"),
                                 ("disc.", models[1], opts[1], "discriminator")):
        beta1 = cfg[f"{key}_optimizer_params"]["betas"][0]
        for name, p in model.named_parameters():
            m = opt.adam.state[p]["exp_avg"]
            out[tag + name] = float(torch.linalg.vector_norm(m)) / (1.0 - beta1)
    return out


def changes(models, states) -> dict:
    out = {}
    for tag, model, state in (("gen.", models[0], states[0]), ("disc.", models[1], states[1])):
        for name, p in model.named_parameters():
            out[tag + name] = float(torch.linalg.vector_norm(p.detach() - state[name]))
    return out


def run(*, config, traffic, seed: int, seconds: float, trace: bool, device, t_start: float,
        tf32: bool = False) -> dict:
    """One run of a training cell; see the module's docstring. ``tf32``
    turns TF32 on for the program (the control)."""
    if traffic.get("dp", 1) != 1:
        raise ValueError("this driver runs one process on one card (dp 1)")
    stages = SetupStages(t_start)
    stages("imports")
    if device.type == "cuda":
        from dl_speech_enhancement_tpu_torch.ops import _cuda
        _cuda.build()
    stages("build")
    cfg = course_config(config)
    b, n = traffic["batch"], traffic["samples"]
    batches = []
    for i in range(traffic["batches"]):
        mixed, clean = noisy_speech(b, n, seed + 10 + i, traffic["snr_db"], config["sample_rate"],
                                    device)
        batches.append((mixed[..., None].contiguous(), clean[..., None].contiguous()))
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    stages("traffic")
    step, models, opts, states = build(cfg, seed, device)
    sync(device)
    stages("model")
    losses, grads = [], None
    for i in range(traffic["checked_steps"]):
        g, d = step(*batches[i % len(batches)])[:2]
        losses.append((float(g), float(d)))
        if i == 0:
            grads = first_gradients(models, opts, cfg)
    moved = changes(models, states)
    setup_s = stages("warmup")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    k = traffic["checked_steps"]
    host_s, steps = 0.0, 0
    w0 = time.perf_counter()
    while time.perf_counter() - w0 < seconds:
        t0 = time.perf_counter()
        step(*batches[k % len(batches)])
        host_s += time.perf_counter() - t0
        sync(device)
        k, steps = k + 1, steps + 1
    window = time.perf_counter() - w0
    out = {"attempted": steps, "failed": 0,
           "e2e": {"train_step_ms": 1e3 * window / steps, "setup_s": setup_s},
           "window": {"calls": steps, "window_s": window, "setup_stages": stages.seconds}}
    if trace:
        k1 = k
        with profile(device) as prof:
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < traffic["trace_seconds"]:
                with span("step", True):
                    step(*batches[k % len(batches)])
                with span("sync", True):
                    sync(device)
                k += 1
        out["window"]["traced_calls"] = k - k1
        out["record"] = {"kind": "train", "calls": steps, "window_s": window,
                         "host_call_s": host_s,
                         "model_flops": steps * flops.course_step_flops(
                             cfg["generator_params"], cfg["discriminator_params"], b, n),
                         "trace": reduce_trace(profiler_events(prof)),
                         "traced_calls": k - k1}
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                if device.type == "cuda" else 0)
    del step, models, opts
    if device.type == "cuda":
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out["checks"], out["window"]["looks"] = check(config, cfg, states, batches, losses, grads,
                                                  moved, device)
    return out


def check(config, cfg, states, batches, losses, grads, moved, device) -> list:
    from port_bench.reference.course import CourseStep

    ref = CourseStep(cfg, states[0], states[1], device)
    start = {k: v.clone() for k, v in ref.leaves().items()}
    ref_losses, ref_grads = [], None
    for i in range(len(losses)):
        pair, g = ref(*batches[i % len(batches)])
        ref_losses.append(pair)
        if i == 0:
            ref_grads = leaf_norms(g)
    after = ref.leaves()
    ref_moved = {k: float(torch.linalg.vector_norm(after[k] - start[k])) for k in after}
    by_step = [[abs(p - r) / max(abs(r), 1e-30) for p, r in zip(got, want)]
               for got, want in zip(losses, ref_losses)]
    keep = set()
    for model in ("gen.", "disc."):
        names = [k for k in ref_grads if k.startswith(model)]
        med = sorted(ref_grads[k] for k in names)[len(names) // 2]
        keep |= {k for k in names if ref_grads[k] >= TINY_GRAD * med}
    grad, change = leaf_gaps(grads, ref_grads), leaf_gaps(moved, ref_moved, keep)
    limits = config["limits"]
    looks = {f"{name}.{m}": worst(gaps, m + ".") for name, gaps in
             (("grad_gap", grad), ("change_gap", change)) for m in ("gen", "disc")}
    looks["loss_gap_by_step"] = by_step
    looks["change_gap.left_out"] = sorted(set(ref_grads) - keep)
    for name, gaps, want in (("grad_gap", grad, ref_grads), ("change_gap", change, ref_moved)):
        leaf = worst(gaps)[1]
        if leaf:
            model = leaf.split(".")[0] + "."
            names = sorted(want[k] for k in gaps if k.startswith(model))
            looks[f"{name}.leaf_norm_over_median"] = want[leaf] / names[len(names) // 2]
    return [("loss_gap", max(by_step[0]), limits["loss_gap"]),
            ("grad_gap", worst(grad)[0], limits["grad_gap"]),
            ("change_gap", worst(change)[0], limits["change_gap"])], looks


def control_arguments() -> dict:
    """The control that the check has to fail: the program with TF32 on."""
    return {"tf32": True}
