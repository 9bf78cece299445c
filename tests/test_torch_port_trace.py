"""The port's spans (utils/trace.py) on the CPU: what a span costs with no
profiler, how the spans of a fleet dispatch and of a course step nest under
a CPU ``torch.profiler``, that the kernel wrappers keep their launch
counters, and the trace readers (``is_device_op``, ``span_table``) on stub
events."""

import inspect
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from conftest import SMALL_TOPOLOGY
from dl_speech_enhancement_tpu_torch.models import AudioDecGenerator, HiFiGANDiscriminator
from dl_speech_enhancement_tpu_torch.models.hifigan import HiFiGANGenerator
from dl_speech_enhancement_tpu_torch.ops import mega_kernel, mel_kernel, stream_kernel
from dl_speech_enhancement_tpu_torch.ops import vocoder_kernel
from dl_speech_enhancement_tpu_torch.ops.mega_kernel import (
    join_halves,
    mega_decoder,
    mega_encoder,
)
from dl_speech_enhancement_tpu_torch.ops.vocoder_kernel import vocoder_half
from dl_speech_enhancement_tpu_torch.tools import reshape_probe
from dl_speech_enhancement_tpu_torch.train import optim
from dl_speech_enhancement_tpu_torch.train.denoise_course import (
    make_course_steps,
    train_denoise_course,
)
from dl_speech_enhancement_tpu_torch.utils import trace
from port_bench.trace import launch_counters
from test_torch_port_train import COURSE_CONFIG, MEL_TINY, TINY_DISC
from torch_port_threads import one_thread  # noqa: F401

PQC_TOPOLOGY = dict(SMALL_TOPOLOGY, codebook_num=3)
VOC_PAIRED = dict(in_channels=16, channels=16, upsample_scales=(4, 3),
                  upsample_kernel_sizes=(8, 6), resblock_kernel_sizes=(3,),
                  resblock_dilations=((1, 2),), groups=2)
COUNTERS = {
    "dl_speech_enhancement_tpu_torch.ops.stream_kernel.residual_chain",
    "dl_speech_enhancement_tpu_torch.ops.mega_kernel.causal_conv",
    "dl_speech_enhancement_tpu_torch.ops.mega_kernel.causal_conv_transpose",
    "dl_speech_enhancement_tpu_torch.ops.mega_kernel.rvq_assign",
    "dl_speech_enhancement_tpu_torch.ops.mega_kernel.codebook_lookup",
    "dl_speech_enhancement_tpu_torch.ops.vocoder_kernel.hifigan_unit",
    "dl_speech_enhancement_tpu_torch.ops.mel_kernel.log_mel",
    "dl_speech_enhancement_tpu_torch.ops.mel_kernel.stft_magnitude",
    "dl_speech_enhancement_tpu_torch.tools.reshape_probe.fold_copy",
}
WRAPPERS = [(stream_kernel, "residual_chain"), (mega_kernel, "causal_conv"),
            (mega_kernel, "causal_conv_transpose"), (mega_kernel, "rvq_assign"),
            (mega_kernel, "codebook_lookup"), (vocoder_kernel, "hifigan_unit"),
            (mel_kernel, "log_mel"), (mel_kernel, "stft_magnitude")]


def _profiled(fn):
    """``fn()``'s result and the ``dse.`` spans of a CPU profile of it, as
    ``[(name, start_us, end_us)]`` on the calling thread."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = sorted((e.time_range.start, -e.time_range.end, e.name) for e in prof.events()
                   if e.name.startswith(trace.PREFIX))
    return out, [(n, a, -b) for a, b, n in spans]


def _parents(spans) -> dict:
    """``{(name, start): innermost enclosing span's name or None}``."""
    out, stack = {}, []
    for name, a, b in spans:
        while stack and stack[-1][2] <= a:
            stack.pop()
        out[(name, a)] = stack[-1][0] if stack else None
        stack.append((name, a, b))
    return out


def _kinds(spans) -> dict:
    counts = {}
    for name, _, _ in spans:
        counts[name] = counts.get(name, 0) + 1
    return counts


# ---------------------------------------------------------------- off


def test_a_span_off_is_the_shared_null_context_and_costs_under_a_microsecond():
    assert not torch.autograd.profiler._is_profiler_enabled
    assert trace.span("dispatch") is trace.NULL
    assert trace.span("half.encoder") is trace.span("launch.causal_conv")
    best = float("inf")
    for _ in range(5):  # the fastest of five rounds: the cost, not the machine's load
        t0 = time.perf_counter()
        for _ in range(200_000):
            with trace.span("launch.residual_chain"):
                pass
        best = min(best, time.perf_counter() - t0)
    assert best * 5 < 1.0, f"10^6 spans off took {best * 5:.3f} s"


def test_a_spanned_function_calls_through_and_opens_its_span_only_under_a_profiler():
    @trace.spanned("launch.probe")
    def probe(x, y=1):
        """Doc."""
        return x + y

    assert probe(1, y=2) == 3 and probe.__name__ == "probe" and probe.__doc__ == "Doc."
    assert probe.__module__ == __name__
    out, spans = _profiled(lambda: probe(4))
    assert out == 5 and [s[0] for s in spans] == ["dse.launch.probe"]


# ---------------------------------------------------------------- serving path


def _denoiser_halves():
    torch.manual_seed(0)
    gen = AudioDecGenerator(use_pqc=False, device="cpu", **SMALL_TOPOLOGY)
    return mega_encoder(gen, torch.float32), mega_decoder(gen, torch.float32), gen.hop


def _codec_receiver_halves():
    torch.manual_seed(1)
    codec = AudioDecGenerator(use_pqc=True, device="cpu", **PQC_TOPOLOGY)
    vq = codec.quantizer.init(seed=2, device="cpu")
    voc = HiFiGANGenerator(**VOC_PAIRED, device="cpu")
    return (mega_encoder(codec, torch.float32, vq), vocoder_half(voc, torch.float32, vq),
            codec.hop)


@pytest.mark.parametrize("halves,receiver,launches", [
    (_denoiser_halves, "decoder",
     {"residual_chain": 4, "causal_conv": 4, "causal_conv_transpose": 2}),
    (_codec_receiver_halves, "receiver",
     {"causal_conv": 8, "residual_chain": 2, "rvq_assign": 1, "codebook_lookup": 1,
      "causal_conv_transpose": 2, "hifigan_unit": 4}),
], ids=["denoiser", "codec_hifigan"])
def test_a_fleet_dispatch_nests_its_halves_and_kernel_wrappers(rng, halves, receiver,
                                                               launches):
    """One dispatch of a tiny CPU fleet (B = 2): ``dse.dispatch`` holds the
    two halves, each half the wrapper spans its topology implies."""
    encoder, decoder, hop = halves()
    assert encoder.name == "encoder" and decoder.name == receiver
    init, run = join_halves(encoder, decoder, 2, "cpu")
    frames = torch.from_numpy(rng.standard_normal((1, 2, 4 * hop)).astype(np.float32))
    cache = init()
    want = run(cache, frames)
    got, spans = _profiled(lambda: run(cache, frames))
    for a, b in zip(want, got):  # spans change nothing the dispatch computes
        if isinstance(a, dict):
            assert all(torch.equal(a[k], b[k]) for k in a)
        else:
            assert torch.equal(a, b)
    parents = _parents(spans)
    assert [n for n, a, _ in spans if parents[(n, a)] is None] == ["dse.dispatch"]
    assert _kinds(spans) == {"dse.dispatch": 1, "dse.half.encoder": 1,
                             f"dse.half.{receiver}": 1,
                             **{f"dse.launch.{k}": v for k, v in launches.items()}}
    for name, a, _ in spans:
        if name.startswith("dse.half."):
            assert parents[(name, a)] == "dse.dispatch"
        elif name.startswith("dse.launch."):
            assert parents[(name, a)] in ("dse.half.encoder", f"dse.half.{receiver}")
    order = [n for n, _, _ in spans if n.startswith("dse.half.")]
    assert order == ["dse.half.encoder", f"dse.half.{receiver}"]


# ---------------------------------------------------------------- training path


def _course():
    torch.manual_seed(3)
    gen = AudioDecGenerator(use_pqc=False, device="cpu", **SMALL_TOPOLOGY)
    disc = HiFiGANDiscriminator(**TINY_DISC, device="cpu")
    return gen, disc


def test_a_course_adversarial_step_has_its_eight_phase_spans():
    gen, disc = _course()
    cfg = dict(mel_loss_params=MEL_TINY, lambda_mel_loss=45.0, lambda_snr_loss=1.0,
               lambda_adv=1.0, lambda_feat_match=2.0)
    opts = [optim.build_optimizer(m.parameters(), "Adam", {"lr": 1e-3, "betas": [0.5, 0.9]})
            for m in (gen, disc)]
    step = make_course_steps(gen, disc, cfg, *opts)["train_disc"]
    g = torch.Generator().manual_seed(4)
    x, t = (0.3 * torch.randn((2, 240, 1), generator=g) for _ in range(2))
    (g_loss, d_loss, _, _), spans = _profiled(lambda: step(x, t))
    assert torch.isfinite(g_loss) and torch.isfinite(d_loss)
    phases = ("forward", "backward", "update")
    assert _kinds(spans) == {f"dse.course.{m}{p}": 1 for m in ("gen", "disc")
                             for p in ("",) + tuple("." + q for q in phases)}
    parents = _parents(spans)
    for name, a, _ in spans:
        model = name.split(".")[2]
        want = None if name.count(".") == 2 else f"dse.course.{model}"
        assert parents[(name, a)] == want, name
    assert [n for n, _, _ in spans] == [
        "dse.course.gen", "dse.course.gen.forward", "dse.course.gen.backward",
        "dse.course.gen.update", "dse.course.disc", "dse.course.disc.forward",
        "dse.course.disc.backward", "dse.course.disc.update"]


def test_the_course_loop_spans_and_logs_its_loader_wait(rng, caplog):
    """LAPTOP mode takes four fetches (the fourth ends the epoch); the log
    line reports the wait's share of the run time."""
    gen, disc = _course()
    clean = [rng.standard_normal((2, 240, 1)).astype(np.float32) * 0.3 for _ in range(4)]
    noise = [rng.standard_normal((2, 240, 1)).astype(np.float32) * 0.3 for _ in range(4)]
    config = dict(COURSE_CONFIG, epochs=1, epoch_to_enable_discriminator=0)
    caplog.set_level("INFO", logger="dl_speech_enhancement_tpu_torch.train.denoise_course")
    (state, _), spans = _profiled(lambda: train_denoise_course(
        config, gen, disc, (clean, noise), (clean[:1], noise[:1]), environment="LAPTOP"))
    assert state["steps"] == 3
    kinds = _kinds(spans)
    assert kinds["dse.course.loader_wait"] == 4 and kinds["dse.course.gen"] == 3
    assert sum("Loader wait:" in r.getMessage() for r in caplog.records) == 3


# ---------------------------------------------------------------- counters


def test_the_launch_counters_are_the_same_nine_on_the_decorated_wrappers():
    assert isinstance(reshape_probe.fold_copy.launches, int)  # the ninth, undecorated
    found = launch_counters()
    assert set(found) == COUNTERS
    for module, name in WRAPPERS:
        fn = getattr(module, name)
        assert fn.__module__ == module.__name__ and fn.__name__ == name
        assert isinstance(fn.launches, int)
        # the wrapper's body counts a launch on its module-level name: the
        # decorated function, which carries the counter
        assert fn.__wrapped__.__globals__[name] is fn
        assert f"{name}.launches += 1" in _source(fn.__wrapped__)
    for fn in (mel_kernel.log_mel, mel_kernel.stft_magnitude):
        assert set(fn.arm_launches) == set(mel_kernel.ARMS)
        assert f"{fn.__name__}.arm_launches[arm] += 1" in _source(fn.__wrapped__)


def _source(fn) -> str:
    return inspect.getsource(fn)


# ---------------------------------------------------------------- readers


def _event(name, device, start, end, *, thread=1, eid=0, annotation=False):
    return SimpleNamespace(name=name, device_type=device, is_user_annotation=annotation,
                           thread=thread, id=eid,
                           time_range=SimpleNamespace(start=start, end=end))


@pytest.mark.parametrize("event,device_op", [
    (_event("void residual_chain_kernel<8>", DeviceType.CUDA, 0, 5), True),
    (_event("Memcpy HtoD (Pinned -> Device)", DeviceType.CUDA, 0, 5), True),
    (_event("enqueue", DeviceType.CUDA, 0, 5, annotation=True), False),
    (_event("aten::cat", DeviceType.CPU, 0, 5), False),
], ids=["kernel", "memcpy", "gpu_user_annotation", "cpu_op"])
def test_is_device_op(event, device_op):
    assert trace.is_device_op(event) is device_op


def test_span_table_counts_self_and_device_time_by_launch():
    """Hand counts (us): a dispatch 0-100 holds a half 10-60, which holds a
    launch 20-30; a backward 100-200 on thread 1 waits while thread 2
    launches at 150. Kernels: k1 (launched at 25, runs 40-50), k2 (launched
    at 55 in the half's self time, runs 50-70, overlapping k1), k3 (launched
    at 150 from thread 2, runs 160-190), k4 (no launch in the trace), and a
    device annotation over 0-200 that no count may take."""
    C, G = DeviceType.CPU, DeviceType.CUDA
    events = [
        _event("dse.dispatch", C, 0, 100), _event("dse.half.encoder", C, 10, 60),
        _event("dse.launch.causal_conv", C, 20, 30),
        _event("dse.course.gen.backward", C, 100, 200),
        _event("aten::cat", C, 54, 58, eid=7),
        _event("cudaLaunchKernel", C, 25, 26, eid=71),
        _event("cudaLaunchKernel", C, 55, 56, eid=72),
        _event("cudaLaunchKernel", C, 150, 151, thread=2, eid=73),
        _event("k1", G, 40, 50, eid=71), _event("k2", G, 50, 70, eid=72),
        _event("k3", G, 160, 190, eid=73), _event("k4", G, 300, 310, eid=74),
        _event("k5", G, 90, 95, eid=7),  # shares a CPU op's id, not a launch's
        _event("enqueue", G, 0, 200, annotation=True, eid=71),
    ]
    table, unlinked = trace.span_table(events)
    assert unlinked == 2
    us = 1e-6
    want = {
        "dse.dispatch": (1, 100 * us, 50 * us, 30 * us),
        "dse.half.encoder": (1, 50 * us, 40 * us, 30 * us),
        "dse.launch.causal_conv": (1, 10 * us, 10 * us, 10 * us),
        "dse.course.gen.backward": (1, 100 * us, 100 * us, 30 * us),
    }
    assert set(table) == set(want)
    for name, (calls, host, self_s, device) in want.items():
        row = table[name]
        assert row["calls"] == calls, name
        assert row["host_s"] == pytest.approx(host), name
        assert row["self_s"] == pytest.approx(self_s), name
        assert row["device_s"] == pytest.approx(device), name


def test_span_table_sums_calls_and_nests_on_each_thread_apart():
    C, G = DeviceType.CPU, DeviceType.CUDA
    events = [_event("dse.dispatch", C, 0, 10), _event("dse.dispatch", C, 20, 30),
              _event("dse.half.encoder", C, 22, 28),
              _event("dse.dispatch", C, 5, 25, thread=2),
              _event("cudaLaunchKernel", C, 23, 24, eid=1), _event("k", G, 40, 41, eid=1)]
    table, unlinked = trace.span_table(events)
    assert unlinked == 0
    assert table["dse.dispatch"]["calls"] == 3
    assert table["dse.dispatch"]["host_s"] == pytest.approx(40e-6)
    assert table["dse.dispatch"]["self_s"] == pytest.approx(34e-6)
    assert table["dse.dispatch"]["device_s"] == pytest.approx(1e-6)
    assert table["dse.half.encoder"]["self_s"] == pytest.approx(6e-6)


def test_span_table_of_a_trace_without_spans_is_empty():
    assert trace.span_table([]) == ({}, 0)
    kernel = _event("k", DeviceType.CUDA, 0, 1, eid=1)
    assert trace.span_table([kernel]) == ({}, 1)
