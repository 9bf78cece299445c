"""The fixed yardstick and the trace reduction, against hand counts."""

import json

import pytest
import torch

from port_bench import flops, readers, trace, weights
from port_bench.reference import course
from port_bench.tests.conftest import ROOT, tiny_configs


def denoiser_params():
    return json.loads((ROOT / "port_bench/configs/audiodec_denoise_48k.json").read_text())


def test_chain_flops_counts_the_halo_rows():
    # units of dilation 1, 3, 9 and kernel 7: unit 0 also computes the 6 * (3 + 9)
    # rows the later units reach back to, unit 1 the 6 * 9 rows of unit 2
    c, rows = 32, 1200
    per_row = 2 * (7 + 1) * c * c
    assert flops.chain_flops(c, rows) == per_row * ((rows + 72) + (rows + 54) + rows)
    assert flops.chain_model_flops(c, rows) == per_row * 3 * rows


def test_input_conv_site_by_hand():
    gp = denoiser_params()["generator_params"]
    kernel, site, ops, nbytes = flops.encoder_sites(gp, 1200, 2)[0]
    assert (kernel, site) == ("causal_conv", "enc_in")
    assert ops == 2 * 2 * 1200 * 7 * 1 * 32
    # cache (2, 6, 1) + x (2, 1200, 1) + w (32, 1, 7) + out (2, 1200, 32), f32
    assert nbytes == 4 * (2 * 6 + 2 * 1200 + 32 * 7 + 2 * 1200 * 32)


def test_denoiser_model_flops_per_stream_frame():
    gp = denoiser_params()["generator_params"]
    # the encoder and the decoder mirror each other; each adds 326,251,520
    # (input conv 537,600; per block 48 T c^2 of chains and 8 T c^2 of stride)
    enc = 537_600 + sum(56 * t * c * c for t, c in ((1200, 32), (400, 64), (100, 128), (20, 256)))
    assert flops.audiodec_model_flops(gp, 1200) == pytest.approx(2 * enc)
    assert flops.audiodec_model_flops(gp, 1200) == 652_503_040


def test_bound_takes_the_larger_side():
    assert flops.bound_s(989e12, 0) == pytest.approx(1.0)
    assert flops.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert flops.bound_s(989e9, 3.35e12) == pytest.approx(1.0)


def test_roofline_reads_the_bound_over_the_kernel_time():
    sites = [("residual_chain", "a", 989e9, 0.0), ("residual_chain", "b", 0.0, 3.35e9),
             ("causal_conv", "c", 989e12, 0.0)]
    record = {"kind": "serve", "sites": sites, "traced_calls": 10,
              "trace": {"kernel_s": {"void residual_chain_kernel<8, float>": 0.5,
                                     "void causal_conv_kernel_gemm<2>": 1.0}}}
    # bound 2 ms a dispatch, 10 dispatches, 0.5 s of kernel time
    assert readers.roofline(record, "serve", "residual_chain") == pytest.approx(4.0)
    assert readers.roofline(record, "serve", "hifigan_unit") is None
    assert readers.roofline(record, "train", "residual_chain") is None


def test_discriminator_flops_equal_a_count_of_every_conv(monkeypatch):
    dp = tiny_configs()["tiny_denoise"]["course"]["discriminator_params"]
    state = weights.discriminator_state(dp, 1, "cpu")
    counted = []
    conv1d, conv2d = course.F.conv1d, course.F.conv2d

    def c1(x, w, *a, **k):
        y = conv1d(x, w, *a, **k)
        counted.append(2.0 * y.numel() * w.shape[1] * w.shape[2])
        return y

    def c2(x, w, *a, **k):
        y = conv2d(x, w, *a, **k)
        counted.append(2.0 * y.numel() * w.shape[1] * w.shape[2] * w.shape[3])
        return y

    monkeypatch.setattr(course.F, "conv1d", c1)
    monkeypatch.setattr(course.F, "conv2d", c2)
    for length in (4800, 4801, 4807):
        counted.clear()
        with torch.no_grad():
            course.discriminate(state, dp, torch.randn(1, 1, length))
        assert sum(counted) == flops.discriminator_forward_flops(dp, length)


def test_idle_share_of_overlapping_kernels():
    events = [("span", "enqueue", 0.0, 40.0), ("span", "sync", 40.0, 100.0),
              ("device", "k1", 10.0, 30.0), ("device", "k2", 20.0, 50.0),  # overlap: 10-50
              ("device", "k3", 60.0, 70.0), ("device", "before", -20.0, 5.0)]  # clipped: 0-5
    reduced = trace.reduce_trace(events)
    assert reduced["window_s"] == pytest.approx(100e-6)
    assert reduced["busy_s"] == pytest.approx(55e-6)
    # 55 us busy in the traced window of 100 us
    record = {"kind": "serve", "trace": reduced, "traced_calls": 2, "calls": 10,
              "window_s": 400e-6}
    assert readers.idle_share(record, "serve") == pytest.approx(45.0)
    assert readers.idle_share(record, "train") is None
    assert reduced["kernel_s"]["k2"] == pytest.approx(30e-6)
    gaps = dict((round(s * 1e6), n) for n, s in reduced["idle_gaps"])
    assert gaps == {30: "sync", 10: "sync", 5: "enqueue"}


def test_a_trace_with_no_device_time_reads_nothing():
    reduced = trace.reduce_trace([("span", "step", 0.0, 10.0)])
    assert reduced["busy_s"] == 0.0
    assert readers.idle_share({"kind": "train", "trace": reduced, "calls": 3, "traced_calls": 1,
                               "window_s": 1.0}, "train") is None
    assert trace.reduce_trace([("device", "k", 0.0, 1.0)]) == {}
