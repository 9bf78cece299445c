"""roofline.hifigan_unit (%, device_trace): the HiFiGAN unit kernel's launches
against their bound at the fixed peaks (port_bench/flops.py)."""

from port_bench.readers import roofline


def read(record):
    return roofline(record, "serve", "hifigan_unit")
